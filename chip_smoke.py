#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: a CUDA card must be present; prints its name and power limit
   and turns TF32 off for matmul and cuDNN.
2. build: compiles every kernel under ``pytorch_video_action_tpu_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, all started together) and
   prints the build time and ``-Xptxas -v``.
3. kernels: holds each kernel against its plain PyTorch version on the card
   at the bench shape (B=64, T=1024, where bench.py times bigru), for layer
   0 and the later layers in f32 and bf16, and times kernel, plain version
   and a one-call PyTorch yardstick (nn.GRU) with CUDA events.
4. slice: writes a seeded Breakfast-shaped dataset and a full-width bigru
   checkpoint into a temporary directory, repeats phase 3 at the largest
   forward batch the slice gives the kernel, runs the port's inference CLI
   on the card (test CSV and dev accuracy, f32 and bf16), checks the launch
   counts and the CSV, runs the CLI once on the CPU to compare labels, and
   prints the forward's frames/s.

Prints a ``kernels`` JSON line (headline numbers at the main path's shape,
every checked shape under ``shapes``), the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

B_BENCH, T_BENCH = 64, 1024  # the shape bench.py times bigru at
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
KERNEL_SRC = "pytorch_video_action_tpu_torch/csrc/gru_bidir_fwd.cu"
KERNEL_REPLACES = "pytorch_video_action_tpu/ops/rnn_fused_pallas.py:1008"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from pytorch_video_action_tpu_torch.ops import cuda_lib

    t0 = time.time()
    logs = cuda_lib.build_all(ptxas_verbose=True)
    log(f"[build] {len(logs)} source(s) compiled in {time.time() - t0:.1f} s")
    for name, text in logs.items():
        log(f"[build] -Xptxas -v for {name}:")
        log(text.strip())


def layer_inputs(t_len, b, w_in, dt, lengths, gen):
    import torch

    h = 128
    k = 1.0 / h ** 0.5
    shapes = [(w_in, 3 * h)] * 2 + [(3 * h,)] * 2 + [(h, 3 * h)] * 2 + [(3 * h,)] * 2
    ws = [((torch.rand(s, generator=gen) * 2 - 1) * k).to("cuda", dt)
          for s in shapes]
    x = torch.randn(t_len, b, w_in, generator=gen).to("cuda", dt)
    return x, ws, torch.as_tensor(lengths, dtype=torch.int32).cuda()


def cudnn_gru(x, ws, lengths):
    """torch.nn.GRU(bidirectional=True) on a packed sequence with the same
    weights: the one-call yardstick, timed here only."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    w_in, h = x.shape[2], ws[4].shape[0]
    gru = torch.nn.GRU(w_in, h, bidirectional=True)
    wif, wib, bif, bib, whf, whb, bhf, bhb = ws
    with torch.no_grad():
        for sfx, wi, wh, bi, bh in (("", wif, whf, bif, bhf),
                                    ("_reverse", wib, whb, bib, bhb)):
            getattr(gru, "weight_ih_l0" + sfx).copy_(wi.t())
            getattr(gru, "weight_hh_l0" + sfx).copy_(wh.t())
            getattr(gru, "bias_ih_l0" + sfx).copy_(bi)
            getattr(gru, "bias_hh_l0" + sfx).copy_(bh)
    # moving the module lays its weights out as one cuDNN buffer
    gru = gru.to("cuda", x.dtype).eval()
    lengths_cpu = lengths.cpu()

    def run():
        packed = pack_padded_sequence(x, lengths_cpu, enforce_sorted=False)
        return gru(packed)[0]

    return run


def bound(t_len, b, w_in, dt_name):
    """Least time (ms) the card could take for one layer: each input read
    once, each output written once, against the peak rates."""
    h = 128
    size = 4 if dt_name == "float32" else 2
    weights = 2 * (w_in * 3 * h + h * 3 * h + 6 * h)
    n_bytes = (t_len * b * w_in + weights + 2 * t_len * b * h) * size + 4 * b
    flops = 2 * t_len * b * (w_in + h) * 3 * h * 2
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dt_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_layer(where, lengths, t_len, w_in, dt_name, gen):
    """Hold the kernel against its plain version on one input and time the
    kernel, the plain version and the nn.GRU yardstick.  Raises when they
    disagree.  Returns the row for the ``kernels`` line."""
    import torch

    from pytorch_video_action_tpu_torch.ops.rnn_fused import (
        gru_bidir_layer, gru_bidir_layer_ref)

    dt = getattr(torch, dt_name)
    b = len(lengths)
    x, ws, lengths = layer_inputs(t_len, b, w_in, dt, lengths, gen)
    ysf, ysb = gru_bidir_layer(x, *ws, lengths)
    torch.cuda.synchronize()
    rf, rb = gru_bidir_layer_ref(x, *ws, lengths)
    err_f = (ysf.float() - rf.float()).abs().max().item()
    err_b = (ysb.float() - rb.float()).abs().max().item()
    pad = (torch.arange(t_len, device="cuda")[:, None]
           >= lengths[None, :].long())
    pad_b = ysb.float().abs()[pad].max().item() if pad.any() else 0.0
    ms = cuda_ms(lambda: gru_bidir_layer(x, *ws, lengths), 10, 2)
    plain_ms = cuda_ms(lambda: gru_bidir_layer_ref(x, *ws, lengths), 2)
    lib_run = cudnn_gru(x, ws, lengths)
    with torch.no_grad():
        lib_ms = cuda_ms(lib_run, 10, 2)
    bound_ms, bound_by = bound(t_len, b, w_in, dt_name)
    row = {"where": where, "w_in": w_in, "dtype": dt_name, "B": b,
           "T": t_len, "max_abs_err": max(err_f, err_b), "tol": TOL[dt_name],
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"[kernel] gru_bidir_fwd {where} B={b} T={t_len} W_in={w_in} "
        f"{dt_name}: max|ysf-ref|={err_f:.3g} max|ysb-ref|={err_b:.3g} "
        f"(tol {TOL[dt_name]}), max|ysb| on padding={pad_b:.3g}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"nn.GRU packed {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by})")
    if not (err_f <= TOL[dt_name] and err_b <= TOL[dt_name]):
        raise AssertionError(f"kernel disagrees with its plain version: {row}")
    if pad_b != 0.0:
        raise AssertionError("ys_b is not 0 on padded frames")
    return row


def check_layers(where, lengths, t_len, gen):
    """``check_layer`` for layer 0 (W_in=400) and the later layers (256), in
    f32 and bf16."""
    return [check_layer(where, lengths, t_len, w_in, dt_name, gen)
            for w_in in (400, 256) for dt_name in ("float32", "bfloat16")]


def phase_kernels():
    import torch

    gen = torch.Generator().manual_seed(0)
    lengths = torch.randint(1, T_BENCH + 1, (B_BENCH,), generator=gen)
    lengths[0], lengths[1] = 1, T_BENCH
    return check_layers("bench", lengths.tolist(), T_BENCH, gen)


# ------------------------------------------------------------------ slice

N_CLASS = 48


def write_dataset(root: str, seed: int = 0) -> None:
    """Breakfast-shaped tree: 48 classes, 24 dev and 24 test videos of
    500-2500 frames, gz text features, ground truth and segment.txt."""
    rng = np.random.default_rng(seed)
    names = ["SIL"] + [f"action_{i:02d}" for i in range(1, N_CLASS)]
    means = rng.normal(0.0, 1.0, size=(N_CLASS, 400)).astype(np.float32)
    for d in ("splits/splits", "splits/new_splits", "groundTruth/groundTruth",
              "data"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    with open(os.path.join(root, "splits/splits/mapping_bf.txt"), "w") as f:
        f.write("".join(f"{i} {n}\n" for i, n in enumerate(names)))

    def video():
        t_len = int(rng.integers(500, 2501))
        labels = np.zeros(t_len, dtype=np.int64)
        cuts = np.sort(rng.choice(np.arange(50, t_len - 50), 6, replace=False))
        for a, b in zip(cuts[:-1], cuts[1:]):
            labels[a:b] = rng.integers(1, N_CLASS)
        feats = means[labels] + rng.normal(0, 0.5, (t_len, 400))
        return feats.astype(np.float32), labels

    seg_lines = []
    for part, count in (("dev", 24), ("test", 24)):
        files = []
        for i in range(count):
            stem = f"{part[0].upper()}{i:02d}_cam01_{part[0].upper()}{i:02d}_cereals"
            feats, labels = video()
            with gzip.open(os.path.join(root, "data", f"{stem}.gz"), "wb",
                           compresslevel=1) as f:
                np.savetxt(f, feats, fmt="%.4f")
            with open(os.path.join(root, "groundTruth/groundTruth",
                                   f"{stem}.txt"), "w") as f:
                f.write("".join(names[l] + "\n" for l in labels))
            files.append(stem)
            if part == "test":
                active = np.nonzero(labels)[0]
                start, end = int(active[0]), int(active[-1]) + 1
                bounds = [start] + [t for t in range(start + 1, end)
                                    if labels[t] != labels[t - 1]] + [end]
                seg_lines.append(" ".join(map(str, bounds)))
        bundle = ("splits/new_splits/dev.split0.bundle" if part == "dev"
                  else "splits/splits/test.split1.bundle")
        with open(os.path.join(root, bundle), "w") as f:
            f.write("#bundle\n" + "".join(
                f"./data/groundTruth/{s}.txt\n" for s in files))
    with open(os.path.join(root, "segment.txt"), "w") as f:
        f.write("\n".join(seg_lines) + "\n")


def read_csv_labels(path: str) -> list[int]:
    with open(path) as f:
        content = f.read()
    lines = content.split("\n")
    if lines[0] != "Id,Category" or content.endswith("\n"):
        raise AssertionError(f"bad CSV format in {path}")
    out = []
    for i, line in enumerate(lines[1:]):
        idx, label = line.split(",")
        if int(idx) != i:
            raise AssertionError(f"bad CSV row {i}: {line!r}")
        out.append(int(label))
    return out


def phase_slice(card: str):
    import torch

    from pytorch_video_action_tpu_torch.cli import inference_cli
    from pytorch_video_action_tpu_torch.data.bundles import load_segment_file
    from pytorch_video_action_tpu_torch.data.dataset import VideoDataset
    from pytorch_video_action_tpu_torch.infer.loader import load_models
    from pytorch_video_action_tpu_torch.infer.predict import (
        forward_batches, frame_predictions)
    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.models.params import to_jax_params
    from pytorch_video_action_tpu_torch.ops.rnn_fused import gru_bidir_layer
    from pytorch_video_action_tpu_torch.train.checkpoint import save_params

    launches = 0
    with tempfile.TemporaryDirectory() as root, contextlib.chdir(root):
        t0 = time.time()
        write_dataset(root)
        model = build_model("bigru", N_CLASS,
                            generator=torch.Generator().manual_seed(0))
        name = "bigru_00.00_dev"
        save_params(os.path.join(root, "models", f"{name}.npz"),
                    to_jax_params("bigru", model.state_dict()))
        log(f"[slice] dataset and checkpoint written in {time.time() - t0:.1f} s")
        base = ["--pretrained_model", name, "--prob", "big",
                "--data_dir", os.path.join(root, "data"), "--annot_path", root]
        n_segments = sum(len(s) - 1 for s in
                         load_segment_file(os.path.join(root, "segment.txt")))
        datasets = {
            "test": VideoDataset(data_dir="data", annot_path=root, part="test",
                                 split=1, mode=None, verbose=False),
            "dev": VideoDataset(data_dir="data", annot_path=root, part="dev",
                                split=0, mode="active", verbose=False)}

        # the kernel at the largest shape the slice gives it: the forward
        # batch of the test part with the most frames, its own lengths
        feats = datasets["test"].features
        t_pad, chunk = max(forward_batches(feats),
                           key=lambda tb: tb[0] * len(tb[1]))
        rows = check_layers("main path", [len(feats[i]) for i in chunk],
                            t_pad, torch.Generator().manual_seed(1))

        csv = {}
        for dt_name in ("float32", "bfloat16"):
            for part in ("test", "dev"):
                expect = 4 * len(forward_batches(datasets[part].features))
                gru_bidir_layer.launches = 0
                t0 = time.time()
                out = inference_cli.main(base + ["--part", part, "--dtype",
                                                 dt_name, "--device", "cuda"])
                seconds = time.time() - t0
                got = gru_bidir_layer.launches
                launches += got
                log(f"[slice] cuda {dt_name} --part {part}: "
                    f"{'csv ' + out if part == 'test' else f'accuracy {out:.2f}'}"
                    f" in {seconds:.1f} s, gru_bidir_fwd launches {got} "
                    f"(expected {expect} = 4 per forward batch)")
                if got != expect:
                    raise AssertionError("launch count does not match the "
                                         "forward batches")
                if part == "test":
                    labels = read_csv_labels(out)
                    if len(labels) != n_segments:
                        raise AssertionError(f"CSV has {len(labels)} rows, "
                                             f"segment.txt {n_segments}")
                    if not all(0 <= l < N_CLASS for l in labels):
                        raise AssertionError("CSV label out of range")
                    csv[dt_name] = labels
                elif not 0.0 <= out <= 100.0:
                    raise AssertionError(f"dev accuracy {out}")

        t0 = time.time()
        cpu_csv = read_csv_labels(inference_cli.main(
            base + ["--part", "test", "--device", "cpu"]))
        agree = float(np.mean(np.asarray(cpu_csv) == np.asarray(csv["float32"])))
        agree16 = float(np.mean(np.asarray(csv["bfloat16"])
                                == np.asarray(csv["float32"])))
        log(f"[slice] cpu float32 --part test in {time.time() - t0:.1f} s; "
            f"segment labels cuda f32 vs cpu f32 agree {agree:.4f}, "
            f"cuda bf16 vs cuda f32 agree {agree16:.4f}")
        if agree < 0.99:
            raise AssertionError("GPU and CPU segment labels disagree")

        # forward throughput: host time around synchronised work
        n_frames = sum(len(f) for f in feats)
        gpu_model = load_models([name], N_CLASS, models_dir="models",
                                device="cuda")[name]
        for dt_name in ("float32", "bfloat16"):
            frame_predictions(gpu_model, feats, dtype=dt_name)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame_predictions(gpu_model, feats, dtype=dt_name)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            log(f"[slice] bigru forward {dt_name}: {n_frames} frames of "
                f"{len(feats)} test videos in {seconds:.4f} s = "
                f"{n_frames / seconds:.0f} frames/s (batch 8, bucket 128) "
                f"on {card}")
    return launches, rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    bench_rows = phase_kernels()
    launches, main_rows = phase_slice(card)

    main_row = main_rows[0]  # layer 0 (W_in=400), f32, the main path's shape
    kernels = [{
        "name": "gru_bidir_fwd", "route": "cuda", "source": KERNEL_SRC,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shapes": main_rows + bench_rows}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
