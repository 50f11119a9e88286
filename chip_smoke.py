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
   at the bench shape (B=64, T=1024, where bench.py times bigru and
   bilstm), for layer 0 (W_in=400) and the later layers (256) in f32 and
   bf16: the GRU and the LSTM layer's forward in its eval and train forms
   and its backward.  Times kernel, plain version and a one-call PyTorch
   yardstick (nn.GRU or nn.LSTM on a packed sequence: its forward, its
   forward with autograd on, and ``torch.autograd.grad`` through it) with
   CUDA events, beside each kernel's bound.
4. serving: writes a seeded Breakfast-shaped dataset (48 train, 24 dev, 24
   test videos) and full-width bigru and bilstm checkpoints into a
   temporary directory.  For each model: repeats phase 3's forward check at
   the largest forward batch the slice gives the kernel, runs the port's
   inference CLI on the card (test CSV and dev accuracy, f32 and bf16),
   checks the launch counts and the CSV, runs the CLI once on the CPU to
   compare labels, and prints the forward's frames/s.  Then serves the two
   checkpoints as one ensemble on the card.
5. training: for bigru and bilstm, repeats phase 3's train-form and
   backward checks at the largest train batch, runs the port's train CLI
   on the card (2 epochs, batch 8, f32 and bf16), checks the launch counts
   (per step one train-form forward and one backward per layer, per dev
   batch one eval-form forward per layer), that the loss is finite and
   falls from epoch 1 to 2, and that the inference CLI serves the
   checkpoint; holds one train step's gradients on the card against the
   same step on the CPU; prints the train step's frames/s.  Then trains
   bilstm_lm with the CLI (2 epochs, f32): launch counts, falling loss,
   and a checkpoint that holds its BatchNorm state (``__state__/`` keys).

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

B_BENCH, T_BENCH = 64, 1024  # the shape bench.py times bigru and bilstm at
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
CSRC = "pytorch_video_action_tpu_torch/csrc/"
PALLAS = "pytorch_video_action_tpu/ops/rnn_fused_pallas.py:"
H = 128  # hidden_dim_1 256 = 2 directions x 128, bigru and bilstm alike


class Cell:
    """One recurrent cell's layer kernels, as the checks below use them:
    the wrappers and plain versions of ``ops/rnn_fused.py``, the weights'
    shapes, the nn.GRU / nn.LSTM yardstick and the bounds."""

    def __init__(self, name: str):
        from pytorch_video_action_tpu_torch.ops import rnn_fused

        self.name = name
        self.lstm = name == "lstm"
        self.n_gates = 4 if self.lstm else 3
        self.n_res = 5 if self.lstm else 4  # residual width per step, in H
        self.fwd_name = f"{name}_bidir_fwd"
        self.bwd_name = f"{name}_bidir_bwd"
        self.fwd = getattr(rnn_fused, self.fwd_name)
        self.bwd = getattr(rnn_fused, self.bwd_name)
        self.fwd_ref = getattr(rnn_fused, f"{name}_bidir_layer_ref")
        self.bwd_ref = getattr(rnn_fused, f"{name}_bidir_layer_bwd_ref")
        self.library = "nn.LSTM" if self.lstm else "nn.GRU"
        self.fwd_src, self.bwd_src = (f"{CSRC}{n}.cu" for n in
                                      (self.fwd_name, self.bwd_name))
        self.fwd_replaces, self.bwd_replaces = (
            ("1632", "1780") if self.lstm else ("1008", "1190"))

    def weight_shapes(self, w_in):
        """wif, wib, the biases (one folded bias per direction for the
        LSTM, bi then bh for the GRU), whf, whb."""
        g = self.n_gates * H
        biases = 2 if self.lstm else 4
        shapes = [(w_in, g)] * 2 + [(g,)] * 2 + [(H, g)] * 2
        return shapes + [(g,)] * (biases - 2)

    def weight_count(self, w_in):
        return sum(int(np.prod(s)) for s in self.weight_shapes(w_in))

    def bound(self, t_len, b, w_in, dt_name, train=False):
        """Least time (ms) the card could take for one layer's forward:
        each input read once, each output (ys; in the train form also the
        residuals and, for the LSTM, the f32 cell states) written once,
        against the peak rates."""
        size = 4 if dt_name == "float32" else 2
        outputs = 2 * t_len * b * H * (1 + (self.n_res if train else 0))
        n_bytes = ((t_len * b * w_in + self.weight_count(w_in) + outputs)
                   * size + 4 * b)
        if train and self.lstm:
            n_bytes += 2 * t_len * b * H * 4
        flops = 2 * t_len * b * (w_in + H) * self.n_gates * H * 2
        return _bound(n_bytes, flops, dt_name)

    def bound_bwd(self, t_len, b, w_in, dt_name):
        """Least time (ms) for one layer's backward: x, the weights, ys, the
        residuals (and the LSTM's f32 cell states) and dy read once, dx and
        the gradients written once; FLOPs 4*T*B*gH*(2*W_in + 2H) (dwi, dx,
        dwh and the carry product, both directions)."""
        size = 4 if dt_name == "float32" else 2
        weights = self.weight_count(w_in)
        reads = (t_len * b * w_in + weights
                 + 2 * t_len * b * H * (1 + self.n_res + 1))
        writes = t_len * b * w_in + weights
        n_bytes = (reads + writes) * size + 4 * b
        if self.lstm:
            n_bytes += 2 * t_len * b * H * 4
        flops = 4 * t_len * b * self.n_gates * H * (2 * w_in + 2 * H)
        return _bound(n_bytes, flops, dt_name)

    def bwd_args(self, x, ws, lengths, fwd, dys):
        return (x, ws[0], ws[1], ws[4], ws[5], lengths, *fwd, *dys)

    def module(self, x, ws):
        """torch.nn.GRU / LSTM(bidirectional=True) with the same weights, on
        the card in x's dtype: the yardstick, timed here only, never called
        by the port.  The LSTM's folded bias goes to bias_ih, bias_hh is
        0."""
        import torch

        w_in = x.shape[2]
        net = (torch.nn.LSTM if self.lstm else torch.nn.GRU)(
            w_in, H, bidirectional=True)
        if self.lstm:
            wif, wib, bf, bb, whf, whb = ws
            dirs = (("", wif, whf, bf, torch.zeros_like(bf)),
                    ("_reverse", wib, whb, bb, torch.zeros_like(bb)))
        else:
            wif, wib, bif, bib, whf, whb, bhf, bhb = ws
            dirs = (("", wif, whf, bif, bhf), ("_reverse", wib, whb, bib, bhb))
        with torch.no_grad():
            for sfx, wi, wh, bi, bh in dirs:
                getattr(net, "weight_ih_l0" + sfx).copy_(wi.t())
                getattr(net, "weight_hh_l0" + sfx).copy_(wh.t())
                getattr(net, "bias_ih_l0" + sfx).copy_(bi)
                getattr(net, "bias_hh_l0" + sfx).copy_(bh)
        # moving the module lays its weights out as one cuDNN buffer
        return net.to("cuda", x.dtype)


GRU = LSTM = None  # the two Cells, made once torch is importable


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


def layer_inputs(cell, t_len, b, w_in, dt, lengths, gen):
    import torch

    k = 1.0 / H ** 0.5
    ws = [((torch.rand(s, generator=gen) * 2 - 1) * k).to("cuda", dt)
          for s in cell.weight_shapes(w_in)]
    x = torch.randn(t_len, b, w_in, generator=gen).to("cuda", dt)
    return x, ws, torch.as_tensor(lengths, dtype=torch.int32).cuda()


def library_fwd(cell, x, ws, lengths):
    """The yardstick's forward on a packed sequence: one call."""
    from torch.nn.utils.rnn import pack_padded_sequence

    net = cell.module(x, ws).eval()
    lengths_cpu = lengths.cpu()

    def run():
        packed = pack_padded_sequence(x, lengths_cpu, enforce_sorted=False)
        return net(packed)[0]

    return run


def library_train(cell, x, ws, lengths, dys):
    """The yardstick's forward with autograd on (what training runs) and
    ``torch.autograd.grad`` of the packed output against the same output
    gradients (the VJP in one call)."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    net = cell.module(x, ws).train()
    lengths_cpu = lengths.cpu()
    xg = x.detach().requires_grad_(True)
    inputs = [xg, *net.parameters()]

    def fwd():
        packed = pack_padded_sequence(xg, lengths_cpu, enforce_sorted=False)
        return net(packed)[0]

    out = fwd().data
    dy = pack_padded_sequence(torch.cat(dys, dim=-1), lengths_cpu,
                              enforce_sorted=False).data

    def bwd():
        return torch.autograd.grad(out, inputs, dy, retain_graph=True)

    return fwd, bwd


def _bound(n_bytes, flops, dt_name):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dt_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_layer(cell, where, lengths, t_len, w_in, dt_name, gen):
    """Hold the eval-form kernel against its plain version on one input and
    time the kernel, the plain version and the library yardstick.  Raises
    when they disagree.  Returns the row for the ``kernels`` line."""
    import torch

    dt = getattr(torch, dt_name)
    b = len(lengths)
    x, ws, lengths = layer_inputs(cell, t_len, b, w_in, dt, lengths, gen)
    ysf, ysb = cell.fwd(x, *ws, lengths)
    torch.cuda.synchronize()
    rf, rb = cell.fwd_ref(x, *ws, lengths)
    err_f = (ysf.float() - rf.float()).abs().max().item()
    err_b = (ysb.float() - rb.float()).abs().max().item()
    pad = (torch.arange(t_len, device="cuda")[:, None]
           >= lengths[None, :].long())
    pad_b = ysb.float().abs()[pad].max().item() if pad.any() else 0.0
    ms = cuda_ms(lambda: cell.fwd(x, *ws, lengths), 10, 2)
    plain_ms = cuda_ms(lambda: cell.fwd_ref(x, *ws, lengths), 2)
    lib_run = library_fwd(cell, x, ws, lengths)
    with torch.no_grad():
        lib_ms = cuda_ms(lib_run, 10, 2)
    bound_ms, bound_by = cell.bound(t_len, b, w_in, dt_name)
    row = {"where": where, "w_in": w_in, "dtype": dt_name, "B": b,
           "T": t_len, "max_abs_err": max(err_f, err_b), "tol": TOL[dt_name],
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"[kernel] {cell.fwd_name} {where} B={b} T={t_len} W_in={w_in} "
        f"{dt_name}: max|ysf-ref|={err_f:.3g} max|ysb-ref|={err_b:.3g} "
        f"(tol {TOL[dt_name]}), max|ysb| on padding={pad_b:.3g}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"{cell.library} packed {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by})")
    if not (err_f <= TOL[dt_name] and err_b <= TOL[dt_name]):
        raise AssertionError(f"kernel disagrees with its plain version: {row}")
    if pad_b != 0.0:
        raise AssertionError("ys_b is not 0 on padded frames")
    return row


def check_layers(cell, where, lengths, t_len, gen):
    """``check_layer`` for layer 0 (W_in=400) and the later layers (256), in
    f32 and bf16."""
    return [check_layer(cell, where, lengths, t_len, w_in, dt_name, gen)
            for w_in in (400, 256) for dt_name in ("float32", "bfloat16")]


def rel_err(got, want):
    """(max abs error, max error relative to the largest plain element, at
    least 1) over a kernel's outputs."""
    abs_err = rel = 0.0
    for g, w in zip(got, want):
        d = (g.float() - w.float()).abs().max().item()
        abs_err = max(abs_err, d)
        rel = max(rel, d / max(1.0, w.float().abs().max().item()))
    return abs_err, rel


def check_train_layer(cell, where, lengths, t_len, w_in, dt_name, gen):
    """Hold the train-form forward and the backward against their plain
    versions on one input, and time each beside its plain version, the
    library yardstick and its bound.  Raises when they disagree.  Returns
    the rows ``(train_form, backward)`` for the ``kernels`` line."""
    import torch

    dt = getattr(torch, dt_name)
    b = len(lengths)
    x, ws, lengths = layer_inputs(cell, t_len, b, w_in, dt, lengths, gen)
    dys = [torch.randn(t_len, b, H, generator=gen).to("cuda", dt)
           for _ in range(2)]
    head = f"{where} B={b} T={t_len} W_in={w_in} {dt_name}"
    tol = TOL[dt_name]

    fwd = cell.fwd(x, *ws, lengths, train=True)
    torch.cuda.synchronize()
    ref = cell.fwd_ref(x, *ws, lengths, train=True)
    # the error is absolute, except that the LSTM's f32 cell state, which
    # unlike ys and its residuals is not bounded by 1, is taken relative to
    # its largest element (at least 1)
    abs_fwd, rel_fwd = rel_err(fwd, ref)
    err_fwd = rel_fwd if cell.lstm else abs_fwd
    ms = cuda_ms(lambda: cell.fwd(x, *ws, lengths, train=True), 10, 2)
    plain_ms = cuda_ms(
        lambda: cell.fwd_ref(x, *ws, lengths, train=True), 1, 0)
    lib_fwd, lib_bwd = library_train(cell, x, ws, lengths, dys)
    lib_ms = cuda_ms(lib_fwd, 10, 2)
    bound_ms, bound_by = cell.bound(t_len, b, w_in, dt_name, train=True)
    fwd_row = {"where": where, "w_in": w_in, "dtype": dt_name, "B": b,
               "T": t_len, "max_abs_err": err_fwd, "tol": tol, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"[kernel] {cell.fwd_name} train form {head}: max|out-ref|="
        f"{abs_fwd:.3g}, error {err_fwd:.3g} (tol {tol}), kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, {cell.library} packed with autograd "
        f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not err_fwd <= tol:
        raise AssertionError(f"train form disagrees with its plain version: "
                             f"{fwd_row}")

    bargs = cell.bwd_args(x, ws, lengths, fwd, dys)
    got = cell.bwd(*bargs)
    torch.cuda.synchronize()
    want = cell.bwd_ref(*bargs)
    abs_err, err_bwd = rel_err(got, want)
    again = cell.bwd(*bargs)
    identical = all(torch.equal(a, c) for a, c in zip(got, again))
    ms = cuda_ms(lambda: cell.bwd(*bargs), 5, 1)
    plain_ms = cuda_ms(lambda: cell.bwd_ref(*bargs), 1, 0)
    lib_ms = cuda_ms(lib_bwd, 5, 1)
    bound_ms, bound_by = cell.bound_bwd(t_len, b, w_in, dt_name)
    bwd_row = {"where": where, "w_in": w_in, "dtype": dt_name, "B": b,
               "T": t_len, "max_abs_err": abs_err, "max_rel_err": err_bwd,
               "tol": tol, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bit_identical_rerun": identical}
    log(f"[kernel] {cell.bwd_name} {head}: max abs err {abs_err:.3g}, max "
        f"err / max(1, max|plain|) {err_bwd:.3g} (tol {tol}), rerun "
        f"bit-identical {identical}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, autograd.grad through {cell.library} packed "
        f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not err_bwd <= tol:
        raise AssertionError(f"backward disagrees with its plain version: "
                             f"{bwd_row}")
    if not identical:
        raise AssertionError("two backward runs differ")
    return fwd_row, bwd_row


def check_train_layers(cell, where, lengths, t_len, gen):
    """``check_train_layer`` for W_in 400 and 256, f32 and bf16: lists of
    train-form rows and of backward rows."""
    rows = [check_train_layer(cell, where, lengths, t_len, w_in, dt_name,
                              gen)
            for w_in in (400, 256) for dt_name in ("float32", "bfloat16")]
    return [r[0] for r in rows], [r[1] for r in rows]


def phase_kernels():
    """Every kernel at the bench shape: ``{kernel name: rows}``."""
    import torch

    rows = {}
    for cell in (GRU, LSTM):
        gen = torch.Generator().manual_seed(0)
        lengths = torch.randint(1, T_BENCH + 1, (B_BENCH,), generator=gen)
        lengths[0], lengths[1] = 1, T_BENCH
        lengths = lengths.tolist()
        t0 = time.time()
        rows[cell.fwd_name] = check_layers(cell, "bench", lengths, T_BENCH,
                                           gen)
        (rows[cell.fwd_name + "_train"],
         rows[cell.bwd_name]) = check_train_layers(cell, "bench", lengths,
                                                   T_BENCH, gen)
        log(f"[kernel] {cell.name} bench-shape checks in "
            f"{time.time() - t0:.1f} s")
    return rows


# ------------------------------------------------------------------ slice

N_CLASS = 48


def write_dataset(root: str, seed: int = 0, train: bool = True,
                  frames=(500, 2500)) -> None:
    """Breakfast-shaped tree: 48 classes, 24 dev and 24 test videos (and 48
    train videos unless ``train`` is False) of ``frames`` (500-2500 by
    default) frames, gz text features, ground truth and segment.txt."""
    rng = np.random.default_rng(seed)
    names = ["SIL"] + [f"action_{i:02d}" for i in range(1, N_CLASS)]
    means = rng.normal(0.0, 1.0, size=(N_CLASS, 400)).astype(np.float32)
    for d in ("splits/splits", "splits/new_splits", "groundTruth/groundTruth",
              "data"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    with open(os.path.join(root, "splits/splits/mapping_bf.txt"), "w") as f:
        f.write("".join(f"{i} {n}\n" for i, n in enumerate(names)))

    def video():
        t_len = int(rng.integers(frames[0], frames[1] + 1))
        labels = np.zeros(t_len, dtype=np.int64)
        edge = min(50, t_len // 5)
        cuts = np.sort(rng.choice(np.arange(edge, t_len - edge), 6,
                                  replace=False))
        for a, b in zip(cuts[:-1], cuts[1:]):
            labels[a:b] = rng.integers(1, N_CLASS)
        feats = means[labels] + rng.normal(0, 0.5, (t_len, 400))
        return feats.astype(np.float32), labels

    # (part, videos, file-name letter, bundle); train last, so that the dev
    # and test videos do not depend on whether it is written
    parts = [("dev", 24, "D", "splits/new_splits/dev.split0.bundle"),
             ("test", 24, "T", "splits/splits/test.split1.bundle")]
    if train:
        parts.append(("train", 48, "P", "splits/new_splits/train.split0.bundle"))
    seg_lines = []
    for part, count, letter, bundle in parts:
        files = []
        for i in range(count):
            stem = f"{letter}{i:02d}_cam01_{letter}{i:02d}_cereals"
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


# the served and trained models: their layer kernels and layer count
MODELS = {"bigru": ("gru", 4), "bilstm": ("lstm", 2),
          "bilstm_lm": ("lstm", 2)}


def cell_of(name):
    return GRU if MODELS[name][0] == "gru" else LSTM


def save_checkpoint(root: str, name: str) -> str:
    """A full-width checkpoint of ``name`` from seeded weights (the
    inference CLI's default configuration); returns its file name."""
    import torch

    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.models.params import to_jax_params
    from pytorch_video_action_tpu_torch.train.checkpoint import save_params

    model = build_model(name, N_CLASS, defaults=True,
                        generator=torch.Generator().manual_seed(0))
    ckpt = f"{name}_00.00_dev"
    save_params(os.path.join(root, "models", f"{ckpt}.npz"),
                to_jax_params(name, model.state_dict()))
    return ckpt


def phase_slice(card: str, root: str, name: str):
    """The inference slice of ``name`` on the dataset under ``root`` (the
    cwd).  Returns its checkpoint name, the eval-form launches of its CLI
    runs and its kernel rows."""
    import torch

    from pytorch_video_action_tpu_torch.cli import inference_cli
    from pytorch_video_action_tpu_torch.data.bundles import load_segment_file
    from pytorch_video_action_tpu_torch.data.dataset import VideoDataset
    from pytorch_video_action_tpu_torch.infer.loader import load_models
    from pytorch_video_action_tpu_torch.infer.predict import (
        forward_batches, frame_predictions)

    cell, n_layers = cell_of(name), MODELS[name][1]
    launches = 0
    ckpt = save_checkpoint(root, name)
    base = ["--pretrained_model", ckpt, "--prob", "big",
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
    rows = check_layers(cell, "main path", [len(feats[i]) for i in chunk],
                        t_pad, torch.Generator().manual_seed(1))

    csv = {}
    for dt_name in ("float32", "bfloat16"):
        for part in ("test", "dev"):
            expect = n_layers * len(forward_batches(datasets[part].features))
            cell.fwd.launches = 0
            t0 = time.time()
            out = inference_cli.main(base + ["--part", part, "--dtype",
                                             dt_name, "--device", "cuda"])
            seconds = time.time() - t0
            got = cell.fwd.launches
            launches += got
            log(f"[slice] {name} cuda {dt_name} --part {part}: "
                f"{'csv ' + out if part == 'test' else f'accuracy {out:.2f}'}"
                f" in {seconds:.1f} s, {cell.fwd_name} launches {got} "
                f"(expected {expect} = {n_layers} per forward batch)")
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
    log(f"[slice] {name} cpu float32 --part test in {time.time() - t0:.1f} "
        f"s; segment labels cuda f32 vs cpu f32 agree {agree:.4f}, "
        f"cuda bf16 vs cuda f32 agree {agree16:.4f}")
    if agree < 0.99:
        raise AssertionError("GPU and CPU segment labels disagree")

    # forward throughput: host time around synchronised work
    n_frames = sum(len(f) for f in feats)
    gpu_model = load_models([ckpt], N_CLASS, models_dir="models",
                            device="cuda")[ckpt]
    for dt_name in ("float32", "bfloat16"):
        frame_predictions(gpu_model, feats, dtype=dt_name)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame_predictions(gpu_model, feats, dtype=dt_name)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        log(f"[slice] {name} forward {dt_name}: {n_frames} frames of "
            f"{len(feats)} test videos in {seconds:.4f} s = "
            f"{n_frames / seconds:.0f} frames/s (batch 8, bucket 128) "
            f"on {card}")
    return ckpt, launches, rows


def phase_ensemble(root: str, ckpts: list[str]) -> dict:
    """The inference CLI serves the checkpoints as one ensemble on the card
    (test part, f32).  Returns the eval-form launches by kernel name."""
    from pytorch_video_action_tpu_torch.cli import inference_cli
    from pytorch_video_action_tpu_torch.data.dataset import VideoDataset
    from pytorch_video_action_tpu_torch.infer.predict import forward_batches

    batches = len(forward_batches(VideoDataset(
        data_dir="data", annot_path=root, part="test", split=1, mode=None,
        verbose=False).features))
    names = [c.split("_00.00_dev")[0] for c in ckpts]
    for cell in (GRU, LSTM):
        cell.fwd.launches = 0
    out = inference_cli.main(["--pretrained_model", *ckpts, "--prob", "big",
                              "--part", "test", "--data_dir",
                              os.path.join(root, "data"), "--annot_path",
                              root, "--device", "cuda"])
    got = {cell.fwd_name: cell.fwd.launches for cell in (GRU, LSTM)}
    expect = {cell_of(n).fwd_name: MODELS[n][1] * batches for n in names}
    labels = read_csv_labels(out)
    log(f"[slice] ensemble {' + '.join(ckpts)} on the card: {len(labels)} "
        f"CSV rows, launches {got} (expected {expect})")
    if got != expect:
        raise AssertionError("ensemble launch counts do not match")
    if not (labels and all(0 <= l < N_CLASS for l in labels)):
        raise AssertionError("the ensemble serves no CSV")
    return got


# ---------------------------------------------------------------- training

TRAIN_EPOCHS, TRAIN_BATCH = 2, 8
GRAD_TOL = 1e-3  # card against CPU, f32, relative to each tensor's max


def train_feeds(root: str):
    """The train CLI's feeds on the dataset under ``root``: the train feed
    (frozen composition, seed 0) and the dev feed."""
    from pytorch_video_action_tpu_torch.data import (
        BatchFeed, BucketBatchSampler, VideoDataset)

    kw = dict(data_dir="data", annot_path=root, split=0, mode="active",
              verbose=False)
    train_ds = VideoDataset(part="train", **kw)
    dev_ds = VideoDataset(part="dev", **kw)
    sampler = BucketBatchSampler(train_ds.features, TRAIN_BATCH, seed=0,
                                 freeze_composition=True)
    return (BatchFeed(train_ds, batch_sampler=sampler),
            BatchFeed(dev_ds, batch_size=TRAIN_BATCH))


def epoch_records(path: str) -> list[dict]:
    """The ``epoch`` records of a ``--metrics_jsonl`` file."""
    with open(path) as f:
        records = [json.loads(line) for line in f]
    return [r for r in records if r["event"] == "epoch"]


def check_grads_against_cpu(name, batch):
    """One f32 train step of ``name`` on the card and on the CPU, from the
    same parameters, batch and seeds; raises when a gradient differs by
    more than ``GRAD_TOL`` of its tensor's largest element."""
    import torch

    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.train.loop import Trainer

    state = build_model(name, N_CLASS,
                        generator=torch.Generator().manual_seed(2)).state_dict()
    grads, losses = {}, {}
    for device in ("cuda", "cpu"):
        model = build_model(name, N_CLASS)
        model.load_state_dict(state)
        trainer = Trainer(model, N_CLASS, seed=0, device=device)
        ts = trainer.init_state()
        seeds = list(range(11, 11 + model.n_dropout_sites))
        losses[device] = trainer.train_step(ts, batch, seeds=seeds).item()
        grads[device] = {k: p.grad.detach().cpu()
                         for k, p in ts.model.named_parameters()}
    worst = 0.0
    for k, want in grads["cpu"].items():
        err = ((grads["cuda"][k] - want).abs().max()
               / want.abs().max().clamp(min=1e-30)).item()
        worst = max(worst, err)
    log(f"[train] {name} one f32 step, B={batch[0].shape[0]} "
        f"T={batch[0].shape[1]}: loss cuda {losses['cuda']:.6f} cpu "
        f"{losses['cpu']:.6f}; worst gradient difference / max|cpu "
        f"gradient| {worst:.3g} (tol {GRAD_TOL})")
    if not worst <= GRAD_TOL or abs(losses["cuda"] - losses["cpu"]) > 1e-4:
        raise AssertionError("card and CPU train steps disagree")


def train_frames_per_sec(card, name, feed, dt_name):
    """Host clock around one epoch of synchronised train steps on prepared
    batches, after one warm-up step."""
    import torch

    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.train.loop import Trainer

    model = build_model(name, N_CLASS,
                        generator=torch.Generator().manual_seed(3))
    trainer = Trainer(model, N_CLASS, seed=0, compute_dtype=dt_name)
    ts = trainer.init_state()
    batches = [trainer.prepare_batch(b) for b in feed]
    frames = sum(int(b[1].sum()) for b in batches)
    trainer.train_step(ts, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        trainer.train_step(ts, b)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log(f"[train] {name} train step {dt_name}: {frames} frames in "
        f"{len(batches)} steps in {seconds:.4f} s = {frames / seconds:.0f} "
        f"frames/s (batch {TRAIN_BATCH}, bucket 128) on {card}")


def train_cli_run(root, name, dt_name, steps, dev_batches):
    """The train CLI on the card, with the layer kernels' counts set to 0
    just before it and read just after.  Checks the launch counts and the
    loss; returns ``(best dev accuracy, launches)``."""
    from pytorch_video_action_tpu_torch.cli import train_cli

    cell, n_layers = cell_of(name), MODELS[name][1]
    metrics = os.path.join(root, f"train_{name}_{dt_name}.jsonl")
    cell.fwd.launches = cell.fwd.train_launches = cell.bwd.launches = 0
    t0 = time.time()
    best = train_cli.main([
        "--model", name, "--epoch", str(TRAIN_EPOCHS), "--batchsize",
        str(TRAIN_BATCH), "--split", "0", "--data_dir",
        os.path.join(root, "data"), "--annot_path", root, "--dtype",
        dt_name, "--device", "cuda", "--metrics_jsonl", metrics])
    seconds = time.time() - t0
    got = {"eval": cell.fwd.launches, "train": cell.fwd.train_launches,
           "bwd": cell.bwd.launches}
    expect = {"eval": n_layers * dev_batches, "train": n_layers * steps,
              "bwd": n_layers * steps}
    epochs = epoch_records(metrics)
    loss = [r["train_loss"] for r in epochs]
    log(f"[train] {name} cuda {dt_name} train CLI: {TRAIN_EPOCHS} epochs of "
        f"{steps // TRAIN_EPOCHS} steps in {seconds:.1f} s, train loss "
        f"{loss}, dev segment accuracy "
        f"{[r['dev_segment_acc'] for r in epochs]}, CLI frames/s "
        f"{[r['frames_per_sec'] for r in epochs]}; launches train-form fwd "
        f"{got['train']}, bwd {got['bwd']} (expected {expect['train']} = "
        f"{n_layers} per step), eval-form fwd {got['eval']} (expected "
        f"{expect['eval']} = {n_layers} per dev batch)")
    if got != expect:
        raise AssertionError("launch counts do not match the steps")
    if not (len(loss) == TRAIN_EPOCHS and np.all(np.isfinite(loss))
            and loss[1] < loss[0]):
        raise AssertionError(f"train loss {loss}: not finite or not falling")
    return best, got


def phase_train(card: str, root: str, name: str):
    """The training slice of ``name`` on the dataset under ``root`` (the
    cwd).  Returns the launches of its CLI runs by kernel form (eval form,
    train form, backward) and the train-form and backward kernel rows."""
    import torch

    from pytorch_video_action_tpu_torch.cli import inference_cli

    cell = cell_of(name)
    t0 = time.time()
    train_feed, dev_feed = train_feeds(root)
    log(f"[train] train and dev parts parsed in {time.time() - t0:.1f} s")
    # the kernels at the largest shape training gives them: the train
    # batch with the most padded frames, its own lengths
    idxs = max(train_feed.index_batches(),
               key=lambda ix: max(len(train_feed.dataset.features[i])
                                  for i in ix))
    lens = [len(train_feed.dataset.features[i]) for i in idxs]
    t_pad = train_feed.collate(idxs)[0].shape[1]
    train_rows, bwd_rows = check_train_layers(
        cell, "main path", lens, t_pad, torch.Generator().manual_seed(4))

    steps = TRAIN_EPOCHS * len(train_feed)
    dev_batches = TRAIN_EPOCHS * len(dev_feed)
    launches = {"eval": 0, "train": 0, "bwd": 0}
    for dt_name in ("float32", "bfloat16"):
        best, got = train_cli_run(root, name, dt_name, steps, dev_batches)
        for k in launches:
            launches[k] += got[k]
        ckpt = f"{name}_{best:.2f}_dev"
        if not os.path.exists(os.path.join("models", f"{ckpt}.npz")):
            raise AssertionError(f"no checkpoint {ckpt}")
        labels = read_csv_labels(inference_cli.main([
            "--pretrained_model", ckpt, "--prob", "big", "--part", "test",
            "--data_dir", os.path.join(root, "data"), "--annot_path", root,
            "--device", "cuda"]))
        if not (labels and all(0 <= l < N_CLASS for l in labels)):
            raise AssertionError("the trained checkpoint serves no CSV")
        log(f"[train] checkpoint {ckpt} served: {len(labels)} CSV rows")

    # one step on the card and on the CPU: the smallest train batch, its
    # videos cut to 512 frames to bound the CPU's time
    small = min(train_feed.index_batches(),
                key=lambda ix: max(len(train_feed.dataset.features[i])
                                   for i in ix))
    batch = train_feed.collate(small)
    keep = min(batch[0].shape[1], 512)
    batch = (batch[0][:, :keep], np.minimum(batch[1], keep),
             batch[2].reshape(len(small), -1)[:, :keep].reshape(-1),
             batch[3][:, :keep])
    check_grads_against_cpu(name, batch)
    for dt_name in ("float32", "bfloat16"):
        train_frames_per_sec(card, name, train_feed, dt_name)
    return launches, train_rows, bwd_rows


LM_FRAMES = (40, 100)


def phase_train_lm(root: str) -> dict:
    """bilstm_lm through the train CLI on the card (f32): launch counts,
    falling loss, and a checkpoint holding its BatchNorm state.  Returns
    the launches by kernel form.

    Its own tree of 40-100-frame videos (``root``): the model feeds each
    frame's log-probs back as the next frames' context, and at its initial
    weights that loop diverges on Breakfast-length videos, in the JAX
    package as in the port (log-probs near -2e32 by frame 600, NaN by
    1500), so the loss would not be finite."""
    t0 = time.time()
    write_dataset(root, seed=1, frames=LM_FRAMES)
    log(f"[train] bilstm_lm dataset of {LM_FRAMES[0]}-{LM_FRAMES[1]}-frame "
        f"videos written in {time.time() - t0:.1f} s")
    train_feed, dev_feed = train_feeds(root)
    best, got = train_cli_run(root, "bilstm_lm", "float32",
                              TRAIN_EPOCHS * len(train_feed),
                              TRAIN_EPOCHS * len(dev_feed))
    path = os.path.join("models", f"bilstm_lm_{best:.2f}_dev.npz")
    with np.load(path) as z:
        state = sorted(k for k in z.files if k.startswith("__state__/"))
    log(f"[train] checkpoint {path}: state keys {state}")
    if state != ["__state__/bn1/mean", "__state__/bn1/var",
                 "__state__/bn2/mean", "__state__/bn2/var"]:
        raise AssertionError("the bilstm_lm checkpoint holds no BatchNorm "
                             "state")
    return got


def kernel_entry(name, source, replaces, launches, rows):
    """One ``kernels`` entry: headline numbers from ``rows[0]`` (layer 0,
    f32, at the main path's shape), every checked shape under ``shapes``."""
    head = rows[0]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shapes": rows}


def main() -> int:
    import torch

    global GRU, LSTM
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    GRU, LSTM = Cell("gru"), Cell("lstm")

    start = time.time()
    phase_build()
    bench = phase_kernels()
    rows, launches = {}, {}
    with tempfile.TemporaryDirectory() as root, contextlib.chdir(root):
        t0 = time.time()
        write_dataset(root)
        log(f"[slice] dataset written in {time.time() - t0:.1f} s")
        ckpts = []
        for name in ("bigru", "bilstm"):
            cell = cell_of(name)
            ckpt, n, rows[cell.fwd_name] = phase_slice(card, root, name)
            ckpts.append(ckpt)
            launches[cell.fwd_name] = n
        for k, n in phase_ensemble(root, ckpts[::-1]).items():
            launches[k] += n
        t0 = time.time()
        for name in ("bigru", "bilstm"):
            cell = cell_of(name)
            got, rows[cell.fwd_name + "_train"], rows[cell.bwd_name] = (
                phase_train(card, root, name))
            launches[cell.fwd_name] += got["eval"]
            launches[cell.fwd_name + "_train"] = got["train"]
            launches[cell.bwd_name] = got["bwd"]
        # its own tree and cwd: the feature cache (data-comp/) is per cwd
        lm_root = os.path.join(root, "lm")
        os.makedirs(lm_root)
        with contextlib.chdir(lm_root):
            got = phase_train_lm(lm_root)
        launches[LSTM.fwd_name] += got["eval"]
        launches[LSTM.fwd_name + "_train"] += got["train"]
        launches[LSTM.bwd_name] += got["bwd"]
        log(f"[train] training phases in {time.time() - t0:.1f} s")
    log(f"[done] all phases in {time.time() - start:.1f} s")

    kernels = []
    for cell in (GRU, LSTM):
        for name, src, replaces in (
                (cell.fwd_name, cell.fwd_src, cell.fwd_replaces),
                (cell.fwd_name + "_train", cell.fwd_src, cell.fwd_replaces),
                (cell.bwd_name, cell.bwd_src, cell.bwd_replaces)):
            kernels.append(kernel_entry(name, src, PALLAS + replaces,
                                        launches[name],
                                        rows[name] + bench[name]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
