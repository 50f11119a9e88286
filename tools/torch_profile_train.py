#!/usr/bin/env python3
"""Where the time of one train step of the PyTorch port goes, on one
NVIDIA GPU.

    python3 tools/torch_profile_train.py [--model bigru|bilstm|attn|ms_tcn|
                                                  vanilla_lstm]
                                         [--dtype float32|bfloat16]
                                         [--cfg KEY=INT ...] [--root DIR]
                                         [--trace trace.json]

Writes the seeded Breakfast-shaped dataset of ``chip_smoke.py`` (48 train
videos of 500-2500 frames) into a temporary directory, builds the train
CLI's feed (batch 8, bucket 128, the frozen-composition sampler with seed
0) and a full-width model (bigru by default; vanilla_lstm at the train
CLI's defaults, H=256, 2 layers; ``--cfg`` overrides fields of the
model's config, ``build_model(..., cfg_overrides=...)``: ``--model bigru
--cfg hidden_dim_1=512`` runs the bidirectional GRU on the GRU scan, H=256
a direction) with seeded weights, runs one
epoch of train steps to warm up and one more under ``torch.profiler``, and
prints:

* the host wall time of the profiled epoch (synchronised) and its
  frames/s;
* device time by kernel name, largest first;
* the device busy share: the union of the kernels' intervals over the
  span from the first kernel's start to the last one's end, and over the
  wall time;
* for attn, the steps of one more epoch (not profiled) by attention path,
  each timed with CUDA events: the dense path's (padded T below
  ``BLOCKWISE_MIN_T``) and the flash path's, and the time the dense
  path's int64-emulated dropout mask over ``[B, 4, T, T]``
  (``hashmask.keep_mask``) takes at those steps' shapes.

``--root`` profiles another checkout's package (its ``chip_smoke.py``
and ``pytorch_video_action_tpu_torch``, for example the parent commit
unpacked with ``git archive``) with this tool.  Exits non-zero without a
card or when the profiler records no device time.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="bigru",
                    choices=["bigru", "bilstm", "attn", "ms_tcn",
                             "vanilla_lstm"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--cfg", nargs="*", default=[], metavar="KEY=INT",
                    help="integer fields of the model's config to override")
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose package is profiled")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the profiled epoch here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    overrides = {k: int(v) for k, v in (c.split("=") for c in args.cfg)}

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_train: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False

    import chip_smoke
    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.train.loop import Trainer
    from torch_profile_inference import device_report

    print(chip_smoke.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as root, contextlib.chdir(root):
        chip_smoke.write_dataset(root)
        feed, _ = chip_smoke.train_feeds(root)
        host_batches = list(feed)
    model = build_model(args.model, chip_smoke.N_CLASS,
                        generator=torch.Generator().manual_seed(0),
                        **({"cfg_overrides": overrides} if overrides else {}))
    trainer = Trainer(model, chip_smoke.N_CLASS, seed=0,
                      compute_dtype=args.dtype)
    ts = trainer.init_state()
    batches = [trainer.prepare_batch(b) for b in host_batches]
    n_frames = sum(int(b[1].sum()) for b in host_batches)

    for b in batches:  # warm-up epoch
        trainer.train_step(ts, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            trainer.train_step(ts, b)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    print(f"{args.model}{''.join(f' {c}' for c in args.cfg)} train "
          f"{args.dtype} ({args.root}): {len(batches)} steps, "
          f"{n_frames} frames in "
          f"{wall_s:.6f} s = {n_frames / wall_s:.1f} frames/s (profiler on)")

    if device_report(prof, wall_s, "torch_profile_train") != 0:
        return 1
    if args.model == "attn":
        attn_paths(trainer, ts, batches)
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


def attn_paths(trainer, ts, batches) -> None:
    """Print attn's steps by attention path and the dense path's mask."""
    import torch

    from pytorch_video_action_tpu_torch.models import attention
    from pytorch_video_action_tpu_torch.ops import hashmask

    def event_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    steps = {"dense": [], "flash": []}
    mask_ms = 0.0
    thresh = hashmask.threshold(1.0 - ts.model.cfg.dropout_rate)
    for b in batches:
        b_n, t = b[0].shape[:2]
        path = "flash" if t >= attention.BLOCKWISE_MIN_T else "dense"
        steps[path].append((b_n, t, event_ms(
            lambda: trainer.train_step(ts, b))))
        if path == "dense":
            shape = (b_n, ts.model.cfg.num_heads, t, t)
            mask_ms += event_ms(lambda: hashmask.keep_mask(
                1, shape, thresh, device=b[0].device))
    total = sum(ms for v in steps.values() for _, _, ms in v)
    for path, v in steps.items():
        ms = sum(m for _, _, m in v)
        print(f"attn {path} path: {len(v)} steps {[(b, t) for b, t, _ in v]}"
              f", {ms:.4f} ms = {100 * ms / total:.2f} % of the epoch's "
              f"{total:.4f} ms (CUDA events, profiler off)")
    print(f"attn dense path dropout mask (hashmask.keep_mask over [B, 4, T, "
          f"T], int64): {mask_ms:.4f} ms = {100 * mask_ms / total:.2f} % of "
          f"the epoch")


if __name__ == "__main__":
    sys.exit(main())
