#!/usr/bin/env python3
"""Where the time of the PyTorch port's bigru inference forward goes, on
one NVIDIA GPU.

    python3 tools/torch_profile_inference.py [--dtype float32|bfloat16]
                                             [--trace trace.json]

Writes the seeded Breakfast-shaped test set of ``chip_smoke.py`` (24 videos
of 500-2500 frames) and a full-width bigru with seeded weights into a
temporary directory, runs the port's ``frame_predictions`` once to warm up
and once under ``torch.profiler``, and prints:

* the host wall time of the profiled forward (synchronised) and its frames/s;
* device time by kernel name, largest first;
* the device busy share: the union of the kernels' intervals over the
  span from the first kernel's start to the last one's end, and over the
  wall time.

Exits non-zero without a card or when the profiler records no device time.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the profiled forward here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_inference: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False

    import chip_smoke
    from pytorch_video_action_tpu_torch.data.dataset import VideoDataset
    from pytorch_video_action_tpu_torch.infer.predict import frame_predictions
    from pytorch_video_action_tpu_torch.models import build_model

    print(chip_smoke.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as root, contextlib.chdir(root):
        chip_smoke.write_dataset(root)
        feats = VideoDataset(data_dir="data", annot_path=root, part="test",
                             split=1, mode=None, verbose=False).features
    model = build_model("bigru", chip_smoke.N_CLASS,
                        generator=torch.Generator().manual_seed(0))
    model = model.to("cuda").eval()
    n_frames = sum(len(f) for f in feats)

    frame_predictions(model, feats, dtype=args.dtype)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame_predictions(model, feats, dtype=args.dtype)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    print(f"forward {args.dtype}: {n_frames} frames in {wall_s:.6f} s = "
          f"{n_frames / wall_s:.1f} frames/s (profiler on)")

    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device_events:
        print("torch_profile_inference: the profiler recorded no device "
              "time", file=sys.stderr)
        return 1
    by_name: dict[str, list[float]] = {}
    for e in device_events:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    total = sum(sum(v) for v in by_name.values())
    print(f"device time {total / 1e3:.4f} ms in {len(device_events)} "
          f"device events")
    for name, times in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]:
        print(f"  {sum(times) / 1e3:10.4f} ms {100 * sum(times) / total:6.2f} % "
              f"x{len(times):4d}  {name[:100]}")
    spans = [(e.time_range.start, e.time_range.end) for e in device_events]
    busy = busy_us(spans)
    span = max(e for _, e in spans) - min(s for s, _ in spans)
    print(f"device busy {busy / 1e3:.4f} ms: {100 * busy / span:.2f} % of the "
          f"first-to-last kernel span ({span / 1e3:.4f} ms), "
          f"{100 * busy / 1e3 / (wall_s * 1e3):.2f} % of the wall time")
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
