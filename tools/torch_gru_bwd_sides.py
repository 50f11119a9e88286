#!/usr/bin/env python3
"""Which side sets the pace of the GRU layer backward's tensor-core
products (``csrc/rnn_wgmma.cuh``): the producers that read and convert the
operand chunks, or the consumer that multiplies them.  On one NVIDIA GPU:

    python3 tools/torch_gru_bwd_sides.py [--b 8] [--t 1920] [--w 400]

Builds ``csrc/gru_bidir_bwd.cu`` three times from copies of ``csrc/`` in a
temporary directory: as it is; with the consumer's products taken out
(the producers alone, ``producers``); and with the producers' reads and
writes taken out (the consumer alone on whatever the ring holds,
``consumer``).  Each build runs row 2 (``ops/rnn_fused.gru_bidir_bwd``) on
the same seeded inputs (bigru's layer 0 in training by default), f32 and
bf16, and prints the device time of ``wgrad_wgmma_kernel`` and
``dx_wgmma_kernel`` from ``torch.profiler``, with the card's name and
power limit.  The edited builds compute wrong gradients and are timed
only.  Exits non-zero without a card, or when the source no longer holds
the lines it edits.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (text in rnn_wgmma.cuh, its replacement) for each build
EDITS = {
    "as is": [],
    "producers": [("      if constexpr (kSharedA)\n"
                   "        mma_ss<T>(acc[h], s, y);\n"
                   "      else\n"
                   "        mma_ss<T>(acc[h], y, s);", "      (void)y;"),
                  ("        wgmma_rs<float>(acc[h], hi[a], bh[h] + o);\n"
                   "        wgmma_rs<float>(acc[h], hi[a], bl[h] + o);\n"
                   "        wgmma_rs<float>(acc[h], lo[a], bh[h] + o);",
                   "        (void)a;")],
    "consumer": [("    gather(a, c0, 0);\n", ""),
                 ("      gather(b, c, 1);\n", ""),
                 ("      scatter(s, a, 0);\n"
                  "      if (c + 1 < c1) gather(a, c + 1, 0);\n"
                  "      scatter(s, b, 1);\n", "      (void)s;\n")],
}
KERNELS = ("wgrad_wgmma_kernel", "dx_wgmma_kernel")


def build(csrc: Path, name: str, eds, tmp: Path, nvcc: str, flags) -> Path:
    d = tmp / name.replace(" ", "_")
    shutil.copytree(csrc, d)
    header = d / "rnn_wgmma.cuh"
    text = header.read_text()
    for old, new in eds:
        if old not in text:
            raise SystemExit(f"torch_gru_bwd_sides: rnn_wgmma.cuh no longer "
                             f"holds the lines the {name!r} build edits")
        text = text.replace(old, new)
    header.write_text(text)
    out = d / "libgru_bidir_bwd.so"
    subprocess.run([nvcc, *flags, "-o", str(out),
                    str(d / "gru_bidir_bwd.cu")], check=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--t", type=int, default=1920)
    ap.add_argument("--w", type=int, default=400)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_gru_bwd_sides: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pytorch_video_action_tpu_torch.ops import cuda_lib
    from pytorch_video_action_tpu_torch.ops import rnn_fused as P

    print(chip_smoke.card_line(), flush=True)
    h = 128
    inputs = {}
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(0)
        k = 1.0 / h ** 0.5
        shapes = ([(args.w, 3 * h)] * 2 + [(3 * h,)] * 2 + [(h, 3 * h)] * 2
                  + [(3 * h,)] * 2)
        ws = [((torch.rand(s, generator=gen) * 2 - 1) * k).to("cuda", dt)
              for s in shapes]
        x = torch.randn(args.t, args.b, args.w, generator=gen).to("cuda", dt)
        dys = [torch.randn(args.t, args.b, h, generator=gen).to("cuda", dt)
               for _ in range(2)]
        lengths = torch.randint(1, args.t + 1, (args.b,), generator=gen)
        lengths[0] = args.t
        lengths = lengths.to("cuda", torch.int32)
        fwd = P.gru_bidir_fwd(x, *ws, lengths, train=True)
        inputs[dt] = (x, ws[0], ws[1], ws[4], ws[5], lengths, *fwd, *dys)

    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build(cuda_lib.CSRC, name, eds, Path(tmp),
                            cuda_lib.nvcc(), cuda_lib.NVCC_FLAGS)
                for name, eds in EDITS.items()}
        for name, path in libs.items():
            cuda_lib._LIBS["gru_bidir_bwd"] = ctypes.CDLL(str(path))
            for dt, bargs in inputs.items():
                P.gru_bidir_bwd(*bargs)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    time.sleep(0.2)
                    for _ in range(5):
                        P.gru_bidir_bwd(*bargs)
                    torch.cuda.synchronize()
                us = {k: [] for k in KERNELS}
                for e in prof.events():
                    if e.device_type == torch.autograd.DeviceType.CUDA:
                        for k in KERNELS:
                            if k in e.name:
                                us[k].append(e.time_range.elapsed_us())
                ms = ", ".join(f"{k} {sum(v) / max(len(v), 1) / 1e3:.4f} ms"
                               for k, v in us.items())
                print(f"{name}: {str(dt)[6:]} B={args.b} T={args.t} "
                      f"W={args.w}: {ms}", flush=True)
    cuda_lib._LIBS.pop("gru_bidir_bwd", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
