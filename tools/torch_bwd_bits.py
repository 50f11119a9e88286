#!/usr/bin/env python3
"""Whether the GRU layer backward of this checkout (rows 2 and 2 alt:
``csrc/gru_bidir_bwd.cu``'s dense and fused-boundary forms) gives the same
bits as another checkout's, on one NVIDIA GPU.

    python3 tools/torch_bwd_bits.py --other DIR

Builds ``DIR/pytorch_video_action_tpu_torch/csrc/gru_bidir_bwd.cu`` into a
temporary directory and runs this checkout's wrappers (``ops/rnn_fused.py``)
with this checkout's library and with ``DIR``'s in its place
(``cuda_lib.replaced``) on the same seeded inputs: row 2 at the main path's
shape (B=8, T=1920) and the bench shape (B=64, T=1024), W_in 400 and 256,
row 2 alt at W_in 256 with keep 0.5, f32 and bf16.  Prints, for each, the
outputs that differ (none when every output is equal bit for bit) and the
card's name and power limit.  Exits non-zero when an output differs or
without a card.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_bits: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pytorch_video_action_tpu_torch.ops import cuda_lib
    from pytorch_video_action_tpu_torch.ops import rnn_fused as P

    print(chip_smoke.card_line(), flush=True)
    src = (Path(args.other).resolve() / "pytorch_video_action_tpu_torch" /
           "csrc" / "gru_bidir_bwd.cu")
    cell = chip_smoke.Cell("gru")
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "libgru_bidir_bwd.so"
        subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True)
        other = ctypes.CDLL(str(out))
        for b, t_len in ((8, 1920), (64, 1024)):
            for dt in (torch.float32, torch.bfloat16):
                for w_in, alt in ((400, False), (256, False), (256, True)):
                    gen = torch.Generator().manual_seed(b + w_in)
                    x, ws, lengths = chip_smoke.layer_inputs(
                        cell, t_len, b, w_in, dt, [t_len] * b, gen)
                    lengths[0] = 1
                    dys = [torch.randn(t_len, b, chip_smoke.H,
                                       generator=gen).to("cuda", dt)
                           for _ in range(2)]
                    if alt:
                        xa, xb = (x[..., :w_in // 2].contiguous(),
                                  x[..., w_in // 2:].contiguous())
                        fwd = P.gru_bidir_bnd_fwd(xa, xb, *ws, lengths, 77,
                                                  0.5, train=True)
                        fn = P.gru_bidir_bnd_bwd
                        bargs = (xa, xb, ws[0], ws[1], ws[4], ws[5], lengths,
                                 *fwd, *dys, 77, 0.5)
                    else:
                        fwd = P.gru_bidir_fwd(x, *ws, lengths, train=True)
                        fn = P.gru_bidir_bwd
                        bargs = cell.bwd_args(x, ws, lengths, fwd, dys)
                    mine = fn(*bargs)
                    with cuda_lib.replaced("gru_bidir_bwd", other):
                        theirs = fn(*bargs)
                    torch.cuda.synchronize()
                    differ = [i for i, (m, o) in enumerate(zip(mine, theirs))
                              if not torch.equal(m, o)]
                    bad += bool(differ)
                    print(f"row 2{' alt' if alt else ''} {str(dt)[6:]} "
                          f"B={b} T={t_len} W_in={w_in}: outputs that differ "
                          f"{differ or 'none'}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
