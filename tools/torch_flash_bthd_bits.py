#!/usr/bin/env python3
"""How far the head-major flash plain versions of a checkout stand from the
``[B, H, T, d]`` ones on the inputs of ``tests/test_torch_flash_bthd.py``,
on the CPU.

    python3 tools/torch_flash_bthd_bits.py [--root DIR]

Prints the max abs difference between ``flash_fwd_bthd_ref`` /
``flash_bwd_bthd_ref`` and ``flash_fwd_ref`` / ``flash_bwd_ref`` on
transposes (``test_bthd_equals_the_bhtd_plain_versions``' inputs), and
between ``flash_bwd_bthd``'s fused and split dispatch
(``test_bthd_matches_jax_on_transposed_operands``' inputs, dropout 0 and
0.25).  0.0 when both take the same arithmetic; a CPU matmul picks its
kernel and summation order by stride, so strided and contiguous operands
may differ.  ``DIR`` is the root of the checkout to import (this one by
default).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _flat(a):  # [B, H, T, d] -> [B, T, H*d]
    b, h, t, d = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b, t, h * d).copy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)

    import numpy as np
    import torch

    from pytorch_video_action_tpu_torch.ops import flash as F

    seed = 12345
    b, h, t, d = 2, 3, 70, 16
    rng = np.random.default_rng(1)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(b, h, t, d)).astype(
        np.float32)) for _ in range(4))
    mask = torch.from_numpy(np.arange(t)[None, :] < np.array([[70], [31]]))
    out, lse, _ = F.flash_fwd_ref(q, k, v, mask, 0.3, seed)
    want = F.flash_bwd_ref(q, k, v, mask, 0.3, seed, out, lse, dout)
    fl = [torch.from_numpy(_flat(a.numpy())) for a in (q, k, v, dout)]
    bout, blse = F.flash_fwd_bthd_ref(*fl[:3], mask, h, 0.3, seed)
    got = F.flash_bwd_bthd_ref(*fl[:3], mask, h, 0.3, seed, bout, blse,
                               fl[3])
    diff = max([(bout - F._flat(out)).abs().max().item(),
                (blse - lse.reshape(b * h, t)).abs().max().item()]
               + [(g - F._flat(w)).abs().max().item()
                  for g, w in zip(got, want)])
    print(f"head-major plain versions against [B, H, T, d]: max abs {diff}")

    b, h, t, d = 2, 2, 200, 128
    rng = np.random.default_rng(0)
    q, k, v, dout = (rng.normal(size=(b, h, t, d)).astype(np.float32)
                     for _ in range(4))
    mask = rng.random((b, t)) > 0.2
    mask[-1] = False
    tq, tk, tv, tdo = (torch.from_numpy(_flat(a)) for a in (q, k, v, dout))
    tm = torch.from_numpy(mask)
    for rate in (0.0, 0.25):
        out, lse = F.flash_fwd_bthd(tq, tk, tv, tm, h, rate, seed)
        split = F.flash_bwd_bthd(tq, tk, tv, tm, h, rate, seed, out, lse, tdo,
                                 fused=False)
        fused = F.flash_bwd_bthd(tq, tk, tv, tm, h, rate, seed, out, lse, tdo,
                                 fused=True)
        diff = max((a - c).abs().max().item() for a, c in zip(split, fused))
        print(f"flash_bwd_bthd fused against split, dropout {rate}: max abs "
              f"{diff}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
