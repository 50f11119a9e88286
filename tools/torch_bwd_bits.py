#!/usr/bin/env python3
"""Whether layer kernels of this checkout give the same bits as another
checkout's, on one NVIDIA GPU.

    python3 tools/torch_bwd_bits.py --other DIR [--rows 2 1 4 6 3 12]

For each row named (default 2), builds ``DIR/pytorch_video_action_tpu_torch/
csrc/<library>.cu`` into a temporary directory and runs this checkout's
wrappers (``ops/rnn_fused.py``) with this checkout's library and with
``DIR``'s in its place (``cuda_lib.replaced``) on the same seeded inputs,
f32 and bf16 (row 12 through ``ops/rnn_scan.py``):

* row 2 and 2 alt, the GRU layer backward (``gru_bidir_bwd``): row 2 at
  the main path's shape (B=8, T=1920) and the bench shape (B=64, T=1024),
  W_in 400 and 256, row 2 alt at W_in 256 with keep 0.5;
* row 1 and 1 alt, the GRU layer forward (``gru_bidir_fwd``): the eval
  form at the serving shape (B=3, T=1280) and the train form at the
  training shape (B=8, T=1920), row 1 at W_in 400, row 1 alt at 256 with
  keep 0.5 in its train form;
* row 4, the LSTM layer backward (``lstm_bidir_bwd``), and row 6, the
  merged GRU's (``gru_merged_bwd``): at the training shape, W_in 400;
* row 3, the LSTM layer forward (``lstm_bidir_fwd``): as row 1, W_in 400;
* row 12, the GRU scan's recompute backward (``gru_scan_bwd``): at the
  training shape (B=8, T=1920), W 256 and 1024.

Prints, for each, the outputs that differ (none when every output is equal
bit for bit) and the card's name and power limit.  Exits non-zero when an
output differs or without a card.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# each row's library (csrc/<library>.cu)
LIBRARY = {"2": "gru_bidir_bwd", "1": "gru_bidir_fwd",
           "4": "lstm_bidir_bwd", "6": "gru_merged_bwd",
           "3": "lstm_bidir_fwd", "12": "gru_scan_bwd"}


def cases(row, chip_smoke, torch):
    """``(label, wrapper, arguments)`` of each input a row is held on."""
    from pytorch_video_action_tpu_torch.ops import rnn_fused as P

    gru, lstm = chip_smoke.Cell("gru"), chip_smoke.Cell("lstm")

    def inputs(cell, b, t_len, w_in, dt):
        gen = torch.Generator().manual_seed(b + w_in)
        x, ws, lengths = chip_smoke.layer_inputs(cell, t_len, b, w_in, dt,
                                                 [t_len] * b, gen)
        lengths[0] = 1
        dys = [torch.randn(t_len, b, chip_smoke.H, generator=gen)
               .to("cuda", dt) for _ in range(2)]
        return x, ws, lengths, dys

    def halves(x, w_in):
        return x[..., :w_in // 2].contiguous(), x[..., w_in // 2:].contiguous()

    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        if row == "2":
            for b, t_len in ((8, 1920), (64, 1024)):
                for w_in, alt in ((400, False), (256, False), (256, True)):
                    x, ws, lengths, dys = inputs(gru, b, t_len, w_in, dt)
                    label = (f"row 2{' alt' if alt else ''} {name} B={b} "
                             f"T={t_len} W_in={w_in}")
                    if alt:
                        xa, xb = halves(x, w_in)
                        fwd = P.gru_bidir_bnd_fwd(xa, xb, *ws, lengths, 77,
                                                  0.5, train=True)
                        yield label, P.gru_bidir_bnd_bwd, (
                            xa, xb, ws[0], ws[1], ws[4], ws[5], lengths,
                            *fwd, *dys, 77, 0.5)
                    else:
                        fwd = P.gru_bidir_fwd(x, *ws, lengths, train=True)
                        yield label, P.gru_bidir_bwd, gru.bwd_args(
                            x, ws, lengths, fwd, dys)
        elif row == "3":
            for b, t_len, train in ((3, 1280, False), (8, 1920, True)):
                form = "train" if train else "eval"
                x, ws, lengths, _ = inputs(lstm, b, t_len, 400, dt)
                yield (f"row 3 {form} {name} B={b} T={t_len} W_in=400",
                       lambda *a, t=train: P.lstm_bidir_fwd(*a, train=t),
                       (x, *ws, lengths))
        elif row == "12":
            from pytorch_video_action_tpu_torch.ops import rnn_scan as RS

            for w in (256, 1024):
                gen = torch.Generator().manual_seed(w)
                xg, wh, bh, dy, _ = chip_smoke.scan_inputs(
                    [1920] * 8, 1920, w, dt, gen, "gru")
                hp = RS._shift(RS.gru_scan_fwd(xg, wh, bh))
                yield (f"row 12 {name} B=8 T=1920 W={w}", RS.gru_scan_bwd,
                       (xg, hp, dy, wh, bh))
        elif row == "1":
            for b, t_len, train in ((3, 1280, False), (8, 1920, True)):
                form = "train" if train else "eval"
                x, ws, lengths, _ = inputs(gru, b, t_len, 400, dt)
                yield (f"row 1 {form} {name} B={b} T={t_len} W_in=400",
                       lambda *a, t=train: P.gru_bidir_fwd(*a, train=t),
                       (x, *ws, lengths))
                x, ws, lengths, _ = inputs(gru, b, t_len, 256, dt)
                xa, xb = halves(x, 256)
                # the train form at keep 0.5, the eval form without dropout
                seed, keep = (77, 0.5) if train else (None, 1.0)
                yield (f"row 1 alt {form} {name} B={b} T={t_len} W_in=256 "
                       f"keep {keep}",
                       lambda *a, t=train: P.gru_bidir_bnd_fwd(*a, train=t),
                       (xa, xb, *ws, lengths, seed, keep))
        else:
            cell = lstm if row == "4" else gru
            x, ws, lengths, dys = inputs(cell, 8, 1920, 400, dt)
            label = f"row {row} {name} B=8 T=1920 W_in=400"
            if row == "4":
                fwd = P.lstm_bidir_fwd(x, *ws, lengths, train=True)
                yield label, P.lstm_bidir_bwd, lstm.bwd_args(
                    x, ws, lengths, fwd, dys)
            else:
                mws = gru.merged_weights(ws)
                fwd = P.gru_merged_fwd(x, *mws, lengths, train=True)
                yield label, P.gru_merged_bwd, gru.merged_bwd_args(
                    x, mws, lengths, fwd, dys)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--rows", nargs="*", default=["2"], choices=list(LIBRARY),
                    help="the rows to hold: 2 (and 2 alt), 1 (and 1 alt), "
                         "4, 6, 3, 12")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_bits: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pytorch_video_action_tpu_torch.ops import cuda_lib

    print(chip_smoke.card_line(), flush=True)
    csrc = Path(args.other).resolve() / "pytorch_video_action_tpu_torch" / \
        "csrc"
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        for row in args.rows:
            lib = LIBRARY[row]
            out = Path(tmp) / f"lib{lib}.so"
            subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                            str(out), str(csrc / f"{lib}.cu")], check=True)
            other = ctypes.CDLL(str(out))
            for label, fn, fargs in cases(row, chip_smoke, torch):
                mine = fn(*fargs)
                with cuda_lib.replaced(lib, other):
                    theirs = fn(*fargs)
                torch.cuda.synchronize()
                differ = [i for i, (m, o) in enumerate(zip(mine, theirs))
                          if not torch.equal(m, o)]
                bad += bool(differ)
                print(f"{label}: outputs that differ {differ or 'none'}",
                      flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
