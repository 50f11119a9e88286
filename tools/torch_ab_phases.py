#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases in two checkouts of the repo on
one card, in turns (other, this, this, other), and print their frames/s
lines side by side: the way to compare two commits end to end within one
call.

    python3 tools/torch_ab_phases.py --other DIR | --once [--kernels]
                                     [PHASE ...]

``DIR`` is the root of the other checkout (for example the parent commit
unpacked with ``git archive`` into a directory ``.gitignore`` lists).  A
PHASE is ``slice:<model>`` (phase 4's serving of ``model``: bigru, bilstm
or attn; ``slice:vanilla_lstm`` is ``phase_vanilla_serving``, its training
at the inference CLIs' widths and then its serving) or ``train:<model>``
(phase 5's training of ``model``, vanilla_lstm among them) or
``wide:gru`` (phase 5's bidirectional GRU on the GRU scan: BiGRU at
``hidden_dim_1`` 512, 192 and, where the checkout has it, 2048 and attn at
``hidden_dim`` 192 a Trainer step each, the BiGRU 512 serving forward) or,
lighter, ``fps:<model>`` (the serving forward's and one train epoch's
frames/s of ``model``, f32 and bf16, from a seeded checkpoint, without the
CLIs) or ``rows:gru`` (rows 1, 1 alt, 2 and 2 alt held and timed at the
main path's shapes, f32 and bf16: ``check_layer``, ``check_train_layer``,
``check_bnd_eval``, ``check_bnd_train`` at keep 0.5) or ``scan:<cell>``
(the GRU's or the LSTM's scan, its four kernels held and timed at the
largest train batch, W=256, f32 and bf16: ``check_scan``) or
``lstm:main``, ``lstm:bench`` (row 4, the LSTM layer's backward, with its
train form, ``check_train_layer``) and ``merged:main``, ``merged:bench``
(rows 5-6, the merged GRU's train form and backward,
``check_merged_train_layer``), W_in=400, f32 and bf16, at the largest train
batch or the bench shape (B=64, T=1024, every frame valid) or ``fwd:main``
(rows 3 and 5, the LSTM layer's and the merged GRU's forwards, W_in=400,
f32 and bf16: the eval forms at the largest test forward batch,
``check_layer`` and ``check_merged_layer``, the train forms at the largest
train batch, ``check_train_layer`` and ``check_merged_train_layer``, which
also hold and time rows 4 and 6) or ``chains:main`` (rows 11 and 12, the
GRU scan's backwards, held against their plain versions and timed at the
largest train batch at W = 96, 256 and 1024, and rows 3 and 7, the LSTM
layer's and the merged LSTM's forwards, W_in=400: the eval forms at the
largest test forward batch, ``check_layer`` and ``check_merged_layer``,
the train forms at the largest train batch, ``check_train_layer`` and
``check_merged_train_layer``, which also hold and time rows 4 and 8; f32
and bf16); the default is ``slice:attn train:attn``.  With ``--once``
only this checkout runs, one turn.  A turn whose phases are all light builds only the kernels
they launch.  With ``--kernels`` the phases' ``[kernel]``
and ``[flags]`` lines (each kernel's time beside its plain version's and
its bound) are printed too.  Each turn is a process of its own
that builds that checkout's kernels, writes the seeded dataset into a
temporary directory and runs the phases as ``chip_smoke.main`` does, so
each phase's own checks hold in both.  Exits non-zero without a card or
when a turn fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# one turn: the checkout's chip_smoke, its kernels built, the phases run
TURN = """
import contextlib, os, sys, tempfile
sys.path.insert(0, ".")
import chip_smoke as c
import torch
from pytorch_video_action_tpu_torch.data.dataset import VideoDataset
from pytorch_video_action_tpu_torch.infer.predict import forward_batches
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.GRU, c.LSTM = c.Cell("gru"), c.Cell("lstm")
card = c.card_line()
if any(p.split(":")[0] not in ("fps", "rows", "scan", "lstm", "merged",
                               "fwd", "chains") for p in sys.argv[1:]):
    c.phase_build()
with tempfile.TemporaryDirectory() as root, contextlib.chdir(root):
    c.write_dataset(root)
    test = VideoDataset(data_dir="data", annot_path=root, part="test",
                        split=1, mode=None, verbose=False).features
    for phase in sys.argv[1:]:
        kind, name = phase.split(":")
        if kind == "fps":
            os.makedirs(os.path.join(root, "models"), exist_ok=True)
            ckpt = c.save_checkpoint(root, name)
            c.forward_frames_per_sec(card, name, ckpt, test)
            feed, _ = c.train_feeds(root)
            for dt in c.DTYPES:
                c.train_frames_per_sec(card, name, feed, dt)
        elif kind == "rows":
            gen = torch.Generator().manual_seed(0)
            t_pad, chunk = max(forward_batches(test),
                               key=lambda tb: tb[0] * len(tb[1]))
            lens = [len(test[i]) for i in chunk]
            batch = c.largest_batch(c.train_feeds(root)[0])
            tlens, t_train = batch[1].tolist(), batch[0].shape[1]
            for dt in c.DTYPES:
                c.check_layer(c.GRU, "main path", lens, t_pad, 400, dt, gen)
                c.check_bnd_eval("main path", lens, t_pad, dt, gen)
                c.check_train_layer(c.GRU, "main path", tlens, t_train, 400,
                                    dt, gen)
                c.check_bnd_train("main path", tlens, t_train, dt, 0.5, gen)
        elif kind in ("lstm", "merged"):
            # rows 4 (the LSTM layer's) or 5-6 (the merged GRU's) train form
            # and backward, W_in=400: at the main path's largest train
            # batch (name "main") or the bench shape, every frame valid
            gen = torch.Generator().manual_seed(0)
            if name == "main":
                batch = c.largest_batch(c.train_feeds(root)[0])
                tlens, t_len = batch[1].tolist(), batch[0].shape[1]
            else:
                tlens, t_len = [c.T_BENCH] * c.B_BENCH, c.T_BENCH
            check = (c.check_train_layer if kind == "lstm" else
                     c.check_merged_train_layer)
            for dt in c.DTYPES:
                check(c.LSTM if kind == "lstm" else c.GRU, name, tlens, t_len,
                      400, dt, gen)
        elif kind == "fwd":
            # rows 3 and 5 at the main path's shapes, W_in=400
            gen = torch.Generator().manual_seed(0)
            t_pad, chunk = max(forward_batches(test),
                               key=lambda tb: tb[0] * len(tb[1]))
            lens = [len(test[i]) for i in chunk]
            batch = c.largest_batch(c.train_feeds(root)[0])
            tlens, t_train = batch[1].tolist(), batch[0].shape[1]
            for dt in c.DTYPES:
                c.check_layer(c.LSTM, "main path", lens, t_pad, 400, dt, gen)
                c.check_merged_layer(c.GRU, "main path", lens, t_pad, 400,
                                     dt, gen)
                c.check_train_layer(c.LSTM, "main path", tlens, t_train, 400,
                                    dt, gen)
                c.check_merged_train_layer(c.GRU, "main path", tlens,
                                           t_train, 400, dt, gen)
        elif kind == "chains":
            # rows 11 and 12 at the largest train batch, W = 96, 256, 1024;
            # rows 3 and 7 at the main path's shapes, W_in=400
            gen = torch.Generator().manual_seed(0)
            batch = c.largest_batch(c.train_feeds(root)[0])
            tlens, t_train = batch[1].tolist(), batch[0].shape[1]
            t_pad, chunk = max(forward_batches(test),
                               key=lambda tb: tb[0] * len(tb[1]))
            lens = [len(test[i]) for i in chunk]
            for dt in c.DTYPES:
                for w in (96, 256, 1024):
                    xg, wh, bh, dy, _ = c.scan_inputs(
                        tlens, t_train, w, getattr(torch, dt), gen, "gru")
                    calls = c.scan_calls("gru", xg, wh, bh, dy)
                    for entry in ("gru_scan_bwd_saved", "gru_scan_bwd"):
                        fn, ref, args = calls[entry]
                        got, again = fn(*args), fn(*args)
                        err = c.rel_err(got, ref(*args))[1]
                        same = all(torch.equal(a, b)
                                   for a, b in zip(got, again))
                        ms = c.cuda_ms(lambda: fn(*args), 5, 1)
                        print(f"[kernel] {entry} main path B={len(tlens)} "
                              f"T={t_train} W={w} {dt}: error {err:.3g} "
                              f"(tol {c.TOL[dt]}), rerun bit-identical "
                              f"{same}, kernel {ms:.4f} ms", flush=True)
                        if not (err <= c.TOL[dt] and same):
                            raise AssertionError(f"{entry} W={w} {dt}")
                c.check_layer(c.LSTM, "main path", lens, t_pad, 400, dt, gen)
                c.check_merged_layer(c.LSTM, "main path", lens, t_pad, 400,
                                     dt, gen)
                c.check_train_layer(c.LSTM, "main path", tlens, t_train, 400,
                                    dt, gen)
                c.check_merged_train_layer(c.LSTM, "main path", tlens,
                                           t_train, 400, dt, gen)
        elif kind == "scan":
            gen = torch.Generator().manual_seed(0)
            batch = c.largest_batch(c.train_feeds(root)[0])
            for dt in c.DTYPES:
                c.check_scan("main path", batch[1].tolist(),
                             batch[0].shape[1], 256, dt, gen, cell=name)
        elif kind == "wide":
            c.phase_gru_wide(card, root)
        elif kind == "slice" and name == "vanilla_lstm":
            c.phase_vanilla_serving(card, root)
        elif kind == "slice":
            c.phase_slice(card, root, name)
        else:
            c.phase_train(card, root, name)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--once", action="store_true",
                    help="one turn of this checkout alone")
    ap.add_argument("--kernels", action="store_true",
                    help="also print the phases' [kernel] lines")
    ap.add_argument("phases", nargs="*",
                    default=["slice:attn", "train:attn"])
    args = ap.parse_args(argv)
    if not args.once and args.other is None:
        ap.error("--other is required unless --once is given")
    trees = {"this": ROOT}
    if not args.once:
        trees["other"] = Path(args.other).resolve()
    out = {}
    for label in ("this",) if args.once else ("other", "this", "this",
                                               "other"):
        proc = subprocess.run([sys.executable, "-c", TURN, *args.phases],
                              cwd=trees[label], capture_output=True,
                              text=True, env={**os.environ,
                                              "PYTHONPATH": str(trees[label])})
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"torch_ab_phases: the {label} checkout's turn failed",
                  file=sys.stderr)
            return 1
        lines = [line for line in proc.stdout.splitlines()
                 if ("frames/s" in line and ("train step" in line
                                             or "forward" in line))
                 or (args.kernels and line.startswith(("[kernel]", "[flags]"))
                     and " ms" in line)]
        out.setdefault(label, []).append(lines)
    for label, turns in out.items():
        for i, lines in enumerate(turns):
            for line in lines:
                print(f"{label} turn {i + 1}: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
