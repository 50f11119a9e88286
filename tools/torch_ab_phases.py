#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases in two checkouts of the repo on
one card, in turns (other, this, this, other), and print their frames/s
lines side by side: the way to compare two commits end to end within one
call.

    python3 tools/torch_ab_phases.py --other DIR [PHASE ...]

``DIR`` is the root of the other checkout (for example the parent commit
unpacked with ``git archive`` into a directory ``.gitignore`` lists).  A
PHASE is ``slice:<model>`` (phase 4's serving of ``model``: bigru, bilstm
or attn; ``slice:vanilla_lstm`` is ``phase_vanilla_serving``, its training
at the inference CLIs' widths and then its serving) or ``train:<model>``
(phase 5's training of ``model``, vanilla_lstm among them) or
``wide:gru`` (phase 5's bidirectional GRU on the GRU scan: BiGRU at
``hidden_dim_1`` 512 and 192 and attn at ``hidden_dim`` 192 a Trainer
step each, the BiGRU 512 serving forward); the default is ``slice:attn
train:attn``.  Each turn is a process of its own
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
import contextlib, sys, tempfile
sys.path.insert(0, ".")
import chip_smoke as c
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.GRU, c.LSTM = c.Cell("gru"), c.Cell("lstm")
card = c.card_line()
c.phase_build()
with tempfile.TemporaryDirectory() as root, contextlib.chdir(root):
    c.write_dataset(root)
    for phase in sys.argv[1:]:
        kind, name = phase.split(":")
        if kind == "wide":
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
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("phases", nargs="*",
                    default=["slice:attn", "train:attn"])
    args = ap.parse_args(argv)
    trees = {"other": Path(args.other).resolve(), "this": ROOT}
    out = {}
    for label in ("other", "this", "this", "other"):
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
                 if "frames/s" in line and ("train step" in line
                                            or "forward" in line)]
        out.setdefault(label, []).append(lines)
    for label, turns in out.items():
        for i, lines in enumerate(turns):
            for line in lines:
                print(f"{label} turn {i + 1}: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
