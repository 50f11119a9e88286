#!/usr/bin/env python3
"""The recurrences in SASS, on a machine with nvcc.

    python3 tools/torch_sass.py [--other DIR]

Builds ``csrc/lstm_bidir_fwd.cu``, ``csrc/gru_bidir_fwd.cu`` and
``csrc/gru_scan_bwd.cu`` of this checkout (``cuda_lib.NVCC_FLAGS``) and
prints, for each instantiation of the layer forwards' recurrence kernels
(rows 3 and 7: ``lstm_recur_kernel`` with ``SplitAddr`` and with
``MergedAddr``; rows 1 and 5: ``recur_kernel`` the same) and of the GRU
scan's saved-gates backward chain (row 11: ``gru_scan_bwd_saved_kernel``,
by dtype, rows, rounds and gx), how many block barriers (``BAR.SYNC``),
cluster barriers (``UCGABAR_*``), mbarrier operations (``SYNCS``),
shuffles (``SHFL``) and asynchronous copies (``LDGSTS``) its code holds: a
kernel whose only cluster barrier is its set-up's holds one of each
``UCGABAR_*`` (row 11's also where its block and cluster barriers and its
mbarrier operations stand, by instruction index).  With ``--other DIR``
it also builds ``DIR``'s ``csrc/gru_bidir_fwd.cu`` and
``csrc/lstm_bidir_fwd.cu`` (a checkout from before the recurrences took
an addressing, or after) and compares each of
their split layers' recurrence instantiations, instruction by instruction
with constants and addresses masked, against this checkout's
``SplitAddr`` one of the same kernel, dtype, H and form: the lines that
differ, 0 when rows 1 and 3 compile as they did.  Exits non-zero when a
build fails, or with ``--other`` when any instantiation differs.  Needs no
card.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import difflib
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OPS = ("BAR.SYNC", "UCGABAR_ARV", "UCGABAR_WAIT", "SYNCS", "SHFL", "LDGSTS")
# dtype, H and form of a recurrence instantiation's mangled name
FORM = re.compile(r"recur_kernelI(f|13__nv_bfloat16)Li(\d+)ELb(\d)E")
# dtype, rows, rounds and gx of row 11's chain's
CHAIN = re.compile(r"gru_scan_bwd_saved_kernelI(f|13__nv_bfloat16)Li(\d+)"
                   r"ELb(\d)ELb(\d)E")


def sass(source: Path, tmp: str) -> dict:
    """``{function: [instructions]}`` of ``source`` built into ``tmp``."""
    sys.path.insert(0, str(ROOT))
    from pytorch_video_action_tpu_torch.ops import cuda_lib

    out = os.path.join(tmp, f"{source.parent.parent.parent.name}_"
                            f"{source.stem}.so")
    subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-o", out,
                    str(source)], check=True)
    tool = os.path.join(os.path.dirname(cuda_lib.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", out], capture_output=True,
                          text=True, check=True).stdout
    funcs, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            funcs[fn] = []
        elif fn and "/*" in line and ";" in line:
            op = line.split("*/", 1)[1].split(";")[0].strip()
            funcs[fn].append(re.sub(r"0x[0-9a-f]+", "#", op))
    return funcs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="root of a checkout to compare row 1 "
                                    "against")
    args = ap.parse_args(argv)
    csrc = ROOT / "pytorch_video_action_tpu_torch" / "csrc"
    layers = {"lstm_bidir_fwd": ("row 3", "row 7"),
              "gru_bidir_fwd": ("row 1", "row 5")}
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        mine = {src: sass(csrc / f"{src}.cu", tmp) for src in layers}
        for src, (split_row, merged_row) in layers.items():
            for fn, ops in sorted(mine[src].items()):
                form = FORM.search(fn)
                if not form:
                    continue
                kind = merged_row if "MergedAddr" in fn else split_row
                counts = {op: sum(op in i for i in ops) for op in OPS}
                print(f"{kind} {form.groups()}: {len(ops)} instructions, "
                      f"{counts}")
        for fn, ops in sorted(sass(csrc / "gru_scan_bwd.cu", tmp).items()):
            form = CHAIN.search(fn)
            if form:
                counts = {op: sum(op in i for i in ops) for op in OPS}
                # where the barriers stand against the mbarrier operations
                # (set-up's init and expects, the step's wait and expect)
                at = {op: [n for n, i in enumerate(ops) if op in i]
                      for op in ("BAR.SYNC", "UCGABAR_WAIT", "SYNCS")}
                print(f"row 11 (dtype, rows, rounds, gx) {form.groups()}: "
                      f"{len(ops)} instructions, {counts}, at {at}")
        for src, (split_row, _) in (layers.items() if args.other else ()):
            other = sass(Path(args.other).resolve() /
                         "pytorch_video_action_tpu_torch" / "csrc" /
                         f"{src}.cu", tmp)
            split = {FORM.search(f).groups(): ops
                     for f, ops in mine[src].items()
                     if FORM.search(f) and "MergedAddr" not in f}
            for fn, ops in sorted(other.items()):
                form = FORM.search(fn)
                if not form or "MergedAddr" in fn:
                    continue
                diff = [d for d in difflib.unified_diff(
                            ops, split.get(form.groups(), []), lineterm="",
                            n=0)
                        if d[:1] in "+-" and d[:3] not in ("+++", "---")]
                bad += bool(diff)
                print(f"{split_row} {form.groups()} against the other "
                      f"checkout: {len(diff)} lines differ")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
