#!/usr/bin/env python3
"""The layer forwards' recurrences in SASS, on a machine with nvcc.

    python3 tools/torch_sass.py [--other DIR]

Builds ``csrc/lstm_bidir_fwd.cu`` and ``csrc/gru_bidir_fwd.cu`` of this
checkout (``cuda_lib.NVCC_FLAGS``) and prints, for each instantiation of
their recurrence kernels (rows 3, 1 and 5: ``lstm_recur_kernel``,
``recur_kernel`` with ``SplitAddr`` and with ``MergedAddr``), how many
block barriers (``BAR.SYNC``), cluster barriers (``UCGABAR_*``),
mbarrier operations (``SYNCS``), shuffles (``SHFL``) and asynchronous
copies (``LDGSTS``) its code holds.  With ``--other DIR`` it also builds
``DIR``'s ``csrc/gru_bidir_fwd.cu`` (a checkout from before row 1's
recurrence took an addressing) and compares each of its ``recur_kernel``
instantiations, instruction by instruction with constants and addresses
masked, against this checkout's ``SplitAddr`` one of the same dtype, H and
form: the lines that differ, 0 when row 1 compiles as it did.  Exits
non-zero when a build fails, or with ``--other`` when any instantiation
differs.  Needs no card.  Imports nothing of JAX.
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
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        mine = {**sass(csrc / "lstm_bidir_fwd.cu", tmp),
                **sass(csrc / "gru_bidir_fwd.cu", tmp)}
        for fn, ops in sorted(mine.items()):
            form = FORM.search(fn)
            if not form:
                continue
            kind = ("row 3" if "lstm" in fn else
                    "row 5" if "MergedAddr" in fn else "row 1")
            counts = {op: sum(op in i for i in ops) for op in OPS}
            print(f"{kind} {form.groups()}: {len(ops)} instructions, "
                  f"{counts}")
        if args.other:
            other = sass(Path(args.other).resolve() /
                         "pytorch_video_action_tpu_torch" / "csrc" /
                         "gru_bidir_fwd.cu", tmp)
            split = {FORM.search(f).groups(): ops for f, ops in mine.items()
                     if FORM.search(f) and "SplitAddr" in f}
            for fn, ops in sorted(other.items()):
                form = FORM.search(fn)
                if not form:
                    continue
                diff = [d for d in difflib.unified_diff(
                            ops, split.get(form.groups(), []), lineterm="",
                            n=0)
                        if d[:1] in "+-" and d[:3] not in ("+++", "---")]
                bad += bool(diff)
                print(f"row 1 {form.groups()} against the other checkout: "
                      f"{len(diff)} lines differ")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
