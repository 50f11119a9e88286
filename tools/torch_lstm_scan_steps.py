#!/usr/bin/env python3
"""Where a step of the LSTM scan's eval forward (row 13,
``csrc/lstm_scan_fwd.cu``) goes: µs a step of the kernel as built and of
copies with one part of the step taken out.  On one NVIDIA GPU:

    python3 tools/torch_lstm_scan_steps.py [--root DIR] [--shapes B,T,W ...]
                                           [--builds NAME ...]

Builds ``lstm_scan_fwd.cu`` from copies of ``DIR/pytorch_video_action_tpu_
torch/csrc/`` (``DIR`` defaults to this checkout; another checkout of the
same design, for example an earlier commit unpacked with ``git archive``,
may be given) in a temporary directory: as it is, and once for each
entry of ``EDITS`` (the product taken out, the gates and cell update taken
out, the exchange of ``h`` between blocks taken out, all three).  Each
build runs ``DIR``'s ``ops/rnn_scan.lstm_scan_fwd`` on the same seeded
inputs at each shape (default: the training shape B=8, T=1920, W=256, the
serving shape B=3, T=1280, W=64 and the bench shape B=64, T=1024, W=256),
f32 and bf16, and prints its device time (CUDA events, ``chip_smoke.
cuda_ms``) as µs a step, with the card's name and power limit and each
shape's launch from ``lstm_fwd_geometry`` and the clusters the card runs
at once.  The edited builds compute wrong values and are timed only.
Exits non-zero without a card, or when the source no longer holds an
edit's lines.  ``chip_smoke.py`` takes rows 13 and 14 apart with
``start_builds``, ``finish_builds`` and ``step_us``.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# The edits (weights in registers, gates by shuffles, h sent by st.async
# onto the receiver's mbarrier, one block barrier a step only when a chain
# is one block)
_PRODUCT = ("      product<T, RM, WIDE>(wr, w_s + tid, wh,\n"
            "                           h_s + cur * RM * a.ldh + s * a.LP, a, "
            "d0, col,\n                           pre);\n",
            "#pragma unroll\n      for (int r = 0; r < RM; ++r) pre[r] = "
            "h_s[r];\n")
_GATES = [("        act[r] = g == 2 ? tanhf(p) : sigmoid_f(p);\n",
           "        act[r] = p;\n"),
          ("        c[r] = fmaf(fg, c[r], ig * gg);\n"
           "        tc[r] = tanhf(c[r]);\n"
           "        hq[r] = from_f<T>(og * tc[r]);\n",
           "        c[r] = ig + fg + gg + og;\n"
           "        tc[r] = c[r];\n"
           "        hq[r] = from_f<T>(c[r]);\n")]
# no wait, no remote store and no block barrier: the blocks run unpaced
_EXCHANGE = [("      bar_wait(bar0 + 8 * cur, ((t - 1) >> 1) & 1);\n"
              "      if (tid == 0 && t + 2 < a.Tn) bar_expect(bar0 + 8 * "
              "cur, bytes);\n", ""),
             ("              if (r < nb) send_h(dst + 4u * r * a.ldh, "
              "hv[r], bar);\n", "              (void)dst, (void)bar;\n"),
             ("    if (a.NC == 1) __syncthreads();\n", "")]
EDITS = {"no product": [_PRODUCT],
         "no gates": _GATES,
         "no exchange": _EXCHANGE,
         "skeleton": [_PRODUCT, *_GATES, *_EXCHANGE]}
SHAPES = ["8,1920,256", "3,1280,64", "64,1024,256"]


def start_builds(csrc: Path, tmp: Path, names=None) -> dict:
    """Start one nvcc a build of ``lstm_scan_fwd.cu`` (every build of
    ``EDITS``, or those named), each on an edited copy of ``csrc`` under
    ``tmp``: ``{name: (process, library)}``."""
    from pytorch_video_action_tpu_torch.ops import cuda_lib

    text = (csrc / "lstm_scan_fwd.cu").read_text()
    jobs = {}
    for name, eds in {"as is": [], **EDITS}.items():
        if names is not None and name not in names:
            continue
        d = tmp / name.replace(" ", "_")
        shutil.copytree(csrc, d)
        src = d / "lstm_scan_fwd.cu"
        edited = text
        for old, new in eds:
            if old not in edited:
                raise SystemExit(f"torch_lstm_scan_steps: lstm_scan_fwd.cu no "
                                 f"longer holds the lines the {name!r} build "
                                 f"edits")
            edited = edited.replace(old, new)
        src.write_text(edited)
        out = d / "liblstm_scan_fwd.so"
        jobs[name] = (subprocess.Popen(
            [cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    return jobs


def finish_builds(jobs: dict) -> dict:
    """Wait for ``start_builds``' compilers: ``{name: loaded library}``."""
    libs = {}
    for name, (proc, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"torch_lstm_scan_steps: nvcc failed for the "
                             f"{name!r} build:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def step_us(libs: dict, fn, args, t_len: int, timer, iters: int = 3) -> dict:
    """µs a step of ``fn(*args)`` (a wrapper of ``ops/rnn_scan.py`` that
    launches ``lstm_scan_fwd.cu``) with each build's library in its place:
    ``timer(call, iters, warmup)`` gives a call's device ms
    (``chip_smoke.cuda_ms``)."""
    from pytorch_video_action_tpu_torch.ops import cuda_lib

    out = {}
    for name, lib in libs.items():
        with cuda_lib.replaced("lstm_scan_fwd", lib):
            out[name] = timer(lambda: fn(*args), iters, 1) / t_len * 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose kernel and wrapper are timed")
    ap.add_argument("--shapes", nargs="*", default=SHAPES,
                    help="B,T,W of each shape")
    ap.add_argument("--builds", nargs="*",
                    help="names of the builds to time (default: all)")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("torch_lstm_scan_steps: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pytorch_video_action_tpu_torch.ops import rnn_scan as RS

    print(chip_smoke.card_line(), flush=True)
    print(f"kernel and wrapper of {root}", flush=True)
    csrc = root / "pytorch_video_action_tpu_torch" / "csrc"
    shapes = [tuple(int(v) for v in s.split(",")) for s in args.shapes]
    inputs = {}
    for b, t_len, w in shapes:
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator().manual_seed(0)
            xg, wh, *_ = chip_smoke.scan_inputs([t_len] * b, t_len, w, dt,
                                                gen)
            inputs[(b, t_len, w, dt)] = (xg, wh)
    for (b, t_len, w, dt), (xg, _) in inputs.items():
        fits = RS._cluster_fits(xg.device)
        geo = RS.lstm_fwd_geometry(b, w, dt, RS._sms(xg.device), fits)
        print(f"{str(dt)[6:]} B={b} W={w}: {geo}, {-(-b // geo.rows)} "
              f"chains, {fits(geo.nc)} clusters of {geo.nc} fit the card at "
              f"once", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        libs = finish_builds(start_builds(csrc, Path(tmp), args.builds))
        for (b, t_len, w, dt), (xg, wh) in inputs.items():
            got = step_us(libs, RS.lstm_scan_fwd, (xg, wh), t_len,
                          chip_smoke.cuda_ms, args.iters)
            for name, us in got.items():
                print(f"{name}: {str(dt)[6:]} B={b} T={t_len} W={w}: "
                      f"{us * t_len / 1e3:.4f} ms, {us:.4f} us a step",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
