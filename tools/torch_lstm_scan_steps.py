#!/usr/bin/env python3
"""Where a step of a recurrent kernel goes: µs a step of the kernel as
built and of copies with one part of the step taken out.  On one NVIDIA
GPU:

    python3 tools/torch_lstm_scan_steps.py [--kernel 13|9|15|1|4|3|5|11|7]
                                           [--root DIR]
                                           [--shapes B,T,W[,train] ...]
                                           [--builds NAME ...]

``--kernel`` picks the kernel by its row in ``PERF.md``: 13, the LSTM
scan's eval forward (``csrc/lstm_scan_fwd.cu``, the default); 9, the GRU
scan's eval forward (``csrc/gru_scan_fwd.cu``); 15, the LSTM scan's
saved-gates backward (``csrc/lstm_scan_bwd.cu``, the chain and dwh); 1, the
bidirectional GRU layer's forward (``csrc/gru_bidir_fwd.cu``, its
recurrence; W is H, the layer's input 400 wide, ``train`` in a shape picks
the train form, else the eval form); 4, the bidirectional LSTM layer's
backward (``csrc/lstm_bidir_bwd.cu``, its chain; W is H, the layer's input
400 wide, the whole call timed, its products off the chain included); 3,
the bidirectional LSTM layer's forward (``csrc/lstm_bidir_fwd.cu``, as row
1); 5, the merged GRU layer's forward (``PVA_RNN_SPLIT=0``: row 1's source
and edits through the ``gru_merged_fwd`` wrapper, as row 1); 11, the GRU
scan's saved-gates backward (``csrc/gru_scan_bwd.cu``, the chain, dwh and
dbh's sum, as row 15); 7, the merged LSTM layer's forward (row 3's source
and edits through the ``lstm_merged_fwd`` wrapper, as row 3).
Builds that source from copies of ``DIR/pytorch_video_action_tpu_torch/
csrc/`` (``DIR`` defaults to this checkout; another checkout of the same
design, for example an earlier commit unpacked with ``git archive``, may be
given) in a temporary directory: as it is, and once for each of the
kernel's edited builds in ``KERNELS`` (the product taken out, the gate
math taken out, the exchange between blocks or threads taken out, all of
them; rows 15 and 11 also dwh's launch taken out).  Each build runs ``DIR``'s
wrapper of the kernel (``ops/rnn_scan.py``; rows 1, 3, 4, 5 and 7
``ops/rnn_fused.py``) on
the same seeded inputs at each shape (defaults in ``KERNELS``), f32 and
bf16, and prints its device time (CUDA events, ``chip_smoke.cuda_ms``) as
µs a step, with the card's name and power limit and each shape's launch;
rows 1, 3, 5 and 7 also the device time of the build as it is by kernel (its
input projection and its recurrence, ``chip_smoke.part_ms``).  The edited builds
compute wrong values and are timed only.  Exits non-zero without a card,
or when the source no longer holds an edit's lines.  ``chip_smoke.py``
takes rows 1, 3, 5, 9, 13, 14 and 15 apart with ``start_builds``,
``finish_builds`` and ``step_us``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent.parent

# Row 13 (weights in registers, gates by shuffles, h sent by st.async onto
# the receiver's mbarrier, one block barrier a step only when a chain is
# one block)
_PRODUCT = ("      product<T, RM, WIDE>(wr, w_s + tid, wh + col, a.G,\n"
            "                           h_s + cur * RM * a.ldh + s * a.LP, a, "
            "d0, pre);\n",
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

# Row 9 (row 13's chain: its product and exchange are row 13's lines)
_G9_GATES = [("        const float act = g < 2 ? sigmoid_f(xv[r] + hg) : hg;\n",
              "        const float act = xv[r] + hg;\n"),
             ("        const float n = tanhf(xn + rg * hn);\n"
              "        hc[r] = (1.0f - zg) * n + zg * hc[r];\n",
              "        const float n = xn + rg + hn;\n"
              "        hc[r] = zg + n + hc[r];\n")]

# Row 15 (row 13's chain, a row of wh a thread; dwh on the tensor cores
# after the chain)
_L15_PRODUCT = [("      product<T, RM, WIDE, GX>(wr, w_s + tid,\n"
                 "                               wh + (size_t)unit * a.G + "
                 "g * a.W, 1,\n"
                 "                               dg_s + cur * RM * a.ldh + "
                 "goff + s * a.LP, a,\n"
                 "                               d0, pre);\n",
                 "#pragma unroll\n      for (int r = 0; r < RM; ++r) pre[r] "
                 "= dg_s[r];\n")]
_L15_GATES = [("        const float dc = dh * x.o * (1.0f - x.tc * x.tc) + "
               "dcc[r];\n"
               "        dcc[r] = dc * x.f;\n"
               "        const float d = g == 0   ? dc * x.g * x.i * (1.0f - "
               "x.i)\n"
               "                        : g == 1 ? dc * x.cp * x.f * (1.0f - "
               "x.f)\n"
               "                        : g == 2 ? dc * x.i * (1.0f - x.g * "
               "x.g)\n"
               "                                 : dh * x.tc * x.o * (1.0f - "
               "x.o);\n",
               "        const float dc = dh + x.o + x.tc + dcc[r];\n"
               "        dcc[r] = dc + x.f;\n"
               "        const float d = dc + x.g + x.i + x.cp;\n")]
_L15_EXCHANGE = [("      bar_wait(bar0 + 8 * cur, ((st - 1) >> 1) & 1);\n"
                  "      if (tid == 0 && st + 2 < a.Tn) bar_expect(bar0 + 8 * "
                  "cur, bytes);\n", ""),
                 ("              if (r < nb) send_h(dst + 4u * r * a.ldh, "
                  "dv[r], bar);\n", "              (void)dst, (void)bar;\n"),
                 ("    } else if (a.NC == 1) {\n      __syncthreads();\n"
                  "    }\n", "    }\n")]
# (both dtypes' launches of dwh in the saved-gates entry)
_L15_DWH = [("    err = rc::run_saved<float>(a, st, res, cp, dy, wh, dxg, "
             "xbuf, gx != 0);\n    if (err == cudaSuccess)\n",
             "    err = rc::run_saved<float>(a, st, res, cp, dy, wh, dxg, "
             "xbuf, gx != 0);\n    if (err == cudaSuccess && Tn < 0)\n"),
            ("                                       gx != 0);\n"
             "    if (err == cudaSuccess)\n",
             "                                       gx != 0);\n"
             "    if (err == cudaSuccess && Tn < 0)\n")]

# Row 1 (a block of 3H threads a (batch row, direction), each lane two
# columns of wh over half the depth in registers, the halves added by a
# shuffle, xg by cp.async steps ahead, r and z formed by their own lanes
# before the first of two block barriers a step)
_G1_PRODUCT = [("""#pragma unroll
    for (int k = 0; k < D; k += 4) {
      const float4 hv =
          *reinterpret_cast<const float4*>(&hq_s[half * (D + 4) + k]);
      a0 = fmaf(hv.x, w[0][k], a0);
      a0 = fmaf(hv.y, w[0][k + 1], a0);
      a0 = fmaf(hv.z, w[0][k + 2], a0);
      a0 = fmaf(hv.w, w[0][k + 3], a0);
      a1 = fmaf(hv.x, w[1][k], a1);
      a1 = fmaf(hv.y, w[1][k + 1], a1);
      a1 = fmaf(hv.z, w[1][k + 2], a1);
      a1 = fmaf(hv.w, w[1][k + 3], a1);
    }
    a0 += __shfl_xor_sync(lanes, a0, 1);
    a1 += __shfl_xor_sync(lanes, a1, 1);
""", "    a0 = hq_s[half * (D + 4)] * w[0][0];\n")]
_G1_GATES = [("      act = sigmoid_f(xv + hg);\n", "      act = xv + hg;\n"),
             ("""      const float n = tanhf(xv + r * hg);
      float hn = (1.0f - z) * n + z * hc;
""", """      const float n = xv + r + hg;
      float hn = z + n + hc;
""")]
# no block barrier: the threads run unpaced
_G1_EXCHANGE = [("    __syncthreads();  // r and z in act_s; every product has read "
                 "hq_s\n", ""),
                ("    __syncthreads();  // the new carry in hq_s\n", "")]

# Row 4 (a cluster of two blocks a (row, direction), a unit's four lanes of
# one warp, a quarter warp apart, its gate blocks, each holding wh[k, gH ..)
# in registers, the parts added by shuffles; each lane's gate factors
# formed before the step's wait; the rounded gradients sent by st.async
# onto each block's mbarrier, no cluster or block barrier a step)
_L4_PRODUCT = [("""#pragma unroll
    for (int j = 0; j < H; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(&dg_s[cb][g][j]);
      a0 = fmaf(v.x, w[j], a0);
      a1 = fmaf(v.y, w[j + 1], a1);
      a2 = fmaf(v.z, w[j + 2], a2);
      a3 = fmaf(v.w, w[j + 3], a3);
    }
""", "    a0 = dg_s[cb][g][0] * w[0];\n")]
_L4_GATES = [("""    const float fo = cur.o * (1.0f - cur.tc * cur.tc);
    const float fg = g == 0   ? cur.g * cur.i * (1.0f - cur.i)
                     : g == 1 ? cur.cp * cur.f * (1.0f - cur.f)
                     : g == 2 ? cur.i * (1.0f - cur.g * cur.g)
                              : cur.tc * cur.o * (1.0f - cur.o);
""", """    const float fo = cur.o + cur.tc;
    const float fg = cur.g + cur.i + cur.cp + cur.f;
"""),
             ("    const float dc = fmaf(dh, fo, carry_c);\n",
              "    const float dc = dh + fo + carry_c;\n"),
             ("    const float d = valid ? (g == 3 ? dh : dc) * fg : 0.0f;\n",
              "    const float d = valid ? dc + fg : 0.0f;\n")]
# no wait and no store into a block's buffer: the blocks run unpaced
_L4_EXCHANGE = [("""    if (s > 0) {
      rc::bar_wait(bar0 + 8 * cb, ((s - 1) >> 1) & 1);
      if (tid == 0 && s + 2 < Tn) rc::bar_expect(bar0 + 8 * cb, kBytes);
    }
""", ""),
                ("        rc::send_h(rc::peer_u32(slot, q), v, "
                 "rc::peer_u32(bar0 + 8 * nb, q));\n",
                 "        (void)slot, (void)v;\n")]


# Row 3 (row 4's chain run forward: a cluster of two blocks a (row,
# direction), a unit's four gate lanes of one warp, in pairs that keep two
# columns of wh over half the depth in registers; the gates meet by
# shuffles, h sent by st.async onto each block's mbarrier, xg loaded one
# step ahead)
_L3_PRODUCT = [("""#pragma unroll
    for (int j = 0; j < D; j += 4) {
      const float4 hv =
          *reinterpret_cast<const float4*>(&h_s[cur][hf * (D + 4) + j]);
      a0 = fmaf(hv.x, w[0][j], a0);
      a0 = fmaf(hv.y, w[0][j + 1], a0);
      a0 = fmaf(hv.z, w[0][j + 2], a0);
      a0 = fmaf(hv.w, w[0][j + 3], a0);
      a1 = fmaf(hv.x, w[1][j], a1);
      a1 = fmaf(hv.y, w[1][j + 1], a1);
      a1 = fmaf(hv.z, w[1][j + 2], a1);
      a1 = fmaf(hv.w, w[1][j + 3], a1);
    }
    a0 += __shfl_xor_sync(0xffffffffu, a0, 8);
    a1 += __shfl_xor_sync(0xffffffffu, a1, 8);
""", "    a0 = h_s[cur][hf * (D + 4)] * w[0][0];\n")]
_L3_GATES = [("    const float act = g == 2 ? tanhf(pre) : sigmoid_f(pre);\n",
              "    const float act = pre;\n"),
             ("""    float cn = fg * c + ig * gg;
    const float tc = tanhf(cn);
    float hn = og * tc;
""", """    float cn = ig + fg + gg + og + c;
    const float tc = cn;
    float hn = cn;
""")]
# no wait and no store into a block's buffer: the blocks run unpaced
_L3_EXCHANGE = [("""    if (s > 0) {
      rc::bar_wait(bar0 + 8 * cur, ((s - 1) >> 1) & 1);
      if (tid == 0 && s + 2 < Tn) rc::bar_expect(bar0 + 8 * cur, kBytes);
    }
""", ""),
                ("""      rc::send_h(rc::peer_u32(slot, g), to_f(hq),
                 rc::peer_u32(bar0 + 8 * nb, g));
""", "      (void)slot, (void)hq;\n")]

# Row 11 (row 15's chain with 3W gradients a row and an idle fourth lane
# group; dhg's sums for dbh; dwh on the tensor cores after the chain)
_G11_PRODUCT = [("      product<T, RM, WIDE, GX, kVec>(\n"
                 "          wr, w_s + tid, wh + (size_t)unit * G + c * a.W, 1,"
                 "\n"
                 "          dg_s + cur * RM * a.ldh + goff + s * a.LP, a, d0, "
                 "pre);\n",
                 "#pragma unroll\n      for (int r = 0; r < RM; ++r) pre[r] "
                 "= dg_s[r];\n")]
_G11_GATES = [("        const float dz = dh * (x.hp - x.n);\n"
               "        const float dn = dh * (1.0f - x.z) * (1.0f - x.n * "
               "x.n);\n"
               "        dzc[r] = dh * x.z;\n"
               "        const float d = g == 0   ? dn * x.hn * x.r * (1.0f - "
               "x.r)\n"
               "                        : g == 1 ? dz * x.z * (1.0f - x.z)\n"
               "                        : g == 2 ? dn\n"
               "                                 : dn * x.r;\n",
               "        const float dz = dh + x.hp + x.n;\n"
               "        dzc[r] = dh + x.z;\n"
               "        const float d = dz + x.hn + x.r;\n")]
# no wait and no remote store: the blocks run unpaced
_G11_EXCHANGE = [("      bar_wait(bar0 + 8 * cur, ((st - 1) >> 1) & 1);\n"
                  "      if (tid == 0 && st + 2 < a.Tn) bar_expect(bar0 + 8 * "
                  "cur, bytes);\n", ""),
                 ("              if (r < nb) send_h(dst + 4u * r * a.ldh, "
                  "to_f(dq[r]), bar);\n",
                  "              (void)dst, (void)bar;\n")]
_G11_DWH = [("  if (err != cudaSuccess) return err;\n"
             "  err = launch_scan_dwh<T>(",
             "  if (err != cudaSuccess || a.Tn > 0) return err;\n"
             "  err = launch_scan_dwh<T>(")]

class Kernel(NamedTuple):
    """A kernel the tool takes apart: its source (and library) name under
    ``csrc/``, its wrapper in ``ops/<module>.py``, the edited builds and
    the default shapes (``B,T,W``, rows 1 and 4 ``B,T,H[,train]``)."""
    source: str
    wrapper: str
    edits: dict
    shapes: list
    module: str = "rnn_scan"


KERNELS = {
    "13": Kernel("lstm_scan_fwd", "lstm_scan_fwd",
                 {"no product": [_PRODUCT], "no gates": _GATES,
                  "no exchange": _EXCHANGE,
                  "skeleton": [_PRODUCT, *_GATES, *_EXCHANGE]},
                 ["8,1920,256", "3,1280,64", "64,1024,256"]),
    "9": Kernel("gru_scan_fwd", "gru_scan_fwd",
                {"no product": [_PRODUCT], "no gates": _G9_GATES,
                 "no exchange": _EXCHANGE,
                 "skeleton": [_PRODUCT, *_G9_GATES, *_EXCHANGE]},
                ["8,1920,256", "3,1280,256"]),
    "15": Kernel("lstm_scan_bwd", "lstm_scan_bwd_saved",
                 {"no product": _L15_PRODUCT, "no gates": _L15_GATES,
                  "no exchange": _L15_EXCHANGE, "no dwh": _L15_DWH,
                  "skeleton": [*_L15_PRODUCT, *_L15_GATES, *_L15_EXCHANGE,
                               *_L15_DWH]},
                 ["8,1920,256", "64,1024,256"]),
    "1": Kernel("gru_bidir_fwd", "gru_bidir_fwd",
                {"no product": _G1_PRODUCT, "no gates": _G1_GATES,
                 "no exchange": _G1_EXCHANGE,
                 "skeleton": [*_G1_PRODUCT, *_G1_GATES, *_G1_EXCHANGE]},
                ["3,1280,128", "8,1920,128,train"], "rnn_fused"),
    "4": Kernel("lstm_bidir_bwd", "lstm_bidir_bwd",
                {"no product": _L4_PRODUCT, "no gates": _L4_GATES,
                 "no exchange": _L4_EXCHANGE,
                 "skeleton": [*_L4_PRODUCT, *_L4_GATES, *_L4_EXCHANGE]},
                ["8,1920,128", "64,1024,128"], "rnn_fused"),
    "3": Kernel("lstm_bidir_fwd", "lstm_bidir_fwd",
                {"no product": _L3_PRODUCT, "no gates": _L3_GATES,
                 "no exchange": _L3_EXCHANGE,
                 "skeleton": [*_L3_PRODUCT, *_L3_GATES, *_L3_EXCHANGE]},
                ["3,1280,128", "8,1920,128,train"], "rnn_fused"),
    # row 5: row 1's recurrence with the merged body's addressing
    "5": Kernel("gru_bidir_fwd", "gru_merged_fwd",
                {"no product": _G1_PRODUCT, "no gates": _G1_GATES,
                 "no exchange": _G1_EXCHANGE,
                 "skeleton": [*_G1_PRODUCT, *_G1_GATES, *_G1_EXCHANGE]},
                ["3,1280,128", "8,1920,128,train"], "rnn_fused"),
    "11": Kernel("gru_scan_bwd", "gru_scan_bwd_saved",
                 {"no product": _G11_PRODUCT, "no gates": _G11_GATES,
                  "no exchange": _G11_EXCHANGE, "no dwh": _G11_DWH,
                  "skeleton": [*_G11_PRODUCT, *_G11_GATES, *_G11_EXCHANGE,
                               *_G11_DWH]},
                 ["8,1920,256", "8,1920,1024"]),
    # row 7: row 3's recurrence with the merged body's addressing
    "7": Kernel("lstm_bidir_fwd", "lstm_merged_fwd",
                {"no product": _L3_PRODUCT, "no gates": _L3_GATES,
                 "no exchange": _L3_EXCHANGE,
                 "skeleton": [*_L3_PRODUCT, *_L3_GATES, *_L3_EXCHANGE]},
                ["3,1280,128", "8,1920,128,train"], "rnn_fused"),
}
# the layer kernels' input width (layer 0's); the layer forwards' (rows 1,
# 3 and 5) device time by kernel
LAYER_W_IN = 400
LAYER_FWDS = ("1", "3", "5", "7")
LAYER_PARTS = {"proj_kernel": "projection", "recur_kernel": "recurrence"}


def edited_source(text: str, kernel: str, name: str) -> str:
    """``text`` (the kernel's source) with the edits of build ``name``;
    raises SystemExit when an edit's lines are not in it."""
    for old, new in KERNELS[kernel].edits.get(name, []):
        if old not in text:
            raise SystemExit(f"torch_lstm_scan_steps: "
                             f"{KERNELS[kernel].source}.cu no longer holds "
                             f"the lines the {name!r} build edits")
        text = text.replace(old, new)
    return text


def start_builds(csrc: Path, tmp: Path, names=None, kernel: str = "13"
                 ) -> dict:
    """Start one nvcc a build of the kernel's source (as it is and every
    build of its edits, or those named), each on an edited copy of
    ``csrc`` under ``tmp``: ``{name: (process, library)}``."""
    from pytorch_video_action_tpu_torch.ops import cuda_lib

    source = KERNELS[kernel].source
    text = (csrc / f"{source}.cu").read_text()
    jobs = {}
    for name in ["as is", *KERNELS[kernel].edits]:
        if names is not None and name not in names:
            continue
        d = tmp / f"{kernel}_{name.replace(' ', '_')}"
        shutil.copytree(csrc, d)
        src = d / f"{source}.cu"
        src.write_text(edited_source(text, kernel, name))
        out = d / f"lib{source}.so"
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


def step_us(libs: dict, fn, args, t_len: int, timer, iters: int = 3,
            kernel: str = "13") -> dict:
    """µs a step of ``fn(*args)`` (a wrapper of ``ops/rnn_scan.py`` that
    launches the kernel's source) with each build's library in its place:
    ``timer(call, iters, warmup)`` gives a call's device ms
    (``chip_smoke.cuda_ms``)."""
    from pytorch_video_action_tpu_torch.ops import cuda_lib

    out = {}
    for name, lib in libs.items():
        with cuda_lib.replaced(KERNELS[kernel].source, lib):
            out[name] = timer(lambda: fn(*args), iters, 1) / t_len * 1e3
    return out


def kernel_call(kernel, chip_smoke, b, t_len, w, dt, train=False):
    """``(wrapper, its seeded arguments on the card)`` at one shape."""
    import functools
    import importlib

    import torch

    mod = importlib.import_module(
        f"pytorch_video_action_tpu_torch.ops.{KERNELS[kernel].module}")
    fn = getattr(mod, KERNELS[kernel].wrapper)
    gen = torch.Generator().manual_seed(0)
    if kernel in LAYER_FWDS:  # a layer forward, row 5 on the merged body
        cell = chip_smoke.Cell("lstm" if kernel in ("3", "7") else "gru")
        x, ws, lengths = chip_smoke.layer_inputs(cell, t_len, b, LAYER_W_IN,
                                                 dt, [t_len] * b, gen)
        if kernel in ("5", "7"):
            ws = cell.merged_weights(ws)
        return functools.partial(fn, train=train), (x, *ws, lengths)
    if kernel == "4":  # the backward of the train form's outputs
        cell = chip_smoke.Cell("lstm")
        x, ws, lengths = chip_smoke.layer_inputs(cell, t_len, b, LAYER_W_IN,
                                                 dt, [t_len] * b, gen)
        dys = [torch.randn(t_len, b, w, generator=gen).to("cuda", dt)
               for _ in range(2)]
        fwd = cell.fwd(x, *ws, lengths, train=True)
        return fn, cell.bwd_args(x, ws, lengths, fwd, dys)
    return fn, kernel_args(kernel, chip_smoke, b, t_len, w, dt, gen)


def kernel_args(kernel, chip_smoke, b, t_len, w, dt, gen):
    """A scan wrapper's seeded arguments on the card at one shape."""
    from pytorch_video_action_tpu_torch.ops import rnn_scan as RS

    cell = "gru" if kernel in ("9", "11") else "lstm"
    xg, wh, bh, dy, _ = chip_smoke.scan_inputs([t_len] * b, t_len, w, dt,
                                               gen, cell)
    if kernel == "9":
        return xg, wh, bh
    if kernel == "11":
        ys, res = RS.gru_scan_fwd_save(xg, wh, bh)
        return res, RS._shift(ys), dy, wh
    if kernel == "13":
        return xg, wh
    ys, cs, res = RS.lstm_scan_fwd_save(xg, wh)
    return res, RS._shift(ys), RS._shift(cs), dy, wh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="13", choices=sorted(KERNELS),
                    help="the kernel's row: 13, 9, 15, 1, 4, 3, 5, 11 or 7")
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose kernel and wrapper are timed")
    ap.add_argument("--shapes", nargs="*",
                    help="B,T,W of each shape (default: the kernel's)")
    ap.add_argument("--builds", nargs="*",
                    help="names of the builds to time (default: all)")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    kern = KERNELS[args.kernel]

    import torch

    if not torch.cuda.is_available():
        print("torch_lstm_scan_steps: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pytorch_video_action_tpu_torch.ops import rnn_scan as RS

    print(chip_smoke.card_line(), flush=True)
    print(f"row {args.kernel} ({kern.source}.cu): kernel and wrapper of "
          f"{root}", flush=True)
    csrc = root / "pytorch_video_action_tpu_torch" / "csrc"
    shapes = [(*(int(v) for v in s.split(",")[:3]), s.endswith(",train"))
              for s in (args.shapes or kern.shapes)]
    inputs = {}
    for b, t_len, w, train in shapes:
        for dt in (torch.float32, torch.bfloat16):
            inputs[(b, t_len, w, train, dt)] = kernel_call(
                args.kernel, chip_smoke, b, t_len, w, dt, train)
            device = inputs[(b, t_len, w, train, dt)][1][0].device
            if args.kernel in LAYER_FWDS:
                geo = ("train form" if train else "eval form") + (
                    f", W_in={LAYER_W_IN}")
            elif args.kernel == "4":
                geo = f"backward, W_in={LAYER_W_IN}"
            elif hasattr(RS, "scan_launch"):
                geo = RS.scan_launch(kern.wrapper, b, w, dt, device)
            elif kern.wrapper.startswith("lstm_scan_fwd"):  # an older tree
                geo = RS.lstm_fwd_geometry(b, w, dt, RS._sms(device),
                                           RS._cluster_fits(device))
            else:  # a checkout from before the chains took rows 9 and 15
                geo = f"cluster of {RS.cluster_size(w)}"
            print(f"{str(dt)[6:]} B={b} W={w}: {geo}", flush=True)

    from pytorch_video_action_tpu_torch.ops import cuda_lib

    with tempfile.TemporaryDirectory() as tmp:
        libs = finish_builds(start_builds(csrc, Path(tmp), args.builds,
                                          args.kernel))
        for (b, t_len, w, train, dt), (fn, call_args) in inputs.items():
            form = " train" if train else ""
            got = step_us(libs, fn, call_args, t_len, chip_smoke.cuda_ms,
                          args.iters, args.kernel)
            for name, us in got.items():
                print(f"{name}: {str(dt)[6:]} B={b} T={t_len} W={w}{form}: "
                      f"{us * t_len / 1e3:.4f} ms, {us:.4f} us a step",
                      flush=True)
            if args.kernel in LAYER_FWDS and "as is" in libs:
                with cuda_lib.replaced(kern.source, libs["as is"]):
                    parts = chip_smoke.part_ms(lambda: fn(*call_args),
                                               parts=LAYER_PARTS)
                print(f"as is by kernel: {str(dt)[6:]} B={b} T={t_len} "
                      f"W={w}{form}: {chip_smoke.parts_text(parts)}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
