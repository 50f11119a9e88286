#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: a CUDA card must be present; prints its name and power limit
   and turns TF32 off for matmul and cuDNN.
2. build: compiles every kernel under ``pytorch_video_action_tpu_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, all started together, beside
   the step-split builds of ``tools/torch_lstm_scan_steps.py`` for rows 13,
   9, 15, 1 and 3; row 5 times row 1's) and prints the build time and
   ``-Xptxas -v`` (and, for each flash kernel
   and each of the layer backwards' product kernels, its registers,
   spills and any wgmma serialization); checks with ``cuobjdump -sass``
   that the flash forward, the fused backward, the split backward's two
   kernels, the two product kernels of the GRU layer's, the LSTM layer's
   and the merged GRU's backwards (rows 2, 4, 6) and both scans'
   backwards' dwh (rows 15-16, 11) issue wgmma (HGMMA) in every
   instantiation, f32 and bf16.
3. kernels: holds each kernel against its plain PyTorch version on the card
   at the bench shape (B=64, T=1024, where bench.py times bigru and
   bilstm), for layer 0 (W_in=400) and the later layers (256) in f32 and
   bf16: the GRU and the LSTM layer's forward in its eval and train forms
   and its backward.  Times kernel, plain version and a one-call PyTorch
   yardstick (nn.GRU or nn.LSTM on a packed sequence: its forward, its
   forward with autograd on, and ``torch.autograd.grad`` through it) with
   CUDA events, beside each kernel's bound; the backwards (rows 2 and 4)
   also by part (their products, the slices' sum, the chain and the bias
   sums, from ``torch.profiler``) and beside their bounds counted as
   before their products moved to the tensor cores.  Rows 4 and 6 (the
   merged GRU's backward, with its train form) also at the bench shape
   with every frame valid, their K slices at their deepest.  Then the
   flash kernels at
   attn's bench shape (B=4, H=4, T=4096, d=100, bench.py): the forward in
   f32 and bf16 with dropout off and on, the fused and the split backward
   likewise, each against the plain version, the two backwards
   against each other and against a rerun (bit for bit); the times of
   each kernel's wrapper, the plain version and the yardstick
   (``scaled_dot_product_attention`` with the key mask, dropout 0, and
   ``autograd.grad`` through it) from CUDA events.  Then MS-TCN's conv
   kernels at ms_tcn's bench shape (B=8, T=4096, every frame valid,
   bench.py): the dilated residual layer's forward in its train form (the
   global dropout stream), eval form and per-video form, its backward at
   dropout 0.5 and 0 (each rerun, bit for bit), at d < T, d = T-1, d = T
   and d >> T, and the 20-layer stage at keep 1 and 0.5, in f32 and bf16;
   each beside its plain version, its bound and a cuDNN yardstick (per
   layer ``F.conv1d`` dilated conv -> relu -> 1x1 ``F.conv1d`` ->
   residual and mask, TF32 off; ``autograd.grad`` through it for the
   backward).  Then the flash kernels at d > 128 (attn with 2 heads, d=200,
   and 1 head, d=400, at attn's serving shape B=3, T=1280): the forward
   and both backwards in f32 and bf16 (the backwards with dropout off and
   on), each against the plain version.
   Then the LSTM scan's four kernels (the eval and saving forwards, the
   saved-gates and the recompute backward) at an odd width (W=100) and one
   past a block's registers (W=512), B=8, T=1920, f32, at the bench
   shape (B=64, T=1024, W=256) in f32 and bf16, and at W=8192 (B=3,
   T=32, f32: the backwards' gradients in device memory, past where one
   row's pass the shared memory): each against its plain
   version and a rerun, the eval form's ys and cs against the saving
   form's (bit for bit), timed beside nn.LSTM (one direction, packed) and
   its bound (the saved-gates backwards' with dwh on the tensor cores,
   ``tc_bound``, its SIMT count beside), each chain kernel's geometry
   logged; the two forwards and the saved-gates backward at the bench
   shape, and at the training and serving shapes in phases 4-5, also by
   step part (µs a step of each step-split build, ``step_us``).  Then the
   GRU scan's four kernels the
   same way (beside nn.GRU) at an odd width (W=96) and W=512, B=8, T=1920,
   at the serving shape B=3, T=1280, W=256, at W=2048 (B=3, T=128: the
   backwards' one-row chains), in f32 and bf16, and at W=12000 (B=2,
   T=16, f32: their gradients in device memory).  The GRU and LSTM layer
   forwards (rows 1 and 3, eval and train forms) are also timed by kernel
   (their input projection and their recurrence, ``part_ms``) wherever
   they are held; row 1 at bigru's serving and training shapes in phases
   4-5 also by step part (``step_us``), row 3 at bilstm's training shape
   in f32.
4. serving: writes a seeded Breakfast-shaped dataset (48 train, 24 dev, 24
   test videos) and full-width bigru, bilstm and attn checkpoints into a
   temporary directory.  For each model: repeats phase 3's forward checks
   at the largest forward batch the slice gives the kernel (attn: the
   largest padded to T >= 1024), runs the port's inference CLI on the card
   (test CSV and dev accuracy, f32 and bf16), checks the launch counts of
   every kernel and the CSV, runs the CLI once on the CPU to compare
   labels, and prints the forward's frames/s.  Then trains ms_tcn (as
   phase 5 does the others), copies its ``ms_tcn_*`` checkpoint to
   ``mstcn_*``, the inference CLIs' name for it, and serves it the same
   way (the stage kernel held at the largest forward batch; four stage
   launches a forward batch).  Then trains vanilla_lstm (as phase 5 does
   the others, at the train CLI's defaults: H=256, 2 layers, dropout 0.5;
   its scan kernels held first at the largest train batch, B=8, T=1920;
   plus one step with the recompute backward, its gradients against the
   saved-gates step's, and one step at ``--lstm_hidden1 1024``, its
   gradients against the CPU), trains it again at the inference CLIs' defaults
   (H=64, 1 layer, dropout 0), serves that checkpoint the same way (the
   eval form held at the largest forward batch, B=3, T=1280); trains
   simple_fc (as phase 5 does the others; its f32 run without ``--model``,
   the train CLI's default) and serves its checkpoint the same way (no
   kernel); then serves the six checkpoints as one ensemble on the card.
5. training: for bigru, bilstm and attn, repeats phase 3's train-form and
   backward checks at the largest train batch (attn's two backwards also
   at each other padded length of its flash path, f32 and bf16: 1024 and
   1152, which the dispatch sends to the fused form, and 1536, which it
   sends to the split), runs the port's train CLI
   on the card (2 epochs, batch 8, f32 and bf16), checks the launch counts
   of every kernel (per step one train-form forward and one backward per
   layer and, for attn at padded T >= 1024, one flash forward and one
   flash backward; per dev batch one eval-form forward per layer and the
   flash forward; for ms_tcn per step 80 layer forwards and 80 layer
   backwards, per dev batch 4 stage launches, its layer forward and
   backward held first at the largest train batch), that the loss is
   finite and falls from epoch 1 to 2,
   and that the inference CLI serves the checkpoint; holds one train
   step's gradients on the card against the same step on the CPU (attn on
   its dense and its flash path); prints the train step's frames/s.  Then
   trains win_attn (f32) the same way, and bilstm_lm with the CLI (2
   epochs, f32): launch counts, falling loss, and a checkpoint that holds
   its BatchNorm state (``__state__/`` keys).  bilstm also takes one step
   at ``--lstm_hidden1 512`` (H=256, through the LSTM scan: launch counts,
   and its gradients against the CPU's), attn's gradients are held against
   the CPU at ``--attn_head`` 2 and 1 on the flash path, and ms_tcn's
   gradient of ``stages.1.layers.12.conv_dilated.w`` on the card and on
   the CPU against a float64 step (its side taps exactly 0).  ctcloss
   trains like bigru (CTC loss, blank = class 48; its checkpoint, if the
   dev accuracy rises above 0, loads).  Last, the bidirectional GRU at
   widths the fused layer kernel refuses, on the GRU scan: its four
   kernels held at the largest train batch (W=256, the batch's own
   lengths, f32 and bf16; the eval form also by step part); one Trainer
   step each of BiGRU at
   ``hidden_dim_1`` 512, 192 and 2048 (H=1024, the scan past the 768 it
   once stopped at) and attn at ``hidden_dim`` 192 (launch counts,
   gradients against the CPU within 1e-3 of each tensor's largest
   element, frames/s), one BiGRU 512 step with
   the recompute backward against the saved-gates step, and the BiGRU
   512 eval forward over the test videos (launch counts, frames/s).
6. the ``PVA_RNN_SPLIT=0`` route (``rnn_fused.SPLIT`` set to False for
   the phase, restored after it): the merged-body layer kernels (rows
   5-8) held at the main path's shapes, the eval forms at the largest
   test forward batch (W_in=400), the train forms and backwards at the
   largest train batch (W_in 400 and 256), f32 and bf16 (row 6 by part,
   rows 5 and 7 by kernel, row 5's train form at W_in=400 in f32 also by
   step part), each against its
   plain version, against rows 1-4 on the same weights (ys bit for bit,
   as rows 5 and 7 run rows 1's and 3's recurrences; dx, dwi and
   the diagonal blocks of dwh2, dbi2, dbh2 against the per-direction
   gradients) and, the backwards, against a rerun (bit for bit), timed
   beside its plain version, its bound and nn.GRU / nn.LSTM packed; then
   bigru (f32 and bf16) and bilstm (f32) trained 2 epochs by the train
   CLI and their checkpoints served by the inference CLI (launch counts
   with rows 5-8 counted and rows 1-4 at 0, falling loss, labels against
   the CPU's, frames/s); one step each of bigru, bilstm, attn on its dense
   and its flash path, ctcloss and bilstm_lm (on its 40-100-frame
   videos), with launch counts and gradients against the CPU.
7. JAX's two remaining flags, each set for its half of the phase and
   restored after it.  ``PVA_RNN_FUSED_BOUNDARY=1``
   (``rnn_fused.FUSED_BOUNDARY``): the GRU layer's fused-boundary forms
   (rows 1 alt and 2 alt, W = 2H = 256) held at the main path's shapes,
   the eval form at the largest test forward batch (dropout off), the
   train form and the backward at the largest train batch at keep 0.5 and
   0.7 and at the bench shape at keep 0.5, f32 and bf16 (the backward also
   by part), each against its plain version and against rows 1-2
   on the glue-built input (the halves' gradients against the glue's
   autograd; bit for bit), the backward rerun bit for bit, timed beside
   its plain version, nn.GRU packed, its bound and rows 1 or 2 plus the
   glue they replace; bigru trained 2 epochs by the train CLI (f32, bf16)
   and served (launch counts: layer 0 on rows 1-2, layers 1-3 on rows 1-2
   alt; falling loss; labels against the CPU's; frames/s); one bigru step
   on the card against the glue route's, loss and every gradient bit for
   bit; one step each of bigru and ctcloss against the CPU; train frames/s
   with the flag on and off.  ``PVA_FLASH_BTHD=1``: the head-major flash
   forms (rows 17 alt and 18 alt, attn's d=100 folded to 128) at attn's
   serving shape and its train batches padded to 1024-1535, f32 and bf16,
   dropout 0.3, against their plain versions and against rows 17-20 on
   the ``[B, H, T, d]`` transposes (bit for bit), reruns bit for bit,
   timed beside the plain version, SDPA and the bound at d=128 and 100;
   attn trained 2 epochs (f32) and served (launch counts with rows 17-18
   at 0, rows 19-20 behind transposes for the split batches); one step
   each of attn at 4 and at 2 heads (d 200 -> 256) against the CPU on the
   flash path; train frames/s with the flag on and off.

Each phase logs its time.  Prints a ``kernels`` JSON line (thirty-two
entries for the twenty-three ported TPU kernels, rows 1, 3, 5 and 7 in
their eval and train forms, and the four alternate forms, row 1 alt in
both; headline numbers at the main path's shape, every checked shape
under ``shapes``), the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

B_BENCH, T_BENCH = 64, 1024  # the shape bench.py times bigru and bilstm at
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
DTYPES = ("float32", "bfloat16")
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM, dense
TF32_FLOPS = 495e12  # the tensor cores' TF32 peak, dense (flash_bound)
PEAK_BYTES = 3.35e12
CSRC = "pytorch_video_action_tpu_torch/csrc/"
PALLAS = "pytorch_video_action_tpu/ops/rnn_fused_pallas.py:"
H = 128  # hidden_dim_1 256 = 2 directions x 128, bigru and bilstm alike
# attn: E=400 over 4 heads; bench.py:72-77 times its train step at B=4,
# T=4096, every frame valid; post-softmax dropout 0.3
ATTN_H, ATTN_D = 4, 100
B_ATTN, T_ATTN = 4, 4096
ATTN_RATE = 0.3
# attn's serving main path (the largest forward batch padded to T >= 1024)
WIDE_T, WIDE_LENGTHS = 1280, [1280, 1100, 1024]
FLASH_PALLAS = "pytorch_video_action_tpu/ops/flash_pallas.py:"
# the flash entries of the kernels line (each a wrapper of ops/flash.py):
# source and the TPU kernel's line in flash_pallas.py
FLASH = {"flash_fwd": ("flash_fwd.cu", "166"),
         "flash_bwd_fused": ("flash_bwd.cu", "375"),
         "flash_bwd_dkdv": ("flash_bwd.cu", "331"),
         "flash_bwd_dq": ("flash_bwd.cu", "520")}
# the alternate forms' entries of the kernels line (phase 7): the GRU
# layer's fused-boundary pair (wrappers of ops/rnn_fused.py, the TPU form's
# line in rnn_fused_pallas.py) and flash's head-major pair (wrappers of
# ops/flash.py, the bthd form's line in flash_pallas.py)
BND = {"gru_bidir_bnd_fwd": ("gru_bidir_fwd.cu", PALLAS + "1578"),
       "gru_bidir_bnd_fwd_train": ("gru_bidir_fwd.cu", PALLAS + "1578"),
       "gru_bidir_bnd_bwd": ("gru_bidir_bwd.cu", PALLAS + "1607")}
BTHD = {"flash_fwd_bthd": ("flash_fwd.cu", FLASH_PALLAS + "249"),
        "flash_bwd_fused_bthd": ("flash_bwd.cu", FLASH_PALLAS + "428")}
BTHD_D = 128  # attn's head width 100 as the fold pads it
BND_KEEPS = (0.5, 0.7)  # bigru's dropout and a keep whose scale rounds


class Cell:
    """One recurrent cell's layer kernels, as the checks below use them:
    the wrappers and plain versions of ``ops/rnn_fused.py``, the weights'
    shapes, the nn.GRU / nn.LSTM yardstick and the bounds."""

    def __init__(self, name: str):
        from pytorch_video_action_tpu_torch.ops import rnn_fused

        self.name = name
        self.lstm = name == "lstm"
        self.n_gates = 4 if self.lstm else 3
        self.n_res = 5 if self.lstm else 4  # residual width per step, in H
        self.fwd_name = f"{name}_bidir_fwd"
        self.bwd_name = f"{name}_bidir_bwd"
        self.fwd = getattr(rnn_fused, self.fwd_name)
        self.bwd = getattr(rnn_fused, self.bwd_name)
        self.fwd_ref = getattr(rnn_fused, f"{name}_bidir_layer_ref")
        self.bwd_ref = getattr(rnn_fused, f"{name}_bidir_layer_bwd_ref")
        self.library = "nn.LSTM" if self.lstm else "nn.GRU"
        self.fwd_src, self.bwd_src = (f"{CSRC}{n}.cu" for n in
                                      (self.fwd_name, self.bwd_name))
        self.fwd_replaces, self.bwd_replaces = (
            ("1632", "1780") if self.lstm else ("1008", "1190"))
        # the forwards' rows in tools/torch_lstm_scan_steps.py
        self.fwd_row, self.mfwd_row = ("3", "7") if self.lstm else ("1", "5")
        # the merged body (rows 5-8, PVA_RNN_SPLIT=0)
        self.mfwd_name = f"{name}_merged_fwd"
        self.mbwd_name = f"{name}_merged_bwd"
        self.mfwd = getattr(rnn_fused, self.mfwd_name)
        self.mbwd = getattr(rnn_fused, self.mbwd_name)
        self.mfwd_ref = getattr(rnn_fused, f"{name}_merged_layer_ref")
        self.mbwd_ref = getattr(rnn_fused, f"{name}_merged_layer_bwd_ref")
        # rows 5 and 7 are rows 1's and 3's recurrences with the merged
        # addressing, in their sources
        self.mfwd_src, self.mbwd_src = (f"{CSRC}{n}.cu" for n in (
            self.fwd_name, self.mbwd_name))
        self.mfwd_replaces, self.mbwd_replaces = (
            ("500", "630") if self.lstm else ("111", "241"))
        if not self.lstm:  # the GRU's fused-boundary form (rows 1-2 alt)
            self.bfwd = rnn_fused.gru_bidir_bnd_fwd
            self.bbwd = rnn_fused.gru_bidir_bnd_bwd

    def weight_shapes(self, w_in):
        """wif, wib, the biases (one folded bias per direction for the
        LSTM, bi then bh for the GRU), whf, whb."""
        g = self.n_gates * H
        biases = 2 if self.lstm else 4
        shapes = [(w_in, g)] * 2 + [(g,)] * 2 + [(H, g)] * 2
        return shapes + [(g,)] * (biases - 2)

    def weight_count(self, w_in):
        return sum(int(np.prod(s)) for s in self.weight_shapes(w_in))

    def bound(self, t_len, b, w_in, dt_name, train=False):
        """Least time (ms) the card could take for one layer's forward:
        each input read once, each output (ys; in the train form also the
        residuals and, for the LSTM, the f32 cell states) written once,
        against the peak rates."""
        size = 4 if dt_name == "float32" else 2
        outputs = 2 * t_len * b * H * (1 + (self.n_res if train else 0))
        n_bytes = ((t_len * b * w_in + self.weight_count(w_in) + outputs)
                   * size + 4 * b)
        if train and self.lstm:
            n_bytes += 2 * t_len * b * H * 4
        flops = 2 * t_len * b * (w_in + H) * self.n_gates * H * 2
        return _bound(n_bytes, flops, dt_name)

    def bound_bwd(self, t_len, b, w_in, dt_name, simt=False):
        """Least time (ms) for one layer's backward: x, the weights, ys, the
        residuals (and the LSTM's f32 cell states) and dy read once, dx and
        the gradients written once; FLOPs 4*T*B*gH*(2*W_in + 2H) (dwi, dx,
        dwh and the carry product, both directions).  The products off the
        chain (dwi, dx, dwh: 4*T*B*gH*(2*W_in + H)) run on the tensor cores
        (``tc_bound``), the chain's carry product (4*T*B*gH*H) at the f32
        SIMT peak; ``simt=True`` counts every operation at the dtype's
        ``PEAK_FLOPS``, as before the products moved to the tensor cores
        (the GRU's, row 2; the LSTM's, row 4)."""
        size = 4 if dt_name == "float32" else 2
        weights = self.weight_count(w_in)
        reads = (t_len * b * w_in + weights
                 + 2 * t_len * b * H * (1 + self.n_res + 1))
        writes = t_len * b * w_in + weights
        n_bytes = (reads + writes) * size + 4 * b
        if self.lstm:
            n_bytes += 2 * t_len * b * H * 4
        g = self.n_gates * H
        flops = 4 * t_len * b * g * (2 * w_in + 2 * H)
        if simt:
            return _bound(n_bytes, flops, dt_name)
        chain = 4 * t_len * b * g * H
        return tc_bound(n_bytes, flops - chain, chain, dt_name)

    def bwd_args(self, x, ws, lengths, fwd, dys):
        return (x, ws[0], ws[1], ws[4], ws[5], lengths, *fwd, *dys)

    def merged_weights(self, ws):
        """The merged body's weights of the same layer: wif2, wib2, the
        gate-grouped bi2 and wh2 and, for the GRU, bh2 (ops/rnn.py's
        packing)."""
        from pytorch_video_action_tpu_torch.ops import rnn

        g = self.n_gates
        pack = [rnn._pack_gate_grouped(ws[4:6], H, g),
                rnn._pack_gate_grouped_vec(ws[2:4], H, g)]
        if not self.lstm:
            pack.append(rnn._pack_gate_grouped_vec(ws[6:8], H, g))
        wh2, bi2, *bh2 = (t.contiguous() for t in pack)
        return (ws[0], ws[1], bi2, wh2, *bh2)

    def merged_bwd_args(self, x, mws, lengths, fwd, dys):
        """The merged backward's arguments from its train form's outputs:
        hp2 (and cp2) built as the autograd Function builds them."""
        import torch

        from pytorch_video_action_tpu_torch.ops import rnn_fused

        hp2 = rnn_fused._prev_kernel_order(fwd[0], fwd[1])
        if self.lstm:
            cs = fwd[2]
            cp2 = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
            return (x, fwd[3], hp2, cp2, *dys, mws[0], mws[1], mws[3],
                    lengths)
        return (x, fwd[2], hp2, *dys, mws[0], mws[1], mws[3], lengths)

    def merged_bound(self, t_len, b, w_in, dt_name, train=False):
        """Least time (ms) for one merged forward: the FLOPs of rows 1/3 (the
        block-diagonal product's non-zero half); bytes of x, the weights as
        packed (the whole wh2) and the outputs (ys; in the train form also
        the kernel-order residuals and, for the LSTM, cs in the dtype)."""
        size = 4 if dt_name == "float32" else 2
        g = self.n_gates * H
        weights = 2 * w_in * g + 4 * H * g + 2 * g * (1 if self.lstm else 2)
        outputs = 2 * t_len * b * H * (1 + (self.n_res if train else 0)
                                       + (1 if train and self.lstm else 0))
        n_bytes = (t_len * b * w_in + weights + outputs) * size + 4 * b
        flops = 2 * t_len * b * (w_in + H) * g * 2
        return _bound(n_bytes, flops, dt_name)

    def merged_bound_bwd(self, t_len, b, w_in, dt_name, simt=False):
        """Least time (ms) for one merged backward: rows 2/4's FLOPs, 4*T*B*
        gH*(2*W_in + 2H), plus dwh2's off-diagonal half, 4*T*B*gH*H; bytes
        of x, the packed weights, the residuals, hp2 (and cp2), dy read
        once, dx_f, dx_b and the gradients written once.  The GRU's (row
        6) products off the chain (4*T*B*gH*(2*W_in + 2H), dwh2 whole) on
        the tensor cores and its chain's carry product (4*T*B*gH*H) at the
        f32 SIMT peak (``tc_bound``); the LSTM's (row 8, SIMT products) and
        ``simt=True`` every operation at the dtype's ``PEAK_FLOPS``."""
        size = 4 if dt_name == "float32" else 2
        g = self.n_gates * H
        weights = 2 * w_in * g + 4 * H * g + 2 * g * (1 if self.lstm else 2)
        rows = t_len * b
        reads = (rows * w_in + weights
                 + rows * H * (2 * self.n_res + 2 * (2 if self.lstm else 1)
                               + 2))
        writes = 2 * rows * w_in + weights
        n_bytes = (reads + writes) * size + 4 * b
        flops = 4 * rows * g * (2 * w_in + 3 * H)
        if self.lstm or simt:
            return _bound(n_bytes, flops, dt_name)
        chain = 4 * rows * g * H
        return tc_bound(n_bytes, flops - chain, chain, dt_name)

    def module(self, x, ws):
        """torch.nn.GRU / LSTM(bidirectional=True) with the same weights, on
        the card in x's dtype: the yardstick, timed here only, never called
        by the port.  The LSTM's folded bias goes to bias_ih, bias_hh is
        0."""
        import torch

        w_in = x.shape[2]
        net = (torch.nn.LSTM if self.lstm else torch.nn.GRU)(
            w_in, H, bidirectional=True)
        if self.lstm:
            wif, wib, bf, bb, whf, whb = ws
            dirs = (("", wif, whf, bf, torch.zeros_like(bf)),
                    ("_reverse", wib, whb, bb, torch.zeros_like(bb)))
        else:
            wif, wib, bif, bib, whf, whb, bhf, bhb = ws
            dirs = (("", wif, whf, bif, bhf), ("_reverse", wib, whb, bib, bhb))
        with torch.no_grad():
            for sfx, wi, wh, bi, bh in dirs:
                getattr(net, "weight_ih_l0" + sfx).copy_(wi.t())
                getattr(net, "weight_hh_l0" + sfx).copy_(wh.t())
                getattr(net, "bias_ih_l0" + sfx).copy_(bi)
                getattr(net, "bias_hh_l0" + sfx).copy_(bh)
        # moving the module lays its weights out as one cuDNN buffer
        return net.to("cuda", x.dtype)


GRU = LSTM = None  # the two Cells, made once torch is importable


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# cuda_ms holds the stream at most this long; the clock converts it to the
# cycles torch.cuda._sleep counts (an H100 SXM's boost clock: at a lower
# clock the hold only lasts longer)
MAX_HOLD_S = 0.5
SM_HZ = 1.98e9


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time (ms) of ``fn`` over ``iters`` calls, from CUDA
    events.  After the warm-up the stream is held (``torch.cuda._sleep``)
    for twice the host's time to issue the calls, taken on the last
    warm-up call, so every launch is queued before the first one runs: a
    wrapper's host work (checks, allocations, the ctypes call) then does
    not stand between its kernels, and the events time the device.  With
    no warm-up, or once the hold would pass ``MAX_HOLD_S`` (the plain
    versions' Python loops over T), the host's time stays in."""
    import torch

    hold_s = 0.0
    for _ in range(warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        hold_s = 2 * (time.perf_counter() - t0) * iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if 0.0 < hold_s <= MAX_HOLD_S:
        torch.cuda._sleep(int(hold_s * SM_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the recurrent kernels' step splits: {row of tools/torch_lstm_scan_steps.py
# in SPLIT_ROWS: {build: library}}, each build the kernel as it is or with
# one part of its step taken out, built in phase 2 into a directory that
# lives as long as the process; STEP_ROWS maps a scan wrapper to its row
# (row 14 is row 13's template).  Row 5 is row 1's source with row 1's
# edits, so it times row 1's builds (SHARED_STEPS).  Row 4's split is the
# tool's alone.
SPLIT_ROWS = ("13", "9", "15", "1", "3")
SHARED_STEPS = {"5": "1"}
SCAN_STEPS: dict = {}
STEP_ROWS = {"lstm_scan_fwd": "13", "lstm_scan_fwd_save": "13",
             "gru_scan_fwd": "9", "lstm_scan_bwd_saved": "15"}
_STEPS_DIR = None


def steps_tool():
    """``tools/torch_lstm_scan_steps.py`` as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "torch_lstm_scan_steps.py")
    spec = importlib.util.spec_from_file_location("torch_lstm_scan_steps",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_build():
    from pathlib import Path

    from pytorch_video_action_tpu_torch.ops import cuda_lib

    global _STEPS_DIR
    t0 = time.time()
    _STEPS_DIR = tempfile.TemporaryDirectory()
    tool = steps_tool()
    # the edited copies; each kernel as it is is the build below
    jobs = {row: tool.start_builds(cuda_lib.CSRC, Path(_STEPS_DIR.name),
                                   names=list(tool.KERNELS[row].edits),
                                   kernel=row)
            for row in SPLIT_ROWS}
    logs = cuda_lib.build_all(ptxas_verbose=True)
    for row, got in jobs.items():
        SCAN_STEPS[row] = {"as is": cuda_lib.load(tool.KERNELS[row].source),
                           **tool.finish_builds(got)}
    for row, built in SHARED_STEPS.items():
        SCAN_STEPS[row] = SCAN_STEPS[built]
    log(f"[build] {len(logs)} source(s) and the step-split builds of rows "
        f"{', '.join(SCAN_STEPS)} ("
        f"{sum(len(v) - 1 for v in SCAN_STEPS.values())}) compiled in "
        f"{time.time() - t0:.1f} s")
    for name, text in logs.items():
        log(f"[build] -Xptxas -v for {name}:")
        log(text.strip())
    for line in ptxas_summary(logs):
        log(line)
    check_wgmma()


# kernels whose products run on the tensor cores: (library, kernel); each
# instantiation (f32 and bf16, every template form) must issue wgmma
WGMMA_KERNELS = [("flash_fwd", "flash_fwd_kernel"),
                 ("flash_bwd", "flash_bwd_fused_kernel"),
                 ("flash_bwd", "flash_bwd_dkdv_kernel"),
                 ("flash_bwd", "flash_bwd_dq_kernel"),
                 ("gru_bidir_bwd", "wgrad_wgmma_kernel"),
                 ("gru_bidir_bwd", "dx_wgmma_kernel"),
                 ("lstm_bidir_bwd", "wgrad_wgmma_kernel"),
                 ("lstm_bidir_bwd", "dx_wgmma_kernel"),
                 ("gru_merged_bwd", "wgrad_wgmma_kernel"),
                 ("gru_merged_bwd", "dx_wgmma_kernel"),
                 ("lstm_scan_bwd", "dwh_wgmma_kernel"),
                 ("gru_scan_bwd", "dwh_wgmma_kernel")]


def ptxas_summary(logs) -> list[str]:
    """One line per instantiation of ``WGMMA_KERNELS`` from the build's
    ``-Xptxas -v`` output: its registers, its spills, and whether ptxas
    serialized its wgmma (warning C7512)."""
    lines = []
    for lib, kernel in WGMMA_KERNELS:
        fn, info = None, {}
        for line in logs.get(lib, "").splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if kernel in line else None
                if fn:
                    info.setdefault(fn, [])
            elif fn and ("spill" in line or "Used" in line):
                info[fn].append(" ".join(line.replace("ptxas info    :",
                                                      "").split()))
            if "C7512" in line and kernel in line:
                info.setdefault(line.split("'")[1], []).append(
                    "wgmma serialized (C7512)")
        for f, got in info.items():
            lines.append(f"[build] {kernel} ({f}): {'; '.join(got)}")
    return lines


def check_wgmma():
    """``cuobjdump -sass`` of the libraries of ``WGMMA_KERNELS``: counts
    HGMMA (wgmma) instructions in every instantiation of its kernels and
    fails unless each has some and both dtypes are there."""
    from pytorch_video_action_tpu_torch.ops import cuda_lib

    tool = os.path.join(os.path.dirname(cuda_lib.nvcc()), "cuobjdump")
    for lib, kernel in WGMMA_KERNELS:
        sass = subprocess.run([tool, "-sass", str(cuda_lib.library_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, first, fn = {}, {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                if kernel in fn:
                    counts[fn] = 0
            elif fn in counts and "HGMMA" in line:
                counts[fn] += 1
                first.setdefault(fn, " ".join(line.split("*/", 1)[-1].split()))
        dtypes = {"float32": [f for f in counts if f"{kernel}If" in f],
                  "bfloat16": [f for f in counts
                               if f"{kernel}I13__nv_bfloat16" in f]}
        for dt_name, fns in dtypes.items():
            for f in fns:
                log(f"[build] {kernel} {dt_name} ({f}): {counts[f]} HGMMA, "
                    f"e.g. {first.get(f)}")
            if not fns or not all(counts[f] for f in fns):
                raise AssertionError(f"{kernel} issues no wgmma in {dt_name}")


def layer_inputs(cell, t_len, b, w_in, dt, lengths, gen):
    import torch

    k = 1.0 / H ** 0.5
    ws = [((torch.rand(s, generator=gen) * 2 - 1) * k).to("cuda", dt)
          for s in cell.weight_shapes(w_in)]
    x = torch.randn(t_len, b, w_in, generator=gen).to("cuda", dt)
    return x, ws, torch.as_tensor(lengths, dtype=torch.int32).cuda()


def library_fwd(cell, x, ws, lengths):
    """The yardstick's forward on a packed sequence: one call."""
    from torch.nn.utils.rnn import pack_padded_sequence

    net = cell.module(x, ws).eval()
    lengths_cpu = lengths.cpu()

    def run():
        packed = pack_padded_sequence(x, lengths_cpu, enforce_sorted=False)
        return net(packed)[0]

    return run


def library_train(cell, x, ws, lengths, dys):
    """The yardstick's forward with autograd on (what training runs) and
    ``torch.autograd.grad`` of the packed output against the same output
    gradients (the VJP in one call)."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    net = cell.module(x, ws).train()
    lengths_cpu = lengths.cpu()
    xg = x.detach().requires_grad_(True)
    inputs = [xg, *net.parameters()]

    def fwd():
        packed = pack_padded_sequence(xg, lengths_cpu, enforce_sorted=False)
        return net(packed)[0]

    out = fwd().data
    dy = pack_padded_sequence(torch.cat(dys, dim=-1), lengths_cpu,
                              enforce_sorted=False).data

    def bwd():
        return torch.autograd.grad(out, inputs, dy, retain_graph=True)

    return fwd, bwd


def _bound(n_bytes, flops, dt_name):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dt_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def tc_bound(n_bytes, tc_flops, simt_flops, dt_name):
    """Least time (ms) of work with ``tc_flops`` operations on the tensor
    cores (bf16 at its peak; f32 as 3xTF32, three TF32 operations for each
    f32 one, at ``TF32_FLOPS``) followed by ``simt_flops`` at the f32 SIMT
    peak, against ``n_bytes`` at the memory rate."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    tc = (3 * tc_flops / TF32_FLOPS if dt_name == "float32"
          else tc_flops / PEAK_FLOPS[dt_name])
    t_ops = (tc + simt_flops / PEAK_FLOPS["float32"]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# the layer backwards' kernels on the tensor cores (rows 2, 2 alt, 4 and 6;
# "bwd_recur_kernel" also names lstm_bwd_recur_kernel and
# merged_bwd_recur_kernel), each launched once a call, by part of the call
BWD_PARTS = {"wgrad_wgmma_kernel": "products", "dx_wgmma_kernel": "products",
             "wgrad_reduce_kernel": "reduction", "bwd_recur_kernel": "chain",
             "bias_reduce_kernel": "bias"}


def part_ms(fn, iters: int = 5, parts=None) -> dict:
    """Device time (ms) one call of ``fn`` spends in each part of ``parts``
    (``{kernel name: part}``, ``BWD_PARTS`` unless given; and in any other
    kernel), from ``torch.profiler``'s
    kernel events over ``iters`` calls: each kernel's mean over the events
    recorded, summed by part.  The tracing may start after the first
    launches, so the calls begin after a pause inside the profiler and only
    complete events count.  Late in a run the profiler's first session
    often records no kernel at all, for a cause not found (PERF.md section
    7), so a session that misses a kernel of the parts is run again, four
    times at most, its pause doubled each time, and then raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    parts = BWD_PARTS if parts is None else parts
    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.2 * 2 ** attempt)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us: dict[str, list[float]] = {}
        for e in prof.events():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.is_user_annotation):
                continue
            name = next((k for k in parts if k in e.name), e.name)
            us.setdefault(name, []).append(e.time_range.elapsed_us())
        missing = [k for k in parts if k not in us]
        if not missing:
            break
        log(f"[kernel] the profiler saw no event of {missing} "
            f"(session {attempt + 1}, {sum(map(len, us.values()))} kernel "
            f"events)")
    if missing:
        raise AssertionError(f"the profiler saw no event of {missing}")
    out = dict.fromkeys([*dict.fromkeys(parts.values()), "other"], 0.0)
    for name, times in us.items():
        out[parts.get(name, "other")] += sum(times) / len(times) / 1e3
    return out


def parts_text(parts: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + " ms"


def layer_split(row, fn, args, t_len, steps):
    """A layer forward's (row 1's, 3's or 5's) device time by kernel, its
    input projection and its recurrence (``part_ms``), and with ``steps``
    its recurrence by step part (µs a step of each build of
    ``SCAN_STEPS[row]``, ``step_us``): the keys to add to its row."""
    tool = steps_tool()
    out = {"parts_ms": part_ms(lambda: fn(*args), parts=tool.LAYER_PARTS)}
    if steps:
        out["step_us"] = tool.step_us(SCAN_STEPS[row], fn, args, t_len,
                                      cuda_ms, kernel=row)
    return out


def split_text(row) -> str:
    """``layer_split``'s keys of a row, as a log's tail."""
    text = ""
    if "parts_ms" in row:
        text += f"; by kernel {parts_text(row['parts_ms'])}"
    if "step_us" in row:
        text += "; step split, us a step: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row["step_us"].items())
    return text


def check_layer(cell, where, lengths, t_len, w_in, dt_name, gen,
                steps=False):
    """Hold the eval-form kernel against its plain version on one input and
    time the kernel, the plain version and the library yardstick (also by
    kernel and, with ``steps``, by step part: ``layer_split``).
    Raises when they disagree.  Returns the row for the ``kernels`` line."""
    import torch

    dt = getattr(torch, dt_name)
    b = len(lengths)
    x, ws, lengths = layer_inputs(cell, t_len, b, w_in, dt, lengths, gen)
    ysf, ysb = cell.fwd(x, *ws, lengths)
    torch.cuda.synchronize()
    rf, rb = cell.fwd_ref(x, *ws, lengths)
    err_f = (ysf.float() - rf.float()).abs().max().item()
    err_b = (ysb.float() - rb.float()).abs().max().item()
    pad = (torch.arange(t_len, device="cuda")[:, None]
           >= lengths[None, :].long())
    pad_b = ysb.float().abs()[pad].max().item() if pad.any() else 0.0
    ms = cuda_ms(lambda: cell.fwd(x, *ws, lengths), 10, 2)
    plain_ms = cuda_ms(lambda: cell.fwd_ref(x, *ws, lengths), 2)
    lib_run = library_fwd(cell, x, ws, lengths)
    with torch.no_grad():
        lib_ms = cuda_ms(lib_run, 10, 2)
    bound_ms, bound_by = cell.bound(t_len, b, w_in, dt_name)
    row = {"where": where, "w_in": w_in, "dtype": dt_name, "B": b,
           "T": t_len, "max_abs_err": max(err_f, err_b), "tol": TOL[dt_name],
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           **layer_split(cell.fwd_row, cell.fwd, (x, *ws, lengths), t_len,
                         steps)}
    log(f"[kernel] {cell.fwd_name} {where} B={b} T={t_len} W_in={w_in} "
        f"{dt_name}: max|ysf-ref|={err_f:.3g} max|ysb-ref|={err_b:.3g} "
        f"(tol {TOL[dt_name]}), max|ysb| on padding={pad_b:.3g}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"{cell.library} packed {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}){split_text(row)}")
    if not (err_f <= TOL[dt_name] and err_b <= TOL[dt_name]):
        raise AssertionError(f"kernel disagrees with its plain version: {row}")
    if pad_b != 0.0:
        raise AssertionError("ys_b is not 0 on padded frames")
    return row


def check_layers(cell, where, lengths, t_len, gen, steps=()):
    """``check_layer`` for layer 0 (W_in=400) and the later layers (256), in
    f32 and bf16; layer 0's in the dtypes ``steps`` names also by step
    part."""
    return [check_layer(cell, where, lengths, t_len, w_in, dt_name, gen,
                        dt_name in steps and w_in == 400)
            for w_in in (400, 256) for dt_name in ("float32", "bfloat16")]


def rel_err(got, want):
    """(max abs error, max error relative to the largest plain element, at
    least 1) over a kernel's outputs."""
    abs_err = rel = 0.0
    for g, w in zip(got, want):
        d = (g.float() - w.float()).abs().max().item()
        abs_err = max(abs_err, d)
        rel = max(rel, d / max(1.0, w.float().abs().max().item()))
    return abs_err, rel


def check_train_layer(cell, where, lengths, t_len, w_in, dt_name, gen,
                      steps=False):
    """Hold the train-form forward and the backward against their plain
    versions on one input, and time each beside its plain version, the
    library yardstick and its bound (the train form also by kernel and,
    with ``steps``, by step part: ``layer_split``; the backward also by
    part, ``part_ms``).  Raises when they disagree.  Returns the rows
    ``(train_form, backward)`` for the ``kernels`` line."""
    import functools

    import torch

    dt = getattr(torch, dt_name)
    b = len(lengths)
    x, ws, lengths = layer_inputs(cell, t_len, b, w_in, dt, lengths, gen)
    dys = [torch.randn(t_len, b, H, generator=gen).to("cuda", dt)
           for _ in range(2)]
    head = f"{where} B={b} T={t_len} W_in={w_in} {dt_name}"
    tol = TOL[dt_name]

    fwd = cell.fwd(x, *ws, lengths, train=True)
    torch.cuda.synchronize()
    ref = cell.fwd_ref(x, *ws, lengths, train=True)
    # the error is absolute, except that the LSTM's f32 cell state, which
    # unlike ys and its residuals is not bounded by 1, is taken relative to
    # its largest element (at least 1)
    abs_fwd, rel_fwd = rel_err(fwd, ref)
    err_fwd = rel_fwd if cell.lstm else abs_fwd
    ms = cuda_ms(lambda: cell.fwd(x, *ws, lengths, train=True), 10, 2)
    plain_ms = cuda_ms(
        lambda: cell.fwd_ref(x, *ws, lengths, train=True), 1, 0)
    lib_fwd, lib_bwd = library_train(cell, x, ws, lengths, dys)
    lib_ms = cuda_ms(lib_fwd, 10, 2)
    bound_ms, bound_by = cell.bound(t_len, b, w_in, dt_name, train=True)
    fwd_row = {"where": where, "w_in": w_in, "dtype": dt_name, "B": b,
               "T": t_len, "max_abs_err": err_fwd, "tol": tol, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               **layer_split(cell.fwd_row,
                             functools.partial(cell.fwd, train=True),
                             (x, *ws, lengths), t_len, steps)}
    log(f"[kernel] {cell.fwd_name} train form {head}: max|out-ref|="
        f"{abs_fwd:.3g}, error {err_fwd:.3g} (tol {tol}), kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, {cell.library} packed with autograd "
        f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
        f"{split_text(fwd_row)}")
    if not err_fwd <= tol:
        raise AssertionError(f"train form disagrees with its plain version: "
                             f"{fwd_row}")

    bargs = cell.bwd_args(x, ws, lengths, fwd, dys)
    got = cell.bwd(*bargs)
    torch.cuda.synchronize()
    want = cell.bwd_ref(*bargs)
    abs_err, err_bwd = rel_err(got, want)
    again = cell.bwd(*bargs)
    identical = all(torch.equal(a, c) for a, c in zip(got, again))
    ms = cuda_ms(lambda: cell.bwd(*bargs), 5, 1)
    plain_ms = cuda_ms(lambda: cell.bwd_ref(*bargs), 1, 0)
    lib_ms = cuda_ms(lib_bwd, 5, 1)
    bound_ms, bound_by = cell.bound_bwd(t_len, b, w_in, dt_name)
    bwd_row = {"where": where, "w_in": w_in, "dtype": dt_name, "B": b,
               "T": t_len, "max_abs_err": abs_err, "max_rel_err": err_bwd,
               "tol": tol, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bit_identical_rerun": identical}
    # the products on the tensor cores: the old count beside the bound
    bwd_row["bound_simt_ms"] = cell.bound_bwd(t_len, b, w_in, dt_name,
                                              simt=True)[0]
    bwd_row["parts_ms"] = part_ms(lambda: cell.bwd(*bargs))
    extra = (f" (SIMT count {bwd_row['bound_simt_ms']:.4f} ms); by part "
             f"{parts_text(bwd_row['parts_ms'])}")
    log(f"[kernel] {cell.bwd_name} {head}: max abs err {abs_err:.3g}, max "
        f"err / max(1, max|plain|) {err_bwd:.3g} (tol {tol}), rerun "
        f"bit-identical {identical}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, autograd.grad through {cell.library} packed "
        f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}){extra}")
    if not err_bwd <= tol:
        raise AssertionError(f"backward disagrees with its plain version: "
                             f"{bwd_row}")
    if not identical:
        raise AssertionError("two backward runs differ")
    return fwd_row, bwd_row


def check_train_layers(cell, where, lengths, t_len, gen, steps=()):
    """``check_train_layer`` for W_in 400 and 256, f32 and bf16 (W_in 400's
    train form in the dtypes ``steps`` names also by step part): lists of
    train-form rows and of backward rows."""
    rows = [check_train_layer(cell, where, lengths, t_len, w_in, dt_name,
                              gen, dt_name in steps and w_in == 400)
            for w_in in (400, 256) for dt_name in ("float32", "bfloat16")]
    return [r[0] for r in rows], [r[1] for r in rows]


# ------------------------------------------------------------ merged body


def merged_vs_split(cell, merged, split):
    """Largest error, relative to the largest element (at least 1), of the
    merged backward's gradients (rows 6/8) against the split one's (rows
    2/4) on the same weights: dx_f + dx_b against dx; dwif, dwib; the
    diagonal blocks of dwh2, dbi2 (and the GRU's dbh2) against the
    per-direction gradients."""
    from pytorch_video_action_tpu_torch.ops.rnn_fused import _dense

    g = cell.n_gates
    dxf, dxb, dwif, dwib, dbi2, dwh2, *dbh2 = merged
    got = [dxf.float() + dxb.float(), dwif, dwib, _dense(dbi2, H, g, 0),
           _dense(dbi2, H, g, 1), _dense(dwh2[:H], H, g, 0),
           _dense(dwh2[H:], H, g, 1)]
    if dbh2:
        got += [_dense(dbh2[0], H, g, 0), _dense(dbh2[0], H, g, 1)]
    return rel_err(got, split)[1]


def check_merged_layer(cell, where, lengths, t_len, w_in, dt_name, gen):
    """Row 5 or 7's eval form against its plain version and against row 1
    or 3 on the same weights (its ys row 1's or 3's bit for bit: the same
    recurrence on the same sums), timed beside its plain version, the
    library yardstick (nn.GRU / nn.LSTM packed) and its bound, and by
    kernel (``layer_split``).  Raises when they disagree.  Returns the row
    for the ``kernels`` line."""
    import torch

    dt = getattr(torch, dt_name)
    b = len(lengths)
    x, ws, lengths = layer_inputs(cell, t_len, b, w_in, dt, lengths, gen)
    mws = cell.merged_weights(ws)
    got = cell.mfwd(x, *mws, lengths)
    torch.cuda.synchronize()
    err = rel_err(got, cell.mfwd_ref(x, *mws, lengths))[0]
    sgot = cell.fwd(x, *ws, lengths)
    split = rel_err(got, sgot)[0]
    same = all(torch.equal(a, c) for a, c in zip(got, sgot))
    ms = cuda_ms(lambda: cell.mfwd(x, *mws, lengths), 10, 2)
    plain_ms = cuda_ms(lambda: cell.mfwd_ref(x, *mws, lengths), 2)
    lib_run = library_fwd(cell, x, ws, lengths)
    with torch.no_grad():
        lib_ms = cuda_ms(lib_run, 10, 2)
    bound_ms, bound_by = cell.merged_bound(t_len, b, w_in, dt_name)
    tol = TOL[dt_name]
    row = {"where": where, "w_in": w_in, "dtype": dt_name, "B": b,
           "T": t_len, "max_abs_err": err, "tol": tol,
           "split_max_abs_err": split, "ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           **layer_split(cell.mfwd_row, cell.mfwd, (x, *mws, lengths), t_len,
                         False)}
    log(f"[kernel] {cell.mfwd_name} {where} B={b} T={t_len} W_in={w_in} "
        f"{dt_name}: max|ys-ref|={err:.3g}, against {cell.fwd_name} "
        f"{split:.3g} (bit for bit {same}; tol {tol}), kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, {cell.library} packed {lib_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}){split_text(row)}")
    if not (err <= tol and split <= tol):
        raise AssertionError(f"merged forward disagrees: {row}")
    if not same:
        raise AssertionError(f"row {cell.mfwd_row}'s ys are not row "
                             f"{cell.fwd_row}'s bit for bit")
    return row


def check_merged_train_layer(cell, where, lengths, t_len, w_in, dt_name,
                             gen, steps=False):
    """Row 5 or 7's train form and row 6 or 8 against their plain versions
    and against rows 1-4 on the same weights (ys bit for bit, and
    the gradients as ``merged_vs_split`` takes them), the backward rerun
    bit for bit; each timed beside its plain version, the library yardstick
    and its bound, the train form also by kernel and, with ``steps``, by
    step part (``layer_split``).  Raises when they disagree.  Returns the
    rows ``(train_form, backward)``."""
    import functools

    import torch

    dt = getattr(torch, dt_name)
    b = len(lengths)
    x, ws, lengths = layer_inputs(cell, t_len, b, w_in, dt, lengths, gen)
    mws = cell.merged_weights(ws)
    dys = [torch.randn(t_len, b, H, generator=gen).to("cuda", dt)
           for _ in range(2)]
    head = f"{where} B={b} T={t_len} W_in={w_in} {dt_name}"
    tol = TOL[dt_name]

    fwd = cell.mfwd(x, *mws, lengths, train=True)
    torch.cuda.synchronize()
    abs_fwd, rel_fwd = rel_err(fwd, cell.mfwd_ref(x, *mws, lengths,
                                                  train=True))
    # the LSTM's cell states are not bounded by 1: relative, as for row 3
    err_fwd = rel_fwd if cell.lstm else abs_fwd
    sfwd = cell.fwd(x, *ws, lengths, train=True)
    split_fwd = rel_err(fwd[:2], sfwd[:2])[0]
    same = all(torch.equal(a, c) for a, c in zip(fwd[:2], sfwd[:2]))
    ms = cuda_ms(lambda: cell.mfwd(x, *mws, lengths, train=True), 10, 2)
    plain_ms = cuda_ms(
        lambda: cell.mfwd_ref(x, *mws, lengths, train=True), 1, 0)
    lib_fwd, lib_bwd = library_train(cell, x, ws, lengths, dys)
    lib_ms = cuda_ms(lib_fwd, 10, 2)
    bound_ms, bound_by = cell.merged_bound(t_len, b, w_in, dt_name,
                                           train=True)
    fwd_row = {"where": where, "w_in": w_in, "dtype": dt_name, "B": b,
               "T": t_len, "max_abs_err": err_fwd, "tol": tol,
               "split_max_abs_err": split_fwd, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               **layer_split(cell.mfwd_row,
                             functools.partial(cell.mfwd, train=True),
                             (x, *mws, lengths), t_len, steps)}
    log(f"[kernel] {cell.mfwd_name} train form {head}: max|out-ref|="
        f"{abs_fwd:.3g}, error {err_fwd:.3g}, ys against {cell.fwd_name} "
        f"{split_fwd:.3g} (bit for bit {same}; tol {tol}), kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, {cell.library} packed with "
        f"autograd {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
        f"{split_text(fwd_row)}")
    if not (err_fwd <= tol and split_fwd <= tol):
        raise AssertionError(f"merged train form disagrees: {fwd_row}")
    if not same:
        raise AssertionError(f"row {cell.mfwd_row}'s ys are not row "
                             f"{cell.fwd_row}'s bit for bit")

    bargs = cell.merged_bwd_args(x, mws, lengths, fwd, dys)
    got = cell.mbwd(*bargs)
    torch.cuda.synchronize()
    abs_err, err_bwd = rel_err(got, cell.mbwd_ref(*bargs))
    again = cell.mbwd(*bargs)
    identical = all(torch.equal(a, c) for a, c in zip(got, again))
    split_bwd = merged_vs_split(
        cell, got, cell.bwd(*cell.bwd_args(x, ws, lengths, sfwd, dys)))
    ms = cuda_ms(lambda: cell.mbwd(*bargs), 5, 1)
    plain_ms = cuda_ms(lambda: cell.mbwd_ref(*bargs), 1, 0)
    lib_ms = cuda_ms(lib_bwd, 5, 1)
    bound_ms, bound_by = cell.merged_bound_bwd(t_len, b, w_in, dt_name)
    bwd_row = {"where": where, "w_in": w_in, "dtype": dt_name, "B": b,
               "T": t_len, "max_abs_err": abs_err, "max_rel_err": err_bwd,
               "tol": tol, "split_max_rel_err": split_bwd, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bit_identical_rerun": identical}
    extra = ""
    if not cell.lstm:  # row 6's products on the tensor cores
        bwd_row["bound_simt_ms"] = cell.merged_bound_bwd(
            t_len, b, w_in, dt_name, simt=True)[0]
        bwd_row["parts_ms"] = part_ms(lambda: cell.mbwd(*bargs))
        extra = (f" (SIMT count {bwd_row['bound_simt_ms']:.4f} ms); by part "
                 f"{parts_text(bwd_row['parts_ms'])}")
    log(f"[kernel] {cell.mbwd_name} {head}: max abs err {abs_err:.3g}, max "
        f"err / max(1, max|plain|) {err_bwd:.3g}, against {cell.bwd_name} "
        f"{split_bwd:.3g} (tol {tol}), rerun bit-identical {identical}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, autograd.grad "
        f"through {cell.library} packed {lib_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}){extra}")
    if not (err_bwd <= tol and split_bwd <= tol):
        raise AssertionError(f"merged backward disagrees: {bwd_row}")
    if not identical:
        raise AssertionError("two merged backward runs differ")
    return fwd_row, bwd_row


def phase_kernels():
    """Every kernel at the bench shape: ``{kernel name: rows}``."""
    import torch

    rows = {}
    for cell in (GRU, LSTM):
        gen = torch.Generator().manual_seed(0)
        lengths = torch.randint(1, T_BENCH + 1, (B_BENCH,), generator=gen)
        lengths[0], lengths[1] = 1, T_BENCH
        lengths = lengths.tolist()
        t0 = time.time()
        rows[cell.fwd_name] = check_layers(cell, "bench", lengths, T_BENCH,
                                           gen)
        (rows[cell.fwd_name + "_train"],
         rows[cell.bwd_name]) = check_train_layers(cell, "bench", lengths,
                                                   T_BENCH, gen)
        log(f"[kernel] {cell.name} bench-shape checks in "
            f"{time.time() - t0:.1f} s")
    # rows 4 and 6 also at bench.py's shape with every frame valid, their
    # weight gradients' K slices at their deepest (94 and 512 chunks)
    t0 = time.time()
    gen = torch.Generator().manual_seed(7)
    full = [T_BENCH] * B_BENCH
    for dt_name in DTYPES:
        rows[LSTM.bwd_name].append(check_train_layer(
            LSTM, "bench, every frame valid", full, T_BENCH, 400, dt_name,
            gen)[1])
        fwd, bwd = check_merged_train_layer(
            GRU, "bench, every frame valid", full, T_BENCH, 400, dt_name, gen)
        rows.setdefault(GRU.mfwd_name + "_train", []).append(fwd)
        rows.setdefault(GRU.mbwd_name, []).append(bwd)
    log(f"[kernel] rows 4 and 6 every frame valid in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    gen = torch.Generator().manual_seed(5)
    for name, got in check_flash(
            "bench", [T_ATTN] * B_ATTN, T_ATTN, gen,
            fwd=[(dt, r) for dt in ("float32", "bfloat16")
                 for r in (0.0, ATTN_RATE)],
            bwd=[(dt, r) for dt in ("float32", "bfloat16")
                 for r in (ATTN_RATE, 0.0)]).items():
        rows[name] = got
    log(f"[kernel] flash bench-shape checks in {time.time() - t0:.1f} s")
    t0 = time.time()
    rows.update(check_conv("bench", [T_TCN] * B_TCN, T_TCN,
                           torch.Generator().manual_seed(6)))
    log(f"[kernel] conv bench-shape checks in {time.time() - t0:.1f} s")
    # flash at d > 128 (attn with 2 heads, d=200, and 1 head, d=400), at
    # attn's serving main-path shape
    t0 = time.time()
    gen = torch.Generator().manual_seed(7)
    for heads in (2, 1):
        for name, got in check_flash(
                f"d={head_width(heads)}", WIDE_LENGTHS, WIDE_T, gen,
                fwd=[(dt, ATTN_RATE) for dt in DTYPES],
                bwd=[(dt, r) for dt in DTYPES for r in (ATTN_RATE, 0.0)],
                heads=heads).items():
            rows[name] += got
    log(f"[kernel] flash d=200 and d=400 checks in {time.time() - t0:.1f} s")
    t0 = time.time()
    for where, b, t_len, w, dtypes in SCAN_EXTRA:
        lengths = torch.randint(1, t_len + 1, (b,), generator=gen).tolist()
        lengths[0] = t_len
        if where == "bench":
            lengths = [t_len] * b
        for dt_name in dtypes:
            for name, got in check_scan(
                    where, lengths, t_len, w, dt_name, gen,
                    steps=where == "bench").items():
                rows.setdefault(name, []).extend(got)
    log(f"[kernel] LSTM scan checks at W=100, W=512, the bench shape and "
        f"W=8192 in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    for where, b, t_len, w, lengths, dtypes in GSCAN_EXTRA:
        if lengths is None:
            lengths = torch.randint(1, t_len + 1, (b,), generator=gen).tolist()
            lengths[0] = t_len
        for dt_name in dtypes:
            for name, got in check_scan(
                    where, lengths, t_len, w, dt_name, gen, cell="gru").items():
                rows.setdefault(name, []).extend(got)
    log(f"[kernel] GRU scan checks at W=96, W=512, the serving shape, "
        f"W=2048 and W=12000 in "
        f"{time.time() - t0:.1f} s")
    return rows


# ------------------------------------------------------------------ flash


def head_width(heads: int) -> int:
    """d of attn's E=400 over ``heads`` heads."""
    return ATTN_H * ATTN_D // heads


def flash_inputs(lengths, t_len, dt, gen, heads=ATTN_H):
    """q (pre-scaled), k, v, dout ``[B, heads, T, 400 / heads]`` and the key
    mask on the card."""
    import torch

    d = head_width(heads)
    shape = (len(lengths), heads, t_len, d)
    q = torch.randn(shape, generator=gen) / d ** 0.5
    k, v, dout = (torch.randn(shape, generator=gen) for _ in range(3))
    mask = torch.arange(t_len)[None, :] < torch.as_tensor(lengths)[:, None]
    return (*(a.to("cuda", dt) for a in (q, k, v)), mask.cuda(),
            dout.to("cuda", dt))


def flash_bound(lengths, t_len, dt_name, products, operands, f32_outputs,
                row_vectors, heads=ATTN_H, d=None):
    """Least time (ms) of a flash function on this input: ``products`` score
    or value products of 2*d operations for each query and each valid key
    (``2 * products * H * T * d * sum(lengths)``), against its bytes:
    ``operands`` [B, H, T, d] tensors in the input dtype, ``f32_outputs``
    of them in f32, ``row_vectors`` f32 [B, H, T] vectors (lse; delta in
    the backward) and the key mask, each read or written once.  ``d``: the
    head width, attn's own by default.  The operations run on the tensor
    cores: bf16 at its peak; f32 as 3xTF32, three TF32 products for each
    f32 one, at the TF32 peak (``TF32_FLOPS``) -- faster than f32 outside
    the tensor cores, so the least time the card could take."""
    d = d or head_width(heads)
    size = 4 if dt_name == "float32" else 2
    b = len(lengths)
    bhtd = b * heads * t_len * d
    rows = b * heads * t_len * 4 * row_vectors
    n_bytes = (operands * size + f32_outputs * 4) * bhtd + rows + b * t_len
    flops = 2 * products * heads * t_len * d * sum(lengths)
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = (3 * flops / TF32_FLOPS if dt_name == "float32"
             else flops / PEAK_FLOPS[dt_name]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa(q, k, v, mask):
    """The yardstick: one ``scaled_dot_product_attention`` call with the key
    mask (q is pre-scaled), dropout 0.  Timed here only; the port never
    calls it."""
    import torch.nn.functional as nnf

    return nnf.scaled_dot_product_attention(
        q, k, v, attn_mask=mask[:, None, None, :], scale=1.0)


def check_flash_fwd(where, lengths, t_len, dt_name, rate, gen, heads=ATTN_H):
    """Hold the flash forward against its plain version and time it beside
    the plain version, the yardstick and its bound.  Returns its row."""
    import torch

    from pytorch_video_action_tpu_torch.ops import flash as F

    dt = getattr(torch, dt_name)
    q, k, v, mask, _ = flash_inputs(lengths, t_len, dt, gen, heads)
    out, lse = F.flash_fwd(q, k, v, mask, rate, 1234)
    torch.cuda.synchronize()
    ref, ref_lse, _ = F.flash_fwd_ref(q, k, v, mask, rate, 1234)
    err = (out.float() - ref.float()).abs().max().item()
    _, lse_err = rel_err([lse], [ref_lse])
    ms = cuda_ms(lambda: F.flash_fwd(q, k, v, mask, rate, 1234), 10, 2)
    plain_ms = cuda_ms(lambda: F.flash_fwd_ref(q, k, v, mask, rate, 1234), 1)
    with torch.no_grad():
        lib_ms = cuda_ms(lambda: sdpa(q, k, v, mask), 10, 2)
    bound_ms, bound_by = flash_bound(lengths, t_len, dt_name, 2, 4, 0, 1,
                                     heads)
    tol = TOL[dt_name]
    row = {"where": where, "dtype": dt_name, "rate": rate, "B": len(lengths),
           "T": t_len, "d": head_width(heads), "max_abs_err": err,
           "lse_rel_err": lse_err, "tol": tol,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"[kernel] flash_fwd {where} B={len(lengths)} T={t_len} "
        f"d={head_width(heads)} {dt_name} dropout {rate}: max|out-ref|={err:.3g} (tol {tol}), lse error "
        f"{lse_err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{lib_ms:.4f} ms (dropout 0), bound {bound_ms:.4f} ms ({bound_by})")
    if not (err <= tol and lse_err <= TOL["float32"]):
        raise AssertionError(f"flash_fwd disagrees with its plain version: "
                             f"{row}")
    return row


def check_flash_bwd(where, lengths, t_len, dt_name, rate, gen, heads=ATTN_H):
    """Hold the fused and the split backward against the plain version and
    each other, rerun each (bit for bit), and time each kernel beside the
    plain version, the yardstick and its bound.  Returns ``{entry: row}``
    for the fused form, the split's dk/dv kernel and its dq kernel."""
    import torch

    from pytorch_video_action_tpu_torch.ops import flash as F

    dt = getattr(torch, dt_name)
    q, k, v, mask, dout = flash_inputs(lengths, t_len, dt, gen, heads)
    out, lse = F.flash_fwd(q, k, v, mask, rate, 99)
    args = (q, k, v, mask, rate, 99, out, lse, dout)
    want = F.flash_bwd_ref(*args)
    runs = {}
    for fused in (True, False):
        runs[fused] = [F.flash_bwd(*args, fused=fused) for _ in range(2)]
        torch.cuda.synchronize()
    tol = TOL[dt_name]
    errs = {f: rel_err(runs[f][0], want) for f in runs}
    agree = rel_err(runs[True][0], runs[False][0])[1]
    identical = all(torch.equal(a, b) for f in runs for a, b in zip(*runs[f]))
    delta = (dout.float() * out.float()).sum(dim=-1)
    part_args = (q, k, v, mask, rate, 99, lse, delta, dout)
    part_ms = {name: cuda_ms(lambda f=getattr(F, name): f(*part_args), 5, 1)
               for name in ("flash_bwd_fused", "flash_bwd_dkdv",
                            "flash_bwd_dq")}
    plain_ms = cuda_ms(lambda: F.flash_bwd_ref(*args), 1, 0)
    leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
    lib_out = sdpa(*leaves, mask)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, dout,
                                                 retain_graph=True), 5, 1)
    # products: the fused form and the split as a whole 5 (s, g, dv, dk,
    # dq), the dk/dv kernel 4, the dq kernel 3; operands q, k, v, out,
    # dout and dk, dv (dq: q, k, v, dout), dq in f32
    shapes = {"flash_bwd_fused": (5, 7, 1), "flash_bwd_dkdv": (4, 6, 0),
              "flash_bwd_dq": (3, 4, 1)}
    rows = {}
    for name, (products, operands, f32_out) in shapes.items():
        ms = part_ms[name]
        fused = name == "flash_bwd_fused"
        bound_ms, bound_by = flash_bound(lengths, t_len, dt_name, products,
                                         operands, f32_out, 2, heads)
        abs_err, err = errs[fused]
        rows[name] = {"where": where, "dtype": dt_name, "rate": rate,
                      "B": len(lengths), "T": t_len, "d": head_width(heads),
                      "max_abs_err": abs_err,
                      "max_rel_err": err, "forms_rel_diff": agree, "tol": tol,
                      "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "bit_identical_rerun": identical}
        log(f"[kernel] {name} {where} B={len(lengths)} T={t_len} "
            f"d={head_width(heads)} {dt_name} dropout {rate}: max abs err {abs_err:.3g}, max err / max(1, "
            f"max|plain|) {err:.3g} (tol {tol}), kernel {ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
    log(f"[kernel] flash backward {where} B={len(lengths)} T={t_len} "
        f"d={head_width(heads)} {dt_name}: fused against split {agree:.3g}, "
        f"reruns bit-identical {identical}, plain {plain_ms:.4f} ms, "
        f"autograd.grad through sdpa {lib_ms:.4f} ms (dropout 0), fused form "
        f"{F.fused_chunks(len(lengths) * heads, t_len, sms())} chunks, "
        f"dispatch picks "
        f"{'fused' if use_fused(len(lengths), t_len, heads) else 'split'}")
    if not (max(e[1] for e in errs.values()) <= tol and agree <= tol):
        raise AssertionError(f"flash backward disagrees: {rows}")
    if not identical:
        raise AssertionError("two flash backward runs differ")
    return rows


def check_flash(where, lengths, t_len, gen, fwd, bwd, heads=ATTN_H) -> dict:
    """``check_flash_fwd`` for each ``(dtype, rate)`` of ``fwd`` and
    ``check_flash_bwd`` for each of ``bwd``: ``{entry: rows}``."""
    rows = {name: [] for name in FLASH}
    for dt_name, rate in fwd:
        rows["flash_fwd"].append(
            check_flash_fwd(where, lengths, t_len, dt_name, rate, gen, heads))
    for dt_name, rate in bwd:
        for name, row in check_flash_bwd(where, lengths, t_len, dt_name,
                                         rate, gen, heads).items():
            rows[name].append(row)
    return {k: v for k, v in rows.items() if v}


def sms() -> int:
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def use_fused(b, t_len, heads=ATTN_H, d=None) -> bool:
    """The backward the port's dispatch picks for attn at [b, T] (head width
    ``d``, attn's own by default)."""
    from pytorch_video_action_tpu_torch.ops import flash as F

    return F.use_fused(b * heads, t_len, t_len, d or head_width(heads),
                       sms())


# --------------------------------------------------------------- LSTM scan

SCAN_PALLAS = "pytorch_video_action_tpu/ops/rnn_pallas.py:"
# the LSTM scan's entries of the kernels line (each a wrapper of
# ops/rnn_scan.py): source and the TPU kernel's line in rnn_pallas.py
SCAN = {"lstm_scan_fwd": ("lstm_scan_fwd.cu", "421"),
        "lstm_scan_fwd_save": ("lstm_scan_fwd.cu", "479"),
        "lstm_scan_bwd_saved": ("lstm_scan_bwd.cu", "546"),
        "lstm_scan_bwd": ("lstm_scan_bwd.cu", "627")}
# vanilla_lstm: the inference CLIs' defaults (H=64, 1 layer) and the train
# CLI's (H=256, 2 layers, dropout 0.5)
VANILLA_SERVE = 1
VANILLA_SERVE_FLAGS = ["--lstm_hidden1", "64", "--lstm_layer", "1",
                       "--lstm_dropout", "0"]
# (where, B, T, W, dtypes) beside the main paths' shapes: an odd width and
# one whose weight slices pass a block's registers (f32), the bench shape
# (B=64, T=1024, bench.py's, every frame valid; W=256, vanilla_lstm's), and
# a width past where one row's gate gradients fit the shared memory (the
# backwards' device-memory forms)
SCAN_EXTRA = [("odd width", 8, 1920, 100, ("float32",)),
              ("wide", 8, 1920, 512, ("float32",)),
              ("bench", B_BENCH, T_BENCH, 256, DTYPES),
              ("gradients in device memory", 3, 32, 8192, ("float32",))]
# the GRU scan's entries of the kernels line, as SCAN's
GSCAN = {"gru_scan_fwd": ("gru_scan_fwd.cu", "92"),
         "gru_scan_fwd_save": ("gru_scan_fwd.cu", "147"),
         "gru_scan_bwd_saved": ("gru_scan_bwd.cu", "202"),
         "gru_scan_bwd": ("gru_scan_bwd.cu", "282")}
# BiGRU at hidden_dim_1 512, 192 and 2048 (H=256, 96 and 1024 a direction)
# and attn at hidden_dim 192 (H=96): widths the fused layer kernel refuses,
# so their GRU runs the scan, as JAX's does there (2048: past the 768 the
# GRU scan's kernels once stopped at)
GRU_WIDE = {"bigru": [{"hidden_dim_1": 512}, {"hidden_dim_1": 192},
                      {"hidden_dim_1": 2048}],
            "attn": [{"hidden_dim": 192}]}
# (where, B, T, W, lengths or None for random ones, dtypes) of the GRU scan
# beside the training main path's: an odd width, one whose weight slices
# pass a block's shared memory, the serving shape of attn's flash path,
# and the backwards' wide forms: one row a chain (W=2048) and the
# gradients in device memory (W=12000, where even one row's pass the
# shared memory)
GSCAN_EXTRA = [("odd width", 8, 1920, 96, None, DTYPES),
               ("wide", 8, 1920, 512, None, DTYPES),
               ("serving", 3, WIDE_T, 256, WIDE_LENGTHS, DTYPES),
               ("one row", 3, 128, 2048, None, DTYPES),
               ("gradients in device memory", 2, 16, 12000, None,
                ("float32",))]
# the two scans: gates per hidden unit and residuals a step, in W
SCAN_GATES = {"lstm": (4, 5), "gru": (3, 4)}


def scan_inputs(lengths, t_len, w, dt, gen, cell="lstm"):
    """xg [T, B, gW], wh [W, gW], bh [gW] (the GRU's; None for the LSTM),
    dy [T, B, W] (0 on padded frames) and the lengths on the card."""
    import torch

    b = len(lengths)
    g = SCAN_GATES[cell][0]
    xg = torch.randn(t_len, b, g * w, generator=gen) * 0.5
    wh = (torch.rand(w, g * w, generator=gen) * 2 - 1) / w ** 0.5
    bh = ((torch.rand(g * w, generator=gen) * 2 - 1) / w ** 0.5).to(
        "cuda", dt) if cell == "gru" else None
    valid = torch.arange(t_len)[:, None] < torch.as_tensor(lengths)[None, :]
    dy = torch.randn(t_len, b, w, generator=gen) * valid[:, :, None]
    return (xg.to("cuda", dt), wh.to("cuda", dt), bh, dy.to("cuda", dt),
            torch.as_tensor(lengths, dtype=torch.int64))


def scan_bound(name, t_len, b, w, dt_name, simt=False):
    """Least time (ms) of one scan kernel on this input.  Per frame row,
    in W: the LSTM forward reads xg (4) and writes ys and cs (the saving
    form also res, 5); its backwards read res (5; recompute: xg 4 and cs)
    and hp, cp, dy and write dxg (4).  The GRU forward reads xg (3) and
    writes ys (the saving form also res, 4); its backwards read res (4;
    recompute: xg 3) and hp, dy and write dxg (3).  wh (and the GRU's bh)
    read once, dwh (and dbh) written once.  Operations: 2*T*B*W*gW a
    product -- the hidden product forward, the carry product and dwh
    backward, and the recomputed gates -- at the dtype's peak; in f32 the
    saved-gates backwards (rows 15 and 11) with dwh on the tensor cores
    (3xTF32) and their carry product at the f32 SIMT peak (``tc_bound``),
    unless ``simt`` (in bf16 both products are at bf16's tensor-core peak
    either way: the kernel's f32 carry product is its design, not the
    card's limit)."""
    size = 4 if dt_name == "float32" else 2
    per_row = {"lstm_scan_fwd": 6, "lstm_scan_fwd_save": 11,
               "lstm_scan_bwd_saved": 12, "lstm_scan_bwd": 12,
               "gru_scan_fwd": 4, "gru_scan_fwd_save": 8,
               "gru_scan_bwd_saved": 9, "gru_scan_bwd": 8}[name]
    cell, _, kind = name.partition("_scan_")
    g = SCAN_GATES[cell][0]
    weights = (g * w * w + (g * w if cell == "gru" else 0)) * (
        1 if kind.startswith("fwd") else 2)
    products = {"fwd": 1, "fwd_save": 1, "bwd_saved": 2, "bwd": 3}[kind]
    n_bytes = (t_len * b * w * per_row + weights) * size
    flops = products * 2 * t_len * b * w * g * w
    if kind == "bwd_saved" and dt_name == "float32" and not simt:
        return tc_bound(n_bytes, flops / 2, flops / 2, dt_name)
    return _bound(n_bytes, flops, dt_name)


def library_rnn(cell, x, lengths, w):
    """The yardstick: ``nn.LSTM`` or ``nn.GRU`` (one direction, hidden W,
    input W) on a packed sequence, in x's dtype.  It also computes the
    input projection that the scan takes precomputed.  Returns
    ``(forward, forward with autograd, autograd.grad through it)``
    callables; timed here only."""
    import torch

    net = (torch.nn.LSTM if cell == "lstm" else torch.nn.GRU)(
        w, w, device="cuda", dtype=x.dtype)
    net.flatten_parameters()
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        x, lengths, enforce_sorted=False)

    def fwd():
        return net(packed)[0]

    leaves = [x.detach().requires_grad_(True), *net.parameters()]
    out = torch.nn.utils.rnn.pack_padded_sequence(
        leaves[0], lengths, enforce_sorted=False)
    y = net(out)[0].data
    dy = torch.ones_like(y)

    def bwd():
        return torch.autograd.grad(y, leaves, dy, retain_graph=True)

    return fwd, fwd, bwd


def scan_calls(cell, xg, wh, bh, dy):
    """``{entry: (wrapper, plain version, arguments)}`` of one scan's four
    kernels on one input."""
    from pytorch_video_action_tpu_torch.ops import rnn_scan as RS

    if cell == "gru":
        ys, res = RS.gru_scan_ref(xg, wh, bh, save=True)
        hp = RS._shift(ys)
        return {
            "gru_scan_fwd": (RS.gru_scan_fwd, RS.gru_scan_ref, (xg, wh, bh)),
            "gru_scan_fwd_save": (RS.gru_scan_fwd_save,
                                  lambda *a: RS.gru_scan_ref(*a, save=True),
                                  (xg, wh, bh)),
            "gru_scan_bwd_saved": (RS.gru_scan_bwd_saved,
                                   RS.gru_scan_bwd_saved_ref,
                                   (res, hp, dy, wh)),
            "gru_scan_bwd": (RS.gru_scan_bwd, RS.gru_scan_bwd_ref,
                             (xg, hp, dy, wh, bh))}
    ys, cs, res = RS.lstm_scan_ref(xg, wh, save=True)
    hp, cp = RS._shift(ys), RS._shift(cs)
    return {
        "lstm_scan_fwd": (RS.lstm_scan_fwd, RS.lstm_scan_ref, (xg, wh)),
        "lstm_scan_fwd_save": (RS.lstm_scan_fwd_save,
                               lambda *a: RS.lstm_scan_ref(*a, save=True),
                               (xg, wh)),
        "lstm_scan_bwd_saved": (RS.lstm_scan_bwd_saved,
                                RS.lstm_scan_bwd_saved_ref,
                                (res, hp, cp, dy, wh)),
        "lstm_scan_bwd": (RS.lstm_scan_bwd, RS.lstm_scan_bwd_ref,
                          (xg, hp, cp, cs, dy, wh))}


def _outputs(out):
    """A wrapper's outputs as a tuple (the GRU scan's eval form returns one
    tensor)."""
    return (out,) if not isinstance(out, tuple) else out


def check_scan(where, lengths, t_len, w, dt_name, gen, cell="lstm",
               steps=False) -> dict:
    """Hold the four kernels of one scan (``cell`` lstm or gru) against
    their plain versions on one input (each also against a rerun, bit for
    bit) and time each beside its plain version, nn.LSTM or nn.GRU and its
    bound: ``{entry: [row]}``; the chain kernels' geometry logged.  With
    ``steps`` the kernels of ``STEP_ROWS`` (rows 9, 13, 14, 15) also by
    step part: µs a step of each build of ``SCAN_STEPS`` (``step_us``)."""
    import torch

    from pytorch_video_action_tpu_torch.ops import rnn_scan as RS

    dt = getattr(torch, dt_name)
    b = len(lengths)
    xg, wh, bh, dy, lens = scan_inputs(lengths, t_len, w, dt, gen, cell)
    calls = scan_calls(cell, xg, wh, bh, dy)
    fwd, fwd_save, bwd_saved, bwd = calls
    x = torch.randn(t_len, b, w, generator=gen).to("cuda", dt)
    lib_fwd, lib_train, lib_bwd = library_rnn(cell, x, lens, w)
    lib_ms = {}
    with torch.no_grad():
        lib_ms[fwd] = cuda_ms(lib_fwd, 5, 1)
    lib_ms[fwd_save] = cuda_ms(lib_train, 5, 1)
    lib_ms[bwd_saved] = lib_ms[bwd] = cuda_ms(lib_bwd, 5, 1)
    del lib_fwd, lib_train, lib_bwd
    library = "nn.LSTM" if cell == "lstm" else "nn.GRU"
    tol = TOL[dt_name]
    rows, outs = {}, {}
    for name, (fn, ref, args) in calls.items():
        got = outs[name] = _outputs(fn(*args))
        again = _outputs(fn(*args))
        torch.cuda.synchronize()
        want = _outputs(ref(*args))
        abs_err, err = rel_err(got, want)
        each = [rel_err((g,), (v,))[1] for g, v in zip(got, want)]
        identical = all(torch.equal(a, c) for a, c in zip(got, again))
        ms = cuda_ms(lambda: fn(*args), 5, 1)
        plain_ms = cuda_ms(lambda: ref(*args), 1, 0)
        bound_ms, bound_by = scan_bound(name, t_len, b, w, dt_name)
        geo = RS.scan_launch(name, b, w, dt, xg.device)
        layout = geo._asdict()
        if isinstance(geo, RS.ScanForm):
            shown = (f"cluster of {geo.cluster}, {geo.rows} rows, the "
                     f"{geo.form!r} form")
        else:
            shown = (f"chains of {geo.nc} blocks, {geo.rows} rows, "
                     f"{geo.s} slices, {geo.rounds} rounds, "
                     f"{geo.smem} bytes of shared memory"
                     f"{', gradients in device memory' if geo.gx else ''}")
        rows[name] = [{"where": where, "W": w, "dtype": dt_name, "B": b,
                       "T": t_len, **layout,
                       "max_abs_err": abs_err, "max_rel_err": err,
                       "tol": tol, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": lib_ms[name], "bound_ms": bound_ms,
                       "bound_by": bound_by, "bit_identical_rerun": identical}]
        if name.endswith("_bwd_saved"):
            rows[name][0]["bound_simt_ms"] = scan_bound(
                name, t_len, b, w, dt_name, simt=True)[0]
            shown += (f"; bound counted SIMT "
                      f"{rows[name][0]['bound_simt_ms']:.4f} ms")
        if steps and name in STEP_ROWS:
            kernel = STEP_ROWS[name]
            rows[name][0]["step_us"] = steps_tool().step_us(
                SCAN_STEPS[kernel], fn, args, t_len, cuda_ms, kernel=kernel)
            log(f"[kernel] {name} {where} {dt_name} step split, us a step: "
                + ", ".join(f"{k} {v:.4f}"
                            for k, v in rows[name][0]["step_us"].items()))
        log(f"[kernel] {name} {where} B={b} T={t_len} W={w} {dt_name} "
            f"({shown}): max abs err {abs_err:.3g}, "
            f"max err / max(1, max|plain|) {err:.3g} (tol {tol}; by "
            f"output {', '.join(f'{e:.3g}' for e in each)}), rerun "
            f"bit-identical {identical}, kernel {ms:.4f} ms "
            f"({ms / t_len * 1e3:.3f} us a step), plain {plain_ms:.4f} ms, "
            f"{library} packed (with its input projection) "
            f"{lib_ms[name]:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if not (err <= tol and identical):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"or a rerun: {rows[name][0]}")
    # one kernel a scan's two forwards (rows 13 and 14, rows 9 and 10): the
    # same ys (and the LSTM's cs)
    same = all(torch.equal(a, c) for a, c in
               zip(outs[fwd], outs[fwd_save][:len(outs[fwd])]))
    rows[fwd][0]["equals_saving_form"] = same
    log(f"[kernel] {fwd} {where} {dt_name}: "
        f"{'ys and cs' if cell == 'lstm' else 'ys'} bit for bit those of "
        f"{fwd_save}: {same}")
    if not same:
        raise AssertionError(f"{fwd} and {fwd_save} differ")
    return rows


# ------------------------------------------------------------------ ms_tcn

CONV_PALLAS = "pytorch_video_action_tpu/ops/conv_pallas.py:"
# the conv entries of the kernels line (each a wrapper of ops/conv.py):
# source and the TPU kernel's line in conv_pallas.py
CONV = {"dilated_residual_layer": ("conv_layer_fwd.cu", "86"),
        "dilated_residual_layer_bwd": ("conv_layer_bwd.cu", "415"),
        "fused_stage": ("conv_stage_fwd.cu", "248")}
# ms_tcn: bench.py:66,75 times it at B=8, T=4096, every frame valid; 64
# feature maps, 4 stages of 20 layers, dropout 0.5
B_TCN, T_TCN = 8, 4096
TCN_C, TCN_STAGES, TCN_LAYERS, TCN_RATE = 64, 4, 20, 0.5
# the layer's forms, the train step's (global stream) first
CONV_FORMS = ("global", "eval", "per_video")


def conv_dilations(t_len):
    """d < T, d = T-1, d = T and d >> T."""
    return [1, t_len - 1, t_len, 2 ** 19]


def conv_inputs(lengths, t_len, dt, gen, n_layers=None):
    """One layer's weights ``[w_d, b_d, w_p, b_p]`` at the model's init
    scale (a stage's, stacked, for ``n_layers``), x and dy ``[B, T, 64]``
    with values on the padded rows (as ``conv_in`` leaves them) and the f32
    frame mask, on the card."""
    import torch

    c = TCN_C
    lead = () if n_layers is None else (n_layers,)

    def u(shape, fan_in):
        k = 1.0 / fan_in ** 0.5
        return ((torch.rand(lead + shape, generator=gen) * 2 - 1) * k).to(
            "cuda", dt)

    ws = [u((3, c, c), 3 * c), u((c,), 3 * c),
          u((c, c) if n_layers else (1, c, c), c), u((c,), c)]
    b = len(lengths)
    x, dy = (torch.randn(b, t_len, c, generator=gen).to("cuda", dt)
             for _ in range(2))
    mask = (torch.arange(t_len)[None, :]
            < torch.as_tensor(lengths)[:, None]).to("cuda", torch.float32)
    return ws, x, dy, mask


def conv_rows(lengths, t_len, d):
    """Output rows a product of the layer needs at dilation ``d``: the
    valid frames (the center tap, the 1x1), and the valid frames whose
    side-tap source row lies inside ``[0, T)`` (both side taps)."""
    center = sum(lengths)
    if d >= t_len:
        return center, 0
    return center, sum(max(0, n - d) + max(0, min(n, t_len - d))
                       for n in lengths)


def conv_bound(lengths, t_len, dt_name, dilations, backward=False):
    """Least time (ms) of the layers at ``dilations`` on this input: 2*64*64
    operations a row of each product (forward: the taps and the 1x1;
    backward: the recomputed taps, dh, dw_p, the weight taps and the dx
    taps), against x and y (backward: x, dy and dx) ``[B, T, 64]`` in the
    input dtype, the f32 frame mask and each layer's weights (backward:
    and its gradients), each read or written once."""
    size = 4 if dt_name == "float32" else 2
    c, b = TCN_C, len(lengths)
    flops = 0
    for d in dilations:
        center, side = conv_rows(lengths, t_len, d)
        taps = center + side
        flops += 2 * c * c * (3 * taps + 2 * center if backward
                              else taps + center)
    act = (3 if backward else 2) * b * t_len * c
    weights = len(dilations) * (4 * c * c + 2 * c) * (2 if backward else 1)
    return _bound((act + weights) * size + 4 * b * t_len, flops, dt_name)


def cudnn_chain(x, layers, mask, grad=False):
    """The yardstick: each layer as ``F.conv1d`` (the dilated conv, padding
    d) -> relu -> ``F.conv1d`` (1x1) -> ``(x + out) * mask`` in cuDNN's
    ``[B, 64, T]`` layout (transposed once, outside the timing); d >= T is
    given as T, where the side taps read padding alike.  ``layers``: ``(w_d
    [3, C, C], b_d, w_p [C, C], b_p, d)``.  Returns ``(inputs, run)``, the
    inputs leaves when ``grad``.  Timed here only (TF32 off); the port
    never calls it."""
    import torch.nn.functional as nnf

    t_len = x.shape[1]
    x_ncw = x.transpose(1, 2).contiguous().requires_grad_(grad)
    m = mask.to(x.dtype)[:, None, :]
    params = [(w_d.permute(2, 1, 0).contiguous().requires_grad_(grad),
               b_d.clone().requires_grad_(grad),
               w_p.t().contiguous()[:, :, None].requires_grad_(grad),
               b_p.clone().requires_grad_(grad), min(d, t_len))
              for w_d, b_d, w_p, b_p, d in layers]

    def run():
        h = x_ncw
        for wc, bc, w1, b1, d in params:
            out = nnf.relu(nnf.conv1d(h, wc, bc, padding=d, dilation=d))
            h = (h + nnf.conv1d(out, w1, b1)) * m
        return h

    return [x_ncw] + [p for layer in params for p in layer[:4]], run


def _conv_row(where, lengths, t_len, dt_name, ms, plain_ms, lib_ms, bound,
              **extra):
    return {"where": where, "dtype": dt_name, "B": len(lengths), "T": t_len,
            **extra, "tol": TOL[dt_name], "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound[0], "bound_by": bound[1]}


def check_conv_layer(where, lengths, t_len, dt_name, gen):
    """Hold the layer kernel in each form against ``layer_ref`` at each of
    ``conv_dilations``, and time it beside the plain version, the cuDNN
    yardstick (eval chain) and its bound.  Returns its rows."""
    import torch

    from pytorch_video_action_tpu_torch.ops import conv as CV

    dt = getattr(torch, dt_name)
    ws, x, _, mask = conv_inputs(lengths, t_len, dt, gen)
    b, tol, rows = len(lengths), TOL[dt_name], []
    for form in CONV_FORMS:
        keep = 1.0 if form == "eval" else 1.0 - TCN_RATE
        kw = {"global": {"seed": 321}, "eval": {},
              "per_video": {"seeds": list(range(7, 7 + b))}}[form]
        for d in conv_dilations(t_len):
            args = (*ws, x, mask, d, keep)
            got = CV.dilated_residual_layer(*args, **kw)
            torch.cuda.synchronize()
            abs_err, err = rel_err([got], [CV.layer_ref(*args, **kw)])
            ms = cuda_ms(lambda: CV.dilated_residual_layer(*args, **kw), 10,
                         2)
            plain_ms = cuda_ms(lambda: CV.layer_ref(*args, **kw), 2)
            _, run = cudnn_chain(x, [(ws[0], ws[1], ws[2][0], ws[3], d)],
                                 mask)
            with torch.no_grad():
                lib_ms = cuda_ms(run, 10, 2)
            bound = conv_bound(lengths, t_len, dt_name, [d])
            row = _conv_row(where, lengths, t_len, dt_name, ms, plain_ms,
                            lib_ms, bound, form=form, dilation=d,
                            max_abs_err=abs_err, max_rel_err=err)
            log(f"[kernel] dilated_residual_layer {form} {where} B={b} "
                f"T={t_len} d={d} {dt_name}: max abs err {abs_err:.3g}, "
                f"err / max(1, max|plain|) {err:.3g} (tol {tol}), kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN chain "
                f"{lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
            if not err <= tol:
                raise AssertionError(f"layer kernel disagrees with its plain "
                                     f"version: {row}")
            rows.append(row)
    return rows


def check_conv_bwd(where, lengths, t_len, dt_name, keep, gen):
    """Hold the layer's backward against ``layer_bwd_ref`` at each of
    ``conv_dilations``, rerun it (bit for bit), and time it beside the
    plain version, ``autograd.grad`` through the cuDNN chain and its bound.
    Returns its rows."""
    import torch

    from pytorch_video_action_tpu_torch.ops import conv as CV

    dt = getattr(torch, dt_name)
    ws, x, dy, mask = conv_inputs(lengths, t_len, dt, gen)
    b, tol, rows = len(lengths), TOL[dt_name], []
    for d in conv_dilations(t_len):
        args = (ws[0], ws[1], ws[2], x, mask, dy, d, keep, 99)
        got = CV.dilated_residual_layer_bwd(*args)
        again = CV.dilated_residual_layer_bwd(*args)
        torch.cuda.synchronize()
        identical = all(torch.equal(g, a) for g, a in zip(got, again))
        abs_err, err = rel_err(got, CV.layer_bwd_ref(*args))
        ms = cuda_ms(lambda: CV.dilated_residual_layer_bwd(*args), 5, 1)
        plain_ms = cuda_ms(lambda: CV.layer_bwd_ref(*args), 2)
        leaves, run = cudnn_chain(x, [(ws[0], ws[1], ws[2][0], ws[3], d)],
                                  mask, grad=True)
        out = run()
        dy_ncw = dy.transpose(1, 2).contiguous()
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            out, leaves, dy_ncw, retain_graph=True), 5, 1)
        bound = conv_bound(lengths, t_len, dt_name, [d], backward=True)
        row = _conv_row(where, lengths, t_len, dt_name, ms, plain_ms, lib_ms,
                        bound, keep=keep, dilation=d, max_abs_err=abs_err,
                        max_rel_err=err, bit_identical_rerun=identical)
        log(f"[kernel] dilated_residual_layer_bwd {where} B={b} T={t_len} "
            f"d={d} {dt_name} keep {keep}: max abs err {abs_err:.3g}, max "
            f"err / max(1, max|plain|) {err:.3g} (tol {tol}), rerun "
            f"bit-identical {identical}, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, autograd.grad through the cuDNN chain "
            f"{lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
        if not err <= tol:
            raise AssertionError(f"layer backward disagrees with its plain "
                                 f"version: {row}")
        if not identical:
            raise AssertionError("two layer backward runs differ")
        rows.append(row)
    return rows


def check_fused_stage(where, lengths, t_len, dt_name, keep, gen):
    """Hold the stage kernel (20 layers, dilations 2^i) against
    ``stage_ref`` and time it beside the plain version, the 20-layer cuDNN
    chain and its bound.  Returns its row."""
    import torch

    from pytorch_video_action_tpu_torch.ops import conv as CV

    dt = getattr(torch, dt_name)
    ws, x, _, mask = conv_inputs(lengths, t_len, dt, gen, TCN_LAYERS)
    b = len(lengths)
    seeds = (torch.randint(0, 2 ** 32, (b, TCN_LAYERS), generator=gen)
             if keep < 1.0 else None)
    args = (*ws, x, mask, keep, seeds)
    got = CV.fused_stage(*args)
    torch.cuda.synchronize()
    abs_err, err = rel_err([got], [CV.stage_ref(*args)])
    ms = cuda_ms(lambda: CV.fused_stage(*args), 10, 2)
    plain_ms = cuda_ms(lambda: CV.stage_ref(*args), 1)
    dilations = CV.stage_dilations(TCN_LAYERS, t_len)
    _, run = cudnn_chain(x, [(ws[0][i], ws[1][i], ws[2][i], ws[3][i], d)
                             for i, d in enumerate(dilations)], mask)
    with torch.no_grad():
        lib_ms = cuda_ms(run, 10, 2)
    bound = conv_bound(lengths, t_len, dt_name, dilations)
    tol = TOL[dt_name]
    row = _conv_row(where, lengths, t_len, dt_name, ms, plain_ms, lib_ms,
                    bound, keep=keep, max_abs_err=abs_err, max_rel_err=err)
    log(f"[kernel] fused_stage {where} B={b} T={t_len} {dt_name} keep {keep} "
        f"({TCN_LAYERS} layers, {sum(d < t_len for d in dilations)} with side "
        f"taps): max abs err {abs_err:.3g}, err / max(1, max|plain|) "
        f"{err:.3g} (tol {tol}), kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, cuDNN chain {lib_ms:.4f} ms, bound {bound[0]:.4f} ms "
        f"({bound[1]})")
    if not err <= tol:
        raise AssertionError(f"stage kernel disagrees with its plain "
                             f"version: {row}")
    return row


def check_conv(where, lengths, t_len, gen, kinds=("layer", "bwd", "stage")):
    """The conv kernels on one input shape, f32 first then bf16: the layer's
    forms, its backward at dropout 0.5 then 0, the stage at keep 1 then
    0.5.  Returns ``{entry: rows}``, each entry's f32 headline first."""
    rows = {}
    if "layer" in kinds:
        rows["dilated_residual_layer"] = [
            r for dt in DTYPES
            for r in check_conv_layer(where, lengths, t_len, dt, gen)]
    if "bwd" in kinds:
        rows["dilated_residual_layer_bwd"] = [
            r for keep in (1.0 - TCN_RATE, 1.0) for dt in DTYPES
            for r in check_conv_bwd(where, lengths, t_len, dt, keep, gen)]
    if "stage" in kinds:
        rows["fused_stage"] = [
            check_fused_stage(where, lengths, t_len, dt, keep, gen)
            for keep in (1.0, 1.0 - TCN_RATE) for dt in DTYPES]
    return rows


# ------------------------------------------------------------------ slice

N_CLASS = 48


def write_dataset(root: str, seed: int = 0, train: bool = True,
                  frames=(500, 2500)) -> None:
    """Breakfast-shaped tree: 48 classes, 24 dev and 24 test videos (and 48
    train videos unless ``train`` is False) of ``frames`` (500-2500 by
    default) frames, gz text features, ground truth and segment.txt."""
    rng = np.random.default_rng(seed)
    names = ["SIL"] + [f"action_{i:02d}" for i in range(1, N_CLASS)]
    means = rng.normal(0.0, 1.0, size=(N_CLASS, 400)).astype(np.float32)
    for d in ("splits/splits", "splits/new_splits", "groundTruth/groundTruth",
              "data"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    with open(os.path.join(root, "splits/splits/mapping_bf.txt"), "w") as f:
        f.write("".join(f"{i} {n}\n" for i, n in enumerate(names)))

    def video():
        t_len = int(rng.integers(frames[0], frames[1] + 1))
        labels = np.zeros(t_len, dtype=np.int64)
        edge = min(50, t_len // 5)
        cuts = np.sort(rng.choice(np.arange(edge, t_len - edge), 6,
                                  replace=False))
        for a, b in zip(cuts[:-1], cuts[1:]):
            labels[a:b] = rng.integers(1, N_CLASS)
        feats = means[labels] + rng.normal(0, 0.5, (t_len, 400))
        return feats.astype(np.float32), labels

    # (part, videos, file-name letter, bundle); train last, so that the dev
    # and test videos do not depend on whether it is written
    parts = [("dev", 24, "D", "splits/new_splits/dev.split0.bundle"),
             ("test", 24, "T", "splits/splits/test.split1.bundle")]
    if train:
        parts.append(("train", 48, "P", "splits/new_splits/train.split0.bundle"))
    seg_lines = []
    for part, count, letter, bundle in parts:
        files = []
        for i in range(count):
            stem = f"{letter}{i:02d}_cam01_{letter}{i:02d}_cereals"
            feats, labels = video()
            with gzip.open(os.path.join(root, "data", f"{stem}.gz"), "wb",
                           compresslevel=1) as f:
                np.savetxt(f, feats, fmt="%.4f")
            with open(os.path.join(root, "groundTruth/groundTruth",
                                   f"{stem}.txt"), "w") as f:
                f.write("".join(names[l] + "\n" for l in labels))
            files.append(stem)
            if part == "test":
                active = np.nonzero(labels)[0]
                start, end = int(active[0]), int(active[-1]) + 1
                bounds = [start] + [t for t in range(start + 1, end)
                                    if labels[t] != labels[t - 1]] + [end]
                seg_lines.append(" ".join(map(str, bounds)))
        with open(os.path.join(root, bundle), "w") as f:
            f.write("#bundle\n" + "".join(
                f"./data/groundTruth/{s}.txt\n" for s in files))
    with open(os.path.join(root, "segment.txt"), "w") as f:
        f.write("\n".join(seg_lines) + "\n")


def read_csv_labels(path: str) -> list[int]:
    with open(path) as f:
        content = f.read()
    lines = content.split("\n")
    if lines[0] != "Id,Category" or content.endswith("\n"):
        raise AssertionError(f"bad CSV format in {path}")
    out = []
    for i, line in enumerate(lines[1:]):
        idx, label = line.split(",")
        if int(idx) != i:
            raise AssertionError(f"bad CSV row {i}: {line!r}")
        out.append(int(label))
    return out


# the served and trained models: their recurrent layer kernels and layer
# count (attn: one GRU layer after the attention; win_attn: none), or
# ms_tcn's conv stages (mstcn is its name in the inference CLIs)
MODELS = {"bigru": ("gru", 4), "ctcloss": ("gru", 4), "simple_fc": (None, 0),
          "vanilla_lstm": ("scan", 2), "bilstm": ("lstm", 2),
          "bilstm_lm": ("lstm", 2), "attn": ("gru", 1),
          "win_attn": (None, 0), "ms_tcn": ("conv", TCN_STAGES),
          "mstcn": ("conv", TCN_STAGES)}


def cell_of(name):
    return {"gru": GRU, "lstm": LSTM}.get(MODELS[name][0])


def serve_layers(name):
    """Layers of the inference CLIs' ``name`` (None: the train CLI's)."""
    return VANILLA_SERVE if name == "vanilla_lstm" else None


def merge_rows(parts) -> dict:
    """``{entry: rows}`` dicts joined entry by entry."""
    out = {}
    for part in parts:
        for k, v in part.items():
            out.setdefault(k, []).extend(v)
    return out


def counters() -> dict:
    """Every kernel wrapper's launch count, by kernels-line entry."""
    from pytorch_video_action_tpu_torch.ops import conv as CV
    from pytorch_video_action_tpu_torch.ops import flash as F
    from pytorch_video_action_tpu_torch.ops import rnn_scan as RS

    out = {name: getattr(RS, name).launches for name in (*SCAN, *GSCAN)}
    for cell in (GRU, LSTM):
        for fwd, bwd, name, bname in (
                (cell.fwd, cell.bwd, cell.fwd_name, cell.bwd_name),
                (cell.mfwd, cell.mbwd, cell.mfwd_name, cell.mbwd_name)):
            out[name] = fwd.launches
            out[name + "_train"] = fwd.train_launches
            out[bname] = bwd.launches
    for name in (*FLASH, *BTHD):
        out[name] = getattr(F, name).launches
    for name in CONV:
        out[name] = getattr(CV, name).launches
    out["gru_bidir_bnd_fwd"] = GRU.bfwd.launches
    out["gru_bidir_bnd_fwd_train"] = GRU.bfwd.train_launches
    out["gru_bidir_bnd_bwd"] = GRU.bbwd.launches
    return out


def reset_counters() -> None:
    from pytorch_video_action_tpu_torch.ops import conv as CV
    from pytorch_video_action_tpu_torch.ops import flash as F
    from pytorch_video_action_tpu_torch.ops import rnn_scan as RS

    for name in (*SCAN, *GSCAN):
        getattr(RS, name).launches = 0
    for cell in (GRU, LSTM):
        for fwd, bwd in ((cell.fwd, cell.bwd), (cell.mfwd, cell.mbwd)):
            fwd.launches = fwd.train_launches = bwd.launches = 0
    for name in (*FLASH, *BTHD):
        getattr(F, name).launches = 0
    for name in CONV:
        getattr(CV, name).launches = 0
    GRU.bfwd.launches = GRU.bfwd.train_launches = GRU.bbwd.launches = 0


def expected_launches(name, forwards=(), steps=(), n_layers=None,
                      merged=False, boundary=False, bthd=False) -> dict:
    """Every kernel's launches in a run of ``name`` (``n_layers`` layers, by
    default the train CLI's) whose eval forwards and train steps have the
    ``(B, padded T)`` of ``forwards`` and ``steps``: per layer one eval
    form a forward, one train form and one backward a step (with
    ``merged``, the ``PVA_RNN_SPLIT=0`` route, of rows 5-8; with
    ``boundary``, ``PVA_RNN_FUSED_BOUNDARY=1``, the GRU's layers after the
    first of rows 1 alt and 2 alt; vanilla_lstm: the scan's eval form, its
    saving form and its saved-gates backward); for attn at padded T >=
    BLOCKWISE_MIN_T one flash forward a forward or step and one flash
    backward a step, fused or split as the port's dispatch picks (with
    ``bthd``, ``PVA_FLASH_BTHD=1``, the head-major forward and fused
    backward at d = 128); for ms_tcn one stage launch a stage a forward
    and one layer forward and one layer backward a layer a step."""
    from pytorch_video_action_tpu_torch.models import attention

    out = dict.fromkeys(counters(), 0)
    cell = cell_of(name)
    if n_layers is None:
        n_layers = MODELS[name][1]
    if MODELS[name][0] == "scan":
        out["lstm_scan_fwd"] = n_layers * len(forwards)
        out["lstm_scan_fwd_save"] = out["lstm_scan_bwd_saved"] = (
            n_layers * len(steps))
    if cell is not None:
        fwd, bwd = ((cell.mfwd_name, cell.mbwd_name) if merged
                    else (cell.fwd_name, cell.bwd_name))
        out[fwd] = n_layers * len(forwards)
        out[fwd + "_train"] = n_layers * len(steps)
        out[bwd] = n_layers * len(steps)
        if boundary and n_layers > 1:
            out[fwd], out[fwd + "_train"], out[bwd] = (
                len(forwards), len(steps), len(steps))
            out["gru_bidir_bnd_fwd"] = (n_layers - 1) * len(forwards)
            out["gru_bidir_bnd_fwd_train"] = out["gru_bidir_bnd_bwd"] = (
                (n_layers - 1) * len(steps))
    if name == "attn":
        min_t = attention.BLOCKWISE_MIN_T
        fwd, fused_bwd = (("flash_fwd_bthd", "flash_bwd_fused_bthd") if bthd
                          else ("flash_fwd", "flash_bwd_fused"))
        out[fwd] = sum(t >= min_t for _, t in (*forwards, *steps))
        long_steps = [(b, t) for b, t in steps if t >= min_t]
        fused = sum(use_fused(b, t, d=BTHD_D if bthd else None)
                    for b, t in long_steps)
        out[fused_bwd] = fused
        out["flash_bwd_dkdv"] = out["flash_bwd_dq"] = len(long_steps) - fused
    if MODELS[name][0] == "conv":
        out["fused_stage"] = TCN_STAGES * len(forwards)
        out["dilated_residual_layer"] = out["dilated_residual_layer_bwd"] = (
            TCN_STAGES * TCN_LAYERS * len(steps))
    return out


def add_launches(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


@contextlib.contextmanager
def blockwise_min_t(value: int):
    """The port's flash threshold set to ``value`` inside the block."""
    from pytorch_video_action_tpu_torch.models import attention

    old = attention.BLOCKWISE_MIN_T
    attention.BLOCKWISE_MIN_T = value
    try:
        yield
    finally:
        attention.BLOCKWISE_MIN_T = old


def save_checkpoint(root: str, name: str) -> str:
    """A full-width checkpoint of ``name`` from seeded weights (the
    inference CLI's default configuration); returns its file name."""
    import torch

    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.models.params import to_jax_params
    from pytorch_video_action_tpu_torch.train.checkpoint import save_params

    model = build_model(name, N_CLASS, defaults=True,
                        generator=torch.Generator().manual_seed(0))
    ckpt = f"{name}_00.00_dev"
    save_params(os.path.join(root, "models", f"{ckpt}.npz"),
                to_jax_params(name, model.state_dict()))
    return ckpt


def phase_slice(card: str, root: str, name: str, ckpt: str | None = None):
    """The inference slice of ``name`` on the dataset under ``root`` (the
    cwd), serving ``ckpt`` (by default a checkpoint of seeded weights).
    Returns its checkpoint name, the launches of its CLI runs and its
    kernel rows, each by kernels-line entry."""
    import torch

    from pytorch_video_action_tpu_torch.cli import inference_cli
    from pytorch_video_action_tpu_torch.data.bundles import load_segment_file
    from pytorch_video_action_tpu_torch.data.dataset import VideoDataset
    from pytorch_video_action_tpu_torch.infer.predict import forward_batches
    from pytorch_video_action_tpu_torch.models import attention

    cell = cell_of(name)
    launches = {}
    if ckpt is None:
        ckpt = save_checkpoint(root, name)
    base = ["--pretrained_model", ckpt, "--prob", "big",
            "--data_dir", os.path.join(root, "data"), "--annot_path", root]
    n_segments = sum(len(s) - 1 for s in
                     load_segment_file(os.path.join(root, "segment.txt")))
    datasets = {
        "test": VideoDataset(data_dir="data", annot_path=root, part="test",
                             split=1, mode=None, verbose=False),
        "dev": VideoDataset(data_dir="data", annot_path=root, part="dev",
                            split=0, mode="active", verbose=False)}

    # the kernels at the largest shape the slice gives them: the forward
    # batch of the test part with the most frames (attn: of those padded to
    # the flash path), its own lengths
    feats = datasets["test"].features
    gen = torch.Generator().manual_seed(1)
    batches = forward_batches(feats)
    if name == "attn":
        batches = [tb for tb in batches
                   if tb[0] >= attention.BLOCKWISE_MIN_T]
    t_pad, chunk = max(batches, key=lambda tb: tb[0] * len(tb[1]))
    lens = [len(feats[i]) for i in chunk]
    if name == "attn":
        rows = check_flash("main path", lens, t_pad, gen,
                           fwd=[(dt, r) for dt in DTYPES
                                for r in (0.0, ATTN_RATE)], bwd=[])
    elif MODELS[name][0] == "scan":
        rows = merge_rows(check_scan("main path", lens, t_pad, 64, dt, gen,
                                     steps=True) for dt in DTYPES)
    elif MODELS[name][0] == "conv":
        rows = check_conv("main path", lens, t_pad, gen, kinds=("stage",))
    elif cell is not None:
        rows = {cell.fwd_name: check_layers(
            cell, "main path", lens, t_pad, gen,
            steps=DTYPES if name == "bigru" else ())}
    else:  # simple_fc: no kernel
        rows = {}

    csv = {}
    for dt_name in DTYPES:
        for part in ("test", "dev"):
            expect = expected_launches(name, forwards=[
                (len(c), t) for t, c in
                forward_batches(datasets[part].features)],
                n_layers=serve_layers(name))
            reset_counters()
            t0 = time.time()
            out = inference_cli.main(base + ["--part", part, "--dtype",
                                             dt_name, "--device", "cuda"])
            seconds = time.time() - t0
            got = counters()
            add_launches(launches, got)
            log(f"[slice] {name} cuda {dt_name} --part {part}: "
                f"{'csv ' + out if part == 'test' else f'accuracy {out:.2f}'}"
                f" in {seconds:.1f} s, launches {nonzero(got)} (expected "
                f"{nonzero(expect)})")
            if got != expect:
                raise AssertionError("launch counts do not match the "
                                     "forward batches")
            if part == "test":
                labels = read_csv_labels(out)
                if len(labels) != n_segments:
                    raise AssertionError(f"CSV has {len(labels)} rows, "
                                         f"segment.txt {n_segments}")
                if not all(0 <= l < N_CLASS for l in labels):
                    raise AssertionError("CSV label out of range")
                csv[dt_name] = labels
            elif not 0.0 <= out <= 100.0:
                raise AssertionError(f"dev accuracy {out}")

    t0 = time.time()
    cpu_csv = read_csv_labels(inference_cli.main(
        base + ["--part", "test", "--device", "cpu"]))
    agree = float(np.mean(np.asarray(cpu_csv) == np.asarray(csv["float32"])))
    agree16 = float(np.mean(np.asarray(csv["bfloat16"])
                            == np.asarray(csv["float32"])))
    log(f"[slice] {name} cpu float32 --part test in {time.time() - t0:.1f} "
        f"s; segment labels cuda f32 vs cpu f32 agree {agree:.4f}, "
        f"cuda bf16 vs cuda f32 agree {agree16:.4f}")
    if agree < 0.99:
        raise AssertionError("GPU and CPU segment labels disagree")

    forward_frames_per_sec(card, name, ckpt, feats)
    return ckpt, launches, rows


def forward_frames_per_sec(card, name, ckpt, feats, where=""):
    """Host clock around synchronised ``frame_predictions`` of the served
    checkpoint over ``feats``, f32 and bf16, after a warm-up each."""
    import torch

    from pytorch_video_action_tpu_torch.infer.loader import load_models
    from pytorch_video_action_tpu_torch.infer.predict import (
        frame_predictions)

    n_frames = sum(len(f) for f in feats)
    gpu_model = load_models([ckpt], N_CLASS, models_dir="models",
                            device="cuda")[ckpt]
    for dt_name in DTYPES:
        frame_predictions(gpu_model, feats, dtype=dt_name)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame_predictions(gpu_model, feats, dtype=dt_name)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        log(f"[slice] {name}{where} forward {dt_name}: {n_frames} frames of "
            f"{len(feats)} test videos in {seconds:.4f} s = "
            f"{n_frames / seconds:.0f} frames/s (batch 8, bucket 128) "
            f"on {card}")


def phase_ensemble(root: str, ckpts: list[str]) -> dict:
    """The inference CLI serves the checkpoints as one ensemble on the card
    (test part, f32).  Returns the launches by kernels-line entry."""
    from pytorch_video_action_tpu_torch.cli import inference_cli
    from pytorch_video_action_tpu_torch.data.dataset import VideoDataset
    from pytorch_video_action_tpu_torch.infer.loader import parse_model_type
    from pytorch_video_action_tpu_torch.infer.predict import forward_batches

    forwards = [(len(c), t) for t, c in forward_batches(VideoDataset(
        data_dir="data", annot_path=root, part="test", split=1, mode=None,
        verbose=False).features)]
    expect = {}
    for ckpt in ckpts:
        name = parse_model_type(ckpt)
        add_launches(expect, expected_launches(
            name, forwards=forwards, n_layers=serve_layers(name)))
    reset_counters()
    out = inference_cli.main(["--pretrained_model", *ckpts, "--prob", "big",
                              "--part", "test", "--data_dir",
                              os.path.join(root, "data"), "--annot_path",
                              root, "--device", "cuda"])
    got = counters()
    labels = read_csv_labels(out)
    log(f"[slice] ensemble {' + '.join(ckpts)} on the card: {len(labels)} "
        f"CSV rows, launches {nonzero(got)} (expected {nonzero(expect)})")
    if got != expect:
        raise AssertionError("ensemble launch counts do not match")
    if not (labels and all(0 <= l < N_CLASS for l in labels)):
        raise AssertionError("the ensemble serves no CSV")
    return got


# ---------------------------------------------------------------- training

TRAIN_EPOCHS, TRAIN_BATCH = 2, 8
GRAD_TOL = 1e-3  # card against CPU, f32, relative to each tensor's max


def train_feeds(root: str):
    """The train CLI's feeds on the dataset under ``root``: the train feed
    (frozen composition, seed 0) and the dev feed."""
    from pytorch_video_action_tpu_torch.data import (
        BatchFeed, BucketBatchSampler, VideoDataset)

    kw = dict(data_dir="data", annot_path=root, split=0, mode="active",
              verbose=False)
    train_ds = VideoDataset(part="train", **kw)
    dev_ds = VideoDataset(part="dev", **kw)
    sampler = BucketBatchSampler(train_ds.features, TRAIN_BATCH, seed=0,
                                 freeze_composition=True)
    return (BatchFeed(train_ds, batch_sampler=sampler),
            BatchFeed(dev_ds, batch_size=TRAIN_BATCH))


def feed_shapes(feed) -> list:
    """``(B, padded T)`` of each batch of one epoch of ``feed``."""
    return [tuple(feed.collate(ix)[0].shape[:2])
            for ix in feed.index_batches()]


def epoch_records(path: str) -> list[dict]:
    """The ``epoch`` records of a ``--metrics_jsonl`` file."""
    with open(path) as f:
        records = [json.loads(line) for line in f]
    return [r for r in records if r["event"] == "epoch"]


def check_grads_against_cpu(name, batch, where="", **flags):
    """One f32 train step of ``name`` (built with ``flags``) on the card and
    on the CPU, from the same parameters, batch and seeds; raises when a
    gradient differs by more than ``GRAD_TOL`` of its tensor's largest
    element.  Returns the gradients by device."""
    import torch

    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.train.loop import Trainer

    state = build_model(name, N_CLASS, **flags,
                        generator=torch.Generator().manual_seed(2)).state_dict()
    grads, losses = {}, {}
    for device in ("cuda", "cpu"):
        model = build_model(name, N_CLASS, **flags)
        model.load_state_dict(state)
        trainer = Trainer(model, N_CLASS, seed=0, device=device)
        ts = trainer.init_state()
        seeds = list(range(11, 11 + model.n_dropout_sites))
        losses[device] = trainer.train_step(ts, batch, seeds=seeds).item()
        grads[device] = {k: p.grad.detach().cpu()
                         for k, p in ts.model.named_parameters()
                         if p.grad is not None}
    worst, worst_k = 0.0, None
    for k, want in grads["cpu"].items():
        err = ((grads["cuda"][k] - want).abs().max()
               / want.abs().max().clamp(min=1e-30)).item()
        if err >= worst:
            worst, worst_k = err, k
    log(f"[train] {name}{where} one f32 step, B={batch[0].shape[0]} "
        f"T={batch[0].shape[1]}: loss cuda {losses['cuda']:.6f} cpu "
        f"{losses['cpu']:.6f}; worst gradient difference / max|cpu "
        f"gradient| {worst:.3g} ({worst_k}; tol {GRAD_TOL})")
    if (grads["cuda"].keys() != grads["cpu"].keys() or not worst <= GRAD_TOL
            or abs(losses["cuda"] - losses["cpu"]) > 1e-4):
        raise AssertionError("card and CPU train steps disagree")
    return grads


def check_relu_grads(batch, name="simple_fc"):
    """simple_fc's one-step check on the card.  Its ReLUs make the plain
    card-against-CPU comparison depend on branches: a pre-activation
    within f32 rounding of 0 can land on the other side of the ReLU on the
    card than on the CPU, and that frame's whole gradient term then moves
    (on the chip dataset's smallest batch one such ReLU moves ``fc1.w`` by
    2.2e-3 of its largest element).  So the card's f32 step
    (the Trainer's loss, NLL over the raw logits) is held against a float64
    step on the CPU that takes the card's own ReLU branches, within
    ``GRAD_TOL``; the plain f32 comparison, the branches that differ from
    float64's own and the largest float64 pre-activation among them are
    logged."""
    import torch

    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.train.losses import nll_loss

    state = build_model(name, N_CLASS,
                        generator=torch.Generator().manual_seed(2)).state_dict()
    x = torch.from_numpy(np.asarray(batch[0], np.float32))
    targets = torch.from_numpy(np.asarray(batch[2], np.int64))

    def step(device, dtype, masks=None):
        model = build_model(name, N_CLASS)
        model.load_state_dict(state)
        model = model.to(device, dtype)
        h, branches, pre = x.to(device, dtype), [], []
        layers = (model.fc1, model.fc2, model.fc3, model.fc4)
        for i, layer in enumerate(layers):
            h = layer(h)
            if i + 1 < len(layers):
                branches.append((h > 0).cpu())
                pre.append(h.detach().double().cpu())
                h = (h * masks[i].to(device, dtype) if masks is not None
                     else torch.relu(h))
        nll_loss(h.to(torch.promote_types(dtype, torch.float32)),
                 targets.to(device)).backward()
        return ({k: p.grad.detach().double().cpu()
                 for k, p in model.named_parameters()}, branches, pre)

    def worst(got, want):
        return max((((got[k] - w).abs().max() / w.abs().max()).item(), k)
                   for k, w in want.items())

    card, card_branches, _ = step("cuda", torch.float32)
    cpu, _, _ = step("cpu", torch.float32)
    _, f64_branches, f64_pre = step("cpu", torch.float64)
    ref, _, _ = step("cpu", torch.float64, card_branches)
    differ = [a != b for a, b in zip(card_branches, f64_branches)]
    flips = [int(d.sum()) for d in differ]
    flip_pre = max((float(p[d].abs().max()) for p, d in zip(f64_pre, differ)
                    if d.any()), default=0.0)
    err, key = worst(card, ref)
    plain, plain_key = worst(card, cpu)
    log(f"[train] {name} one f32 step, B={x.shape[0]} T={x.shape[1]}: card "
        f"against a float64 CPU step on the card's ReLU branches: worst "
        f"gradient difference / max|gradient| {err:.3g} ({key}; tol "
        f"{GRAD_TOL}); card against the CPU's f32 step {plain:.3g} "
        f"({plain_key}); ReLUs whose branch differs from float64's, by "
        f"layer: {flips}, their float64 pre-activations at most "
        f"{flip_pre:.3g} in magnitude")
    if not err <= GRAD_TOL:
        raise AssertionError(f"{name}: the card's step disagrees with the "
                             "CPU's on the same branches")


def train_frames_per_sec(card, name, feed, dt_name, where="", **flags):
    """Host clock around one epoch of synchronised train steps on prepared
    batches, after one warm-up step (the model built with ``flags``)."""
    import torch

    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.train.loop import Trainer

    model = build_model(name, N_CLASS, **flags,
                        generator=torch.Generator().manual_seed(3))
    trainer = Trainer(model, N_CLASS, seed=0, compute_dtype=dt_name)
    ts = trainer.init_state()
    batches = [trainer.prepare_batch(b) for b in feed]
    frames = sum(int(b[1].sum()) for b in batches)
    trainer.train_step(ts, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        trainer.train_step(ts, b)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log(f"[train] {name}{where}{' ' + str(flags) if flags else ''} train step "
        f"{dt_name}: {frames} frames in "
        f"{len(batches)} steps in {seconds:.4f} s = {frames / seconds:.0f} "
        f"frames/s (batch {TRAIN_BATCH}, bucket 128) on {card}")


def train_cli_run(root, name, dt_name, expect, flags=(), model_flag=True,
                  where=""):
    """The train CLI on the card (with the extra ``flags``; without
    ``--model`` unless ``model_flag``: simple_fc is the CLI's default;
    ``where`` names the run's metrics file and its log lines), with
    every kernel's count set to 0 just before it and read just after.
    Checks the launch counts against ``expect`` and the loss; returns
    ``(best dev accuracy, launches)``."""
    from pytorch_video_action_tpu_torch.cli import train_cli

    metrics = os.path.join(root, f"train_{name}_{dt_name}{where}"
                           f"{'_'.join(('', *flags))}.jsonl")
    reset_counters()
    t0 = time.time()
    best = train_cli.main([
        *(["--model", name] if model_flag else []), "--epoch",
        str(TRAIN_EPOCHS), "--batchsize",
        str(TRAIN_BATCH), "--split", "0", "--data_dir",
        os.path.join(root, "data"), "--annot_path", root, "--dtype",
        dt_name, "--device", "cuda", "--metrics_jsonl", metrics, *flags])
    seconds = time.time() - t0
    got = counters()
    epochs = epoch_records(metrics)
    loss = [r["train_loss"] for r in epochs]
    log(f"[train] {name}{''.join(' ' + f for f in flags)}{where} cuda "
        f"{dt_name} "
        f"train CLI{'' if model_flag else ' (no --model)'}: "
        f"{TRAIN_EPOCHS} epochs in "
        f"{seconds:.1f} s, train loss {loss}, dev segment accuracy "
        f"{[r['dev_segment_acc'] for r in epochs]}, CLI frames/s "
        f"{[r['frames_per_sec'] for r in epochs]}; launches {nonzero(got)} "
        f"(expected {nonzero(expect)})")
    if got != expect:
        raise AssertionError("launch counts do not match the steps")
    if not (len(loss) == TRAIN_EPOCHS and np.all(np.isfinite(loss))
            and loss[1] < loss[0]):
        raise AssertionError(f"train loss {loss}: not finite or not falling")
    return best, got


def phase_train(card: str, root: str, name: str):
    """The training slice of ``name`` on the dataset under ``root`` (the
    cwd).  Returns the launches of its CLI runs and its kernel rows, each
    by kernels-line entry, and the best dev accuracy of its f32 run.
    ctcloss runs bigru's kernels at bigru's shapes, and simple_fc none: no
    kernel rows of their own."""
    import torch

    from pytorch_video_action_tpu_torch.cli import inference_cli
    from pytorch_video_action_tpu_torch.models import (INFERENCE_NAMES,
                                                       attention)

    cell = cell_of(name)
    t0 = time.time()
    train_feed, dev_feed = train_feeds(root)
    steps, forwards = feed_shapes(train_feed), feed_shapes(dev_feed)
    log(f"[train] train and dev parts parsed in {time.time() - t0:.1f} s; "
        f"train batches (B, padded T) {steps}")
    # the kernels at the largest shape training gives them: the train
    # batch with the most padded frames, its own lengths
    idxs = max(train_feed.index_batches(),
               key=lambda ix: max(len(train_feed.dataset.features[i])
                                  for i in ix))
    lens = [len(train_feed.dataset.features[i]) for i in idxs]
    t_pad = train_feed.collate(idxs)[0].shape[1]
    gen = torch.Generator().manual_seed(4)
    if name == "attn":
        forms = [(dt, r) for r in (ATTN_RATE, 0.0) for dt in DTYPES]
        rows = check_flash("main path", lens, t_pad, gen, fwd=forms,
                           bwd=forms)
        # the fused and the split backward at the flash path's other
        # padded lengths (1024 and 1152 go to the fused form, 1536 to the
        # split, on the chip dataset), f32 and bf16: the times that place
        # the dispatch's (use_fused) threshold
        others = {}
        for ix in train_feed.index_batches():
            t_len = train_feed.collate(ix)[0].shape[1]
            if t_len != t_pad and t_len >= attention.BLOCKWISE_MIN_T:
                others.setdefault(t_len, ix)
        if all(use_fused(len(ix), t) for t, ix in others.items()):
            raise AssertionError("no train batch besides the largest goes "
                                 "to the split backward")
        for t_len, ix in sorted(others.items()):
            lens_t = [len(train_feed.dataset.features[i]) for i in ix]
            for k, got in check_flash(
                    "main path", lens_t, t_len, gen, fwd=[],
                    bwd=[(dt, ATTN_RATE) for dt in DTYPES]).items():
                rows[k] += got
    elif MODELS[name][0] == "scan":
        rows = merge_rows(check_scan("main path", lens, t_pad, 256, dt, gen,
                                     steps=True) for dt in DTYPES)
    elif cell is not None and name != "ctcloss":
        # row 1 by step part in both dtypes, row 3 in f32
        train_rows, bwd_rows = check_train_layers(
            cell, "main path", lens, t_pad, gen,
            steps={"bigru": DTYPES, "bilstm": ("float32",)}.get(name, ()))
        rows = {cell.fwd_name + "_train": train_rows,
                cell.bwd_name: bwd_rows}
    elif MODELS[name][0] == "conv":
        rows = check_conv("main path", lens, t_pad, gen,
                          kinds=("layer", "bwd"))
    else:
        rows = {}

    expect = expected_launches(name, forwards=forwards * TRAIN_EPOCHS,
                               steps=steps * TRAIN_EPOCHS)
    launches, bests = {}, {}
    dtypes = ("float32",) if name == "win_attn" else DTYPES
    for dt_name in dtypes:
        best, got = train_cli_run(
            root, name, dt_name, expect,
            model_flag=not (name == "simple_fc" and dt_name == "float32"))
        bests[dt_name] = best
        add_launches(launches, got)
        ckpt = f"{name}_{best:.2f}_dev"
        if name not in INFERENCE_NAMES or name == "vanilla_lstm":
            # win_attn writes class scores on every fifth frame only, so
            # its dev segment accuracy, and with it a checkpoint, may stay
            # 0; the inference CLIs do not serve it, as in JAX.  ms_tcn's
            # checkpoint serves under the name mstcn (phase_slice).  The
            # inference CLIs build vanilla_lstm at H=64 and 1 layer, which
            # a checkpoint of the train CLI's defaults does not fit, as in
            # JAX (phase_vanilla_serving trains one that does).  ctcloss is
            # no inference name; its checkpoint loads into the model.
            log(f"[train] {name}: best dev segment accuracy {best:.2f}")
            if name == "ctcloss":
                check_ctc_checkpoint(best, ckpt)
            continue
        if not os.path.exists(os.path.join("models", f"{ckpt}.npz")):
            raise AssertionError(f"no checkpoint {ckpt}")
        labels = read_csv_labels(inference_cli.main([
            "--pretrained_model", ckpt, "--prob", "big", "--part", "test",
            "--data_dir", os.path.join(root, "data"), "--annot_path", root,
            "--device", "cuda"]))
        if not (labels and all(0 <= l < N_CLASS for l in labels)):
            raise AssertionError("the trained checkpoint serves no CSV")
        log(f"[train] checkpoint {ckpt} served: {len(labels)} CSV rows")

    # one step on the card and on the CPU (attn also with the flash threshold
    # lowered to 256, so that the step runs the flash path)
    batch = small_batch(train_feed)
    if name == "simple_fc":
        check_relu_grads(batch)
    else:
        grads = check_grads_against_cpu(name, batch)
    if name == "attn":
        with blockwise_min_t(256):
            check_grads_against_cpu(name, batch, " flash path")
            # the kernels walk d = 200 and d = 400 in slabs of 128
            for heads in (2, 1):
                check_grads_against_cpu(name, batch, f" flash path, "
                                        f"--attn_head {heads}",
                                        attn_head=heads)
    if name == "ms_tcn":
        check_mstcn_grad_f64(batch, grads)
    if name == "vanilla_lstm":
        add_launches(launches, recompute_step(train_feed))
        add_launches(launches, vanilla_wide_step(train_feed))
    if name == "bilstm":
        add_launches(launches, bilstm_wide_step(train_feed))
    for dt_name in dtypes:
        train_frames_per_sec(card, name, train_feed, dt_name)
    return launches, rows, bests["float32"]


def small_batch(feed):
    """The smallest train batch, its videos cut to 512 frames to bound the
    CPU's time."""
    small = min(feed.index_batches(),
                key=lambda ix: max(len(feed.dataset.features[i])
                                   for i in ix))
    batch = feed.collate(small)
    keep = min(batch[0].shape[1], 512)
    return (batch[0][:, :keep], np.minimum(batch[1], keep),
            batch[2].reshape(len(small), -1)[:, :keep].reshape(-1),
            batch[3][:, :keep])


def check_ctc_checkpoint(best, ckpt):
    """ctcloss's checkpoint, when the CLI wrote one, loads into the port's
    model.  The CLI writes one only once the dev segment accuracy rises
    above 0, as the JAX CLI does; a CTC model's frames vote mostly for the
    blank (class n_class), which no segment has, so two epochs may leave
    it at 0 and write none."""
    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.models.params import load_jax_params
    from pytorch_video_action_tpu_torch.train.checkpoint import load_params

    path = os.path.join("models", f"{ckpt}.npz")
    if best <= 0.0:
        log(f"[train] ctcloss: dev segment accuracy 0 in every epoch, so no "
            f"checkpoint was written (as the JAX CLI does)")
        return
    load_jax_params(build_model("ctcloss", N_CLASS), "ctcloss",
                    *load_params(path, with_state=True))
    log(f"[train] checkpoint {path} loads into ctcloss")


def largest_batch(feed):
    """The train batch with the most padded frames, as the CLI collates it."""
    idxs = max(feed.index_batches(),
               key=lambda ix: max(len(feed.dataset.features[i]) for i in ix))
    return feed.collate(idxs)


def one_step(name, batch, expect, **flags):
    """One f32 Trainer step of ``name`` on the card, every count set to 0
    just before it and read just after; raises unless the counts are
    ``expect`` and the loss is finite.  Returns ``(launches, gradients)``."""
    import torch

    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.train.loop import Trainer

    model = build_model(name, N_CLASS, **flags,
                        generator=torch.Generator().manual_seed(5))
    trainer = Trainer(model, N_CLASS, seed=0)
    ts = trainer.init_state()
    seeds = list(range(21, 21 + model.n_dropout_sites))
    reset_counters()
    loss = trainer.train_step(ts, batch, seeds=seeds).item()
    torch.cuda.synchronize()
    got = counters()
    want = dict.fromkeys(got, 0)
    want.update(expect)
    log(f"[train] {name} {flags} one step, B={batch[0].shape[0]} "
        f"T={batch[0].shape[1]}: loss {loss:.6f}, launches {nonzero(got)} "
        f"(expected {nonzero(want)})")
    if got != want or not np.isfinite(loss):
        raise AssertionError(f"{name} step: launches or loss wrong")
    return got, {k: p.grad.detach().clone()
                 for k, p in ts.model.named_parameters()}


def recompute_step(train_feed) -> dict:
    """A vanilla_lstm train step with the recompute backward (row 16) on the
    largest train batch: per layer the eval-form forward and the recompute
    backward; its gradients against the saved-gates step's.  Returns the
    recompute step's launches."""
    from pytorch_video_action_tpu_torch.ops import rnn_scan as RS

    batch = largest_batch(train_feed)
    _, saved = one_step("vanilla_lstm", batch, {"lstm_scan_fwd_save": 2,
                                                "lstm_scan_bwd_saved": 2})
    RS.RECOMPUTE_BWD = True
    try:
        got, grads = one_step("vanilla_lstm", batch, {"lstm_scan_fwd": 2,
                                                      "lstm_scan_bwd": 2})
    finally:
        RS.RECOMPUTE_BWD = False
    worst = max(((grads[k] - v).abs().max() / v.abs().max()).item()
                for k, v in saved.items())
    log(f"[train] vanilla_lstm recompute against saved-gates backward: "
        f"worst gradient difference / max|gradient| {worst:.3g} (tol "
        f"{TOL['float32']})")
    if not worst <= TOL["float32"]:
        raise AssertionError("the two backwards' gradients differ")
    return got


def bilstm_wide_step(train_feed) -> dict:
    """bilstm at ``--lstm_hidden1 512`` (H=256 a direction, a width the
    fused layer kernel does not take): one step on the largest train batch
    through the scan, both directions of both layers, and one step's
    gradients against the CPU.  Returns the card step's launches."""
    batch = largest_batch(train_feed)
    got, _ = one_step("bilstm", batch, {"lstm_scan_fwd_save": 4,
                                        "lstm_scan_bwd_saved": 4},
                      lstm_hidden1=512)
    small = (batch[0][:3, :300], np.minimum(batch[1][:3], 300),
             batch[2].reshape(len(batch[1]), -1)[:3, :300].reshape(-1),
             batch[3][:3, :300])
    check_grads_against_cpu("bilstm", small, " --lstm_hidden1 512",
                            lstm_hidden1=512)
    return got


def vanilla_wide_step(train_feed) -> dict:
    """vanilla_lstm at ``--lstm_hidden1 1024`` (the scan at W=1024, past
    the width where the saved-gates backward's gradient buffers once passed
    the shared memory): one step on the largest train batch, a saving
    forward and a saved-gates backward a layer, and one step's gradients
    against the CPU.  Returns the card step's launches."""
    batch = largest_batch(train_feed)
    got, _ = one_step("vanilla_lstm", batch, {"lstm_scan_fwd_save": 2,
                                              "lstm_scan_bwd_saved": 2},
                      lstm_hidden1=1024)
    small = (batch[0][:3, :300], np.minimum(batch[1][:3], 300),
             batch[2].reshape(len(batch[1]), -1)[:3, :300].reshape(-1),
             batch[3][:3, :300])
    check_grads_against_cpu("vanilla_lstm", small, " --lstm_hidden1 1024",
                            lstm_hidden1=1024)
    return got


def phase_gru_wide(card: str, root: str):
    """The bidirectional GRU at widths the fused layer kernel refuses, on the
    GRU scan (rows 9-12): its four kernels held at the largest train batch
    (the BiGRU at hidden_dim_1 512, W=256, the batch's own lengths, f32 and
    bf16); one Trainer step of each model of GRU_WIDE on that batch
    (BiGRU at hidden_dim_1 512, 192 and 2048; launch counts: a saving
    forward and a saved-gates backward a direction a layer; attn's flash
    kernels besides), and one more of the
    BiGRU at 512 with the recompute backward (an eval-form forward and a
    recompute backward a direction a layer), its gradients against the
    saved-gates step's; each model's step against the CPU on a small
    batch; the eval forward of the BiGRU at 512 over the test videos (one
    eval-form scan a direction a layer a batch); frames/s of each.
    Returns the launches and the kernel rows by kernels-line entry."""
    import torch

    from pytorch_video_action_tpu_torch.data.dataset import VideoDataset
    from pytorch_video_action_tpu_torch.infer.predict import (
        forward_batches, frame_predictions)
    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.ops import rnn_scan as RS

    train_feed, _ = train_feeds(root)
    batch = largest_batch(train_feed)
    b, t_pad = batch[0].shape[:2]
    gen = torch.Generator().manual_seed(8)
    rows = merge_rows(check_scan("main path", batch[1].tolist(), t_pad, 256,
                                 dt, gen, cell="gru", steps=True)
                      for dt in DTYPES)
    launches = {}
    small = (batch[0][:3, :300], np.minimum(batch[1][:3], 300),
             batch[2].reshape(b, -1)[:3, :300].reshape(-1),
             batch[3][:3, :300])
    saved = None
    for name, configs in GRU_WIDE.items():
        layers = 2 * (4 if name == "bigru" else 1)  # directions x layers
        expect = {"gru_scan_fwd_save": layers, "gru_scan_bwd_saved": layers}
        if name == "attn":  # padded T >= 1024: the flash path
            from pytorch_video_action_tpu_torch.models import attention

            assert t_pad >= attention.BLOCKWISE_MIN_T
            expect["flash_fwd"] = 1
            expect.update(dict.fromkeys(
                ["flash_bwd_fused"] if use_fused(b, t_pad)
                else ["flash_bwd_dkdv", "flash_bwd_dq"], 1))
        for cfg in configs:
            flags = {"cfg_overrides": cfg}
            got, grads = one_step(name, batch, expect, **flags)
            add_launches(launches, got)
            saved = saved or grads
            check_grads_against_cpu(name, small, f" {cfg}", **flags)
            train_frames_per_sec(card, name, train_feed, "float32", **flags)
    wide = {"cfg_overrides": GRU_WIDE["bigru"][0]}
    train_frames_per_sec(card, "bigru", train_feed, "bfloat16", **wide)
    RS.RECOMPUTE_BWD = True
    try:
        got, grads = one_step("bigru", batch, {"gru_scan_fwd": 8,
                                               "gru_scan_bwd": 8}, **wide)
    finally:
        RS.RECOMPUTE_BWD = False
    add_launches(launches, got)
    worst = max(((grads[k] - v).abs().max() / v.abs().max()).item()
                for k, v in saved.items())
    log(f"[train] bigru {wide} recompute against saved-gates backward: "
        f"worst gradient difference / max|gradient| {worst:.3g} (tol "
        f"{TOL['float32']})")
    if not worst <= TOL["float32"]:
        raise AssertionError("the two GRU scan backwards' gradients differ")

    feats = VideoDataset(data_dir="data", annot_path=root, part="test",
                         split=1, mode=None, verbose=False).features
    model = build_model("bigru", N_CLASS, **wide,
                        generator=torch.Generator().manual_seed(9)).to(
                            "cuda").eval()
    expect = {"gru_scan_fwd": 8 * len(forward_batches(feats))}
    frame_predictions(model, feats)  # warm-up
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame_predictions(model, feats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = nonzero(counters())
    add_launches(launches, got)
    n_frames = sum(len(f) for f in feats)
    log(f"[slice] bigru {wide} forward float32: {n_frames} frames of "
        f"{len(feats)} test videos in {seconds:.4f} s = "
        f"{n_frames / seconds:.0f} frames/s (batch 8, bucket 128) on {card}; "
        f"launches {got} (expected {expect})")
    if got != expect:
        raise AssertionError("GRU scan launch counts do not match the "
                             "forward batches")
    return launches, rows


MSTCN_PROBE = "stages.1.layers.12.conv_dilated.w"


def mstcn_grads(batch, device, dtype, record=None):
    """One ms_tcn train step's f64 gradients on ``device`` in ``dtype``, from
    check_grads_against_cpu's parameters and seeds.  ``record`` collects
    each layer backward's ``(arguments, outputs)``."""
    import torch

    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.ops import conv as CV
    from pytorch_video_action_tpu_torch.train.losses import make_loss_fn

    model = build_model("ms_tcn", N_CLASS, generator=torch.Generator(
        ).manual_seed(2)).to(device, dtype)
    x, lengths, targets, _ = batch
    bwd = CV.dilated_residual_layer_bwd

    def recorded(*args):
        out = bwd(*args)
        record.append((args, out))
        return out

    if record is not None:
        recorded.launches = 0
        CV.dilated_residual_layer_bwd = recorded
    try:
        out = model(torch.from_numpy(np.asarray(x, np.float64)).to(
            device, dtype), torch.from_numpy(np.asarray(
                lengths, np.int32)).to(device), train=True,
            seeds=list(range(11, 11 + model.n_dropout_sites)))
        make_loss_fn("ms_tcn")(out.to(torch.float64), torch.from_numpy(
            np.asarray(targets, np.int64)).to(device)).backward()
    finally:
        CV.dilated_residual_layer_bwd = bwd
    return {k: p.grad.to("cpu", torch.float64)
            for k, p in model.named_parameters()}


def check_mstcn_grad_f64(batch, grads):
    """The card's and the CPU's f32 gradient of ``MSTCN_PROBE`` (a layer
    whose dilation passes T, so only the centre tap reads valid frames)
    against a float64 step on the CPU from the same parameters, batch and
    seeds; its side-tap slices must be exactly 0 everywhere.  A step's
    gradients are not smooth in the forward's rounding: a pre-activation
    within rounding of 0 puts relu on either side.  So the layer kernels
    are held on their own inputs: each of the card step's 80 layer
    backwards against the plain version in float64 on the same inputs, the
    worst within 10x of the plain version's worst in f32 on the CPU.  Logs
    the probe layer's smallest pre-activation of the float64 step."""
    import torch

    from pytorch_video_action_tpu_torch.ops import conv as CV

    calls = []
    mstcn_grads(batch, "cuda", torch.float32, calls)
    f64 = mstcn_grads(batch, "cpu", torch.float64)

    def err(got, want):
        return max(((g.double().cpu() - w).abs().max()
                    / w.abs().max().clamp(min=1e-30)).item()
                   for g, w in zip(got, want))

    kernel = cpu = 0.0
    for args, out in calls:
        w_d, b_d, w_p, x, mask, dy, dilation, keep, seed, _ = args
        tensors = (w_d, b_d, w_p, x)
        want = CV.layer_bwd_ref(*(t.double().cpu() for t in tensors),
                                mask.cpu(), dy.double().cpu(), dilation,
                                keep, seed)
        plain = CV.layer_bwd_ref(*(t.cpu() for t in tensors), mask.cpu(),
                                 dy.cpu(), dilation, keep, seed)
        kernel = max(kernel, err(out, want))
        cpu = max(cpu, err(plain, want))
    # the probe layer's input in the float64 step: stage 1, layer 12
    probe = calls[len(calls) - 1 - 32][0]
    g = CV._taps(probe[0].double().cpu(), probe[1].double().cpu(),
                 probe[3].double().cpu(), probe[6])
    valid = probe[4].cpu().bool()[:, :, None].expand_as(g)
    margin = g.abs()[valid].min().item() / g.abs().max().item()
    errs = {dev: ((grads[dev][MSTCN_PROBE].double() - f64[MSTCN_PROBE]).abs()
                  .max() / f64[MSTCN_PROBE].abs().max()).item()
            for dev in ("cuda", "cpu")}
    side = {dev: grads[dev][MSTCN_PROBE][[0, 2]].abs().max().item()
            for dev in ("cuda", "cpu")}
    side["float64"] = f64[MSTCN_PROBE][[0, 2]].abs().max().item()
    log(f"[train] ms_tcn {MSTCN_PROBE} against float64: error / max|grad| "
        f"card {errs['cuda']:.3g}, cpu {errs['cpu']:.3g} (max|grad| "
        f"{f64[MSTCN_PROBE].abs().max().item():.3g}); its layer's smallest "
        f"|pre-activation| / largest on valid frames {margin:.3g} (card "
        f"step's input); side-tap slices max|dw| {side}; the 80 layer "
        f"backwards on the card step's inputs against float64: kernel worst "
        f"{kernel:.3g}, plain f32 on the CPU worst {cpu:.3g}")
    if any(side.values()):
        raise AssertionError("side taps of a centre-only layer have a "
                             "gradient")
    if kernel > 10 * max(cpu, 1e-7):
        raise AssertionError("the layer backward kernel is over 10x "
                             "further from float64 than the plain f32 "
                             "version")


def phase_vanilla_serving(card: str, root: str):
    """vanilla_lstm trained by the train CLI at the inference CLIs'
    defaults (H=64, 1 layer, dropout 0; f32, launch counts and loss as in
    phase_train), then its checkpoint served by phase_slice.  Returns what
    phase_slice returns, the training run's launches added."""
    train_feed, dev_feed = train_feeds(root)
    expect = expected_launches(
        "vanilla_lstm", forwards=feed_shapes(dev_feed) * TRAIN_EPOCHS,
        steps=feed_shapes(train_feed) * TRAIN_EPOCHS, n_layers=VANILLA_SERVE)
    best, got = train_cli_run(root, "vanilla_lstm", "float32", expect,
                              VANILLA_SERVE_FLAGS)
    ckpt, launches, rows = phase_slice(card, root, "vanilla_lstm",
                                       f"vanilla_lstm_{best:.2f}_dev")
    add_launches(launches, got)
    return ckpt, launches, rows


LM_FRAMES = (40, 100)


def phase_train_lm(root: str) -> dict:
    """bilstm_lm through the train CLI on the card (f32): launch counts,
    falling loss, and a checkpoint holding its BatchNorm state.  Returns
    the launches by kernels-line entry.

    Its own tree of 40-100-frame videos (``root``): the model feeds each
    frame's log-probs back as the next frames' context, and at its initial
    weights that loop diverges on Breakfast-length videos, in the JAX
    package as in the port (log-probs near -2e32 by frame 600, NaN by
    1500), so the loss would not be finite."""
    t0 = time.time()
    write_dataset(root, seed=1, frames=LM_FRAMES)
    log(f"[train] bilstm_lm dataset of {LM_FRAMES[0]}-{LM_FRAMES[1]}-frame "
        f"videos written in {time.time() - t0:.1f} s")
    train_feed, dev_feed = train_feeds(root)
    expect = expected_launches(
        "bilstm_lm", forwards=feed_shapes(dev_feed) * TRAIN_EPOCHS,
        steps=feed_shapes(train_feed) * TRAIN_EPOCHS)
    best, got = train_cli_run(root, "bilstm_lm", "float32", expect)
    path = os.path.join("models", f"bilstm_lm_{best:.2f}_dev.npz")
    with np.load(path) as z:
        state = sorted(k for k in z.files if k.startswith("__state__/"))
    log(f"[train] checkpoint {path}: state keys {state}")
    if state != ["__state__/bn1/mean", "__state__/bn1/var",
                 "__state__/bn2/mean", "__state__/bn2/var"]:
        raise AssertionError("the bilstm_lm checkpoint holds no BatchNorm "
                             "state")
    return got


def route_step(route, name, batch, expect, where="", **flags):
    """One f32 train step of ``name`` on the card against the CPU's (as
    ``check_grads_against_cpu``) on the route the caller has set (named by
    ``route``), every count set to 0 just before it and read just after;
    raises unless the card step's counts are ``expect``.  Returns them."""
    reset_counters()
    check_grads_against_cpu(name, batch, f" {route}{where}", **flags)
    got = counters()
    want = dict.fromkeys(got, 0)
    want.update(expect)
    log(f"[route] {route} {name}{where} one step: launches {nonzero(got)} "
        f"(expected {nonzero(want)})")
    if got != want:
        raise AssertionError(f"{name}{where}: {route} launches wrong")
    return got


def merged_step(name, batch, expect, where="", **flags):
    """``route_step`` on the ``PVA_RNN_SPLIT=0`` route."""
    return route_step("PVA_RNN_SPLIT=0", name, batch, expect, where, **flags)


def serve_route(card, root, name, ckpt, route, **kinds):
    """The inference CLI serves ``ckpt`` on the card (test part, f32 and
    bf16: launch counts as ``expected_launches(**kinds)`` gives them) and
    on the CPU (labels, f32, at least 0.99 equal) on the route the caller
    has set (named by ``route``); the forward's frames/s.  Returns the
    card runs' launches."""
    from pytorch_video_action_tpu_torch.cli import inference_cli
    from pytorch_video_action_tpu_torch.data.dataset import VideoDataset
    from pytorch_video_action_tpu_torch.infer.predict import forward_batches

    feats = VideoDataset(data_dir="data", annot_path=root, part="test",
                         split=1, mode=None, verbose=False).features
    expect = expected_launches(name, forwards=[
        (len(c), t) for t, c in forward_batches(feats)], **kinds)
    base = ["--pretrained_model", ckpt, "--prob", "big", "--part", "test",
            "--data_dir", os.path.join(root, "data"), "--annot_path", root]
    launches, csv = {}, {}
    for dt_name in DTYPES:
        reset_counters()
        csv[dt_name] = read_csv_labels(inference_cli.main(
            base + ["--dtype", dt_name, "--device", "cuda"]))
        got = counters()
        add_launches(launches, got)
        log(f"[route] {route} {name} served on the card, {dt_name}: "
            f"{len(csv[dt_name])} CSV rows, launches {nonzero(got)} "
            f"(expected {nonzero(expect)})")
        if got != expect:
            raise AssertionError(f"{route} serving launches wrong")
    t0 = time.time()
    cpu = read_csv_labels(inference_cli.main(base + ["--device", "cpu"]))
    agree = float(np.mean(np.asarray(cpu) == np.asarray(csv["float32"])))
    log(f"[route] {route} {name} served on the CPU in "
        f"{time.time() - t0:.1f} s; segment labels cuda f32 vs cpu f32 "
        f"agree {agree:.4f}")
    if agree < 0.99:
        raise AssertionError("GPU and CPU segment labels disagree")
    forward_frames_per_sec(card, name, ckpt, feats, f" {route}")
    return launches


def phase_merged(card: str, root: str, lm_root: str):
    """The ``PVA_RNN_SPLIT=0`` route (rows 5-8), with ``rnn_fused.SPLIT``
    set to False for the phase: the merged kernels held at the main path's
    shapes (the eval forms at the largest test forward batch, W_in=400;
    the train forms and backwards at the largest train batch, W_in 400 and
    256; f32 and bf16); bigru (f32, bf16) and bilstm (f32) trained by the
    train CLI and their f32 checkpoints served by the inference CLI
    (launch counts with rows 1-4 at 0, falling loss, labels against the
    CPU, frames/s); one step each of bigru, bilstm, attn on its dense and
    its flash path, ctcloss and, on ``lm_root``'s 40-100-frame videos,
    bilstm_lm, its gradients against the CPU.  Returns the launches and
    the kernel rows by kernels-line entry."""
    from pytorch_video_action_tpu_torch.ops import rnn_fused

    split = rnn_fused.SPLIT
    rnn_fused.SPLIT = False
    try:
        return _merged_route(card, root, lm_root)
    finally:
        rnn_fused.SPLIT = split


def _merged_route(card, root, lm_root):
    import torch

    from pytorch_video_action_tpu_torch.data.dataset import VideoDataset
    from pytorch_video_action_tpu_torch.infer.predict import forward_batches

    rows, launches = {}, {}
    feats = VideoDataset(data_dir="data", annot_path=root, part="test",
                         split=1, mode=None, verbose=False).features
    t_serve, chunk = max(forward_batches(feats),
                         key=lambda tb: tb[0] * len(tb[1]))
    serve_lens = [len(feats[i]) for i in chunk]
    train_feed, dev_feed = train_feeds(root)
    batch = largest_batch(train_feed)
    train_lens, t_train = batch[1].tolist(), batch[0].shape[1]
    gen = torch.Generator().manual_seed(10)
    t0 = time.time()
    for cell in (GRU, LSTM):
        for dt_name in DTYPES:
            rows.setdefault(cell.mfwd_name, []).append(check_merged_layer(
                cell, "main path", serve_lens, t_serve, 400, dt_name, gen))
        for w_in in (400, 256):
            for dt_name in DTYPES:
                # row 5 by step part at one shape, in f32
                f, b = check_merged_train_layer(
                    cell, "main path", train_lens, t_train, w_in, dt_name,
                    gen, steps=(not cell.lstm and w_in == 400
                                and dt_name == "float32"))
                rows.setdefault(cell.mfwd_name + "_train", []).append(f)
                rows.setdefault(cell.mbwd_name, []).append(b)
    log(f"[merged] kernel checks in {time.time() - t0:.1f} s")

    steps, forwards = feed_shapes(train_feed), feed_shapes(dev_feed)
    small = small_batch(train_feed)
    for name, dtypes in (("bigru", DTYPES), ("bilstm", ("float32",))):
        t0 = time.time()
        expect = expected_launches(name, forwards=forwards * TRAIN_EPOCHS,
                                   steps=steps * TRAIN_EPOCHS, merged=True)
        for dt_name in dtypes:
            best, got = train_cli_run(root, name, dt_name, expect,
                                      where="_split0")
            add_launches(launches, got)
            if dt_name == "float32":
                ckpt = f"{name}_{best:.2f}_dev"
        add_launches(launches, serve_route(card, root, name, ckpt,
                                           "PVA_RNN_SPLIT=0", merged=True))
        layers = MODELS[name][1]
        cell = cell_of(name)
        add_launches(launches, merged_step(
            name, small, {cell.mfwd_name + "_train": layers,
                          cell.mbwd_name: layers}))
        for dt_name in dtypes:
            train_frames_per_sec(card, name, train_feed, dt_name,
                                 " PVA_RNN_SPLIT=0")
        log(f"[merged] {name} in {time.time() - t0:.1f} s")

    t0 = time.time()
    gru_step = {"gru_merged_fwd_train": 1, "gru_merged_bwd": 1}
    add_launches(launches, merged_step("attn", small, gru_step,
                                       " dense path"))
    b, t_len = small[0].shape[:2]
    flash = {"flash_fwd": 1}
    flash.update(dict.fromkeys(
        ["flash_bwd_fused"] if use_fused(b, t_len)
        else ["flash_bwd_dkdv", "flash_bwd_dq"], 1))
    with blockwise_min_t(256):
        add_launches(launches, merged_step("attn", small,
                                           {**gru_step, **flash},
                                           " flash path"))
    add_launches(launches, merged_step(
        "ctcloss", small, {"gru_merged_fwd_train": 4, "gru_merged_bwd": 4}))
    with contextlib.chdir(lm_root):
        lm_feed, _ = train_feeds(lm_root)
        add_launches(launches, merged_step(
            "bilstm_lm", small_batch(lm_feed),
            {"lstm_merged_fwd_train": 2, "lstm_merged_bwd": 2}))
    log(f"[merged] attn, ctcloss and bilstm_lm steps in "
        f"{time.time() - t0:.1f} s")
    return launches, rows


# ------------------------------------------------- the two flags (phase 7)


def check_bnd_eval(where, lengths, t_len, dt_name, gen):
    """Row 1 alt's eval form (dropout off) on halves of a [T, B, 2H] layer
    input against its plain version and against row 1 on the glue-built
    input (bit for bit); timed beside its plain version, nn.GRU packed, its
    bound (row 1's at W = 2H) and row 1 plus the glue it replaces
    (``torch.cat``, ``* mask``).  Returns its row."""
    import torch

    from pytorch_video_action_tpu_torch.ops import rnn_fused as P

    dt = getattr(torch, dt_name)
    b = len(lengths)
    x, ws, lens = layer_inputs(GRU, t_len, b, 2 * H, dt, lengths, gen)
    xa, xb = x[..., :H].contiguous(), x[..., H:].contiguous()
    got = GRU.bfwd(xa, xb, *ws, lens)
    torch.cuda.synchronize()
    err = rel_err(got, P.gru_bidir_bnd_layer_ref(xa, xb, *ws, lens))[0]

    def glue():
        mask_tb = P.time_mask(lens, t_len, dt)
        return GRU.fwd(P.boundary_input(xa, xb, mask_tb), *ws, lens)

    same = all(torch.equal(a, c) for a, c in zip(got, glue()))
    ms = cuda_ms(lambda: GRU.bfwd(xa, xb, *ws, lens), 10, 2)
    glue_ms = cuda_ms(glue, 10, 2)
    plain_ms = cuda_ms(lambda: P.gru_bidir_bnd_layer_ref(xa, xb, *ws, lens),
                       1, 0)
    lib_run = library_fwd(GRU, x, ws, lens)
    with torch.no_grad():
        lib_ms = cuda_ms(lib_run, 10, 2)
    bound_ms, bound_by = GRU.bound(t_len, b, 2 * H, dt_name)
    tol = TOL[dt_name]
    row = {"where": where, "w_in": 2 * H, "dtype": dt_name, "B": b,
           "T": t_len, "keep": None, "max_abs_err": err, "tol": tol,
           "equals_row_1_on_glue": same, "ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "row_1_and_glue_ms": glue_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"[flags] gru_bidir_bnd_fwd {where} B={b} T={t_len} W_in={2 * H} "
        f"{dt_name}: max|ys-ref|={err:.3g} (tol {tol}), equals row 1 on the "
        f"glue's input {same}, kernel {ms:.4f} ms, row 1 + glue "
        f"{glue_ms:.4f} ms, plain {plain_ms:.4f} ms, nn.GRU packed "
        f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not (err <= tol and same):
        raise AssertionError(f"fused-boundary eval form disagrees: {row}")
    return row


def check_bnd_train(where, lengths, t_len, dt_name, keep, gen):
    """Row 1 alt's train form and row 2 alt (boundary dropout at ``keep``)
    against their plain versions and against rows 1-2 on the glue-built
    input, the gradients of the halves against the glue's autograd (bit for
    bit), the backward rerun bit for bit; each timed beside its plain
    version, nn.GRU packed, its bound and rows 1 or 2 plus the glue they
    replace (``torch.cat``, ``* mask`` and ``hash_dropout``, under
    autograd).  Returns the rows ``(train_form, backward)``."""
    import torch

    from pytorch_video_action_tpu_torch.ops import rnn_fused as P

    dt = getattr(torch, dt_name)
    b = len(lengths)
    x, ws, lens = layer_inputs(GRU, t_len, b, 2 * H, dt, lengths, gen)
    xa, xb = x[..., :H].contiguous(), x[..., H:].contiguous()
    dys = [torch.randn(t_len, b, H, generator=gen).to("cuda", dt)
           for _ in range(2)]
    seed, tol = 4321, TOL[dt_name]
    head = f"{where} B={b} T={t_len} W_in={2 * H} {dt_name} keep {keep}"
    args = (xa, xb, *ws, lens, seed, keep)

    fwd = GRU.bfwd(*args, train=True)
    torch.cuda.synchronize()
    err_fwd = rel_err(fwd, P.gru_bidir_bnd_layer_ref(*args, train=True))[0]
    leaves = [xa.clone().requires_grad_(True),
              xb.clone().requires_grad_(True)]
    xg = P.boundary_input(*leaves, P.time_mask(lens, t_len, dt), seed, keep)
    rfwd = GRU.fwd(xg.detach(), *ws, lens, train=True)
    same_fwd = all(torch.equal(a, c) for a, c in zip(fwd, rfwd))
    ms = cuda_ms(lambda: GRU.bfwd(*args, train=True), 10, 2)
    glue_ms = cuda_ms(lambda: GRU.fwd(P.boundary_input(
        *leaves, P.time_mask(lens, t_len, dt), seed, keep).detach(), *ws,
        lens, train=True), 10, 2)
    plain_ms = cuda_ms(lambda: P.gru_bidir_bnd_layer_ref(*args, train=True),
                       1, 0)
    lib_fwd, lib_bwd = library_train(GRU, xg.detach(), ws, lens, dys)
    lib_ms = cuda_ms(lib_fwd, 10, 2)
    bound_ms, bound_by = GRU.bound(t_len, b, 2 * H, dt_name, train=True)
    fwd_row = {"where": where, "w_in": 2 * H, "dtype": dt_name, "B": b,
               "T": t_len, "keep": keep, "max_abs_err": err_fwd, "tol": tol,
               "equals_row_1_on_glue": same_fwd, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "row_1_and_glue_ms": glue_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
    log(f"[flags] gru_bidir_bnd_fwd train form {head}: max|out-ref|="
        f"{err_fwd:.3g} (tol {tol}), equals row 1 on the glue's input "
        f"{same_fwd}, kernel {ms:.4f} ms, row 1 + glue {glue_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, nn.GRU packed with autograd "
        f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not (err_fwd <= tol and same_fwd):
        raise AssertionError(f"fused-boundary train form disagrees: "
                             f"{fwd_row}")

    bargs = (xa, xb, ws[0], ws[1], ws[4], ws[5], lens, *fwd, *dys, seed,
             keep)
    got = GRU.bbwd(*bargs)
    torch.cuda.synchronize()
    abs_err, err_bwd = rel_err(got, P.gru_bidir_bnd_layer_bwd_ref(*bargs))
    identical = all(torch.equal(a, c) for a, c in zip(got, GRU.bbwd(*bargs)))
    split_args = (xg.detach(), ws[0], ws[1], ws[4], ws[5], lens, *rfwd,
                  *dys)

    def glue_bwd():
        dx, *grads = GRU.bwd(*split_args)
        return (*torch.autograd.grad(xg, leaves, dx, retain_graph=True),
                *grads)

    same_bwd = all(torch.equal(a, c) for a, c in zip(got, glue_bwd()))
    ms = cuda_ms(lambda: GRU.bbwd(*bargs), 5, 1)
    glue_ms = cuda_ms(glue_bwd, 5, 1)
    plain_ms = cuda_ms(lambda: P.gru_bidir_bnd_layer_bwd_ref(*bargs), 1, 0)
    lib_ms = cuda_ms(lib_bwd, 5, 1)
    bound_ms, bound_by = GRU.bound_bwd(t_len, b, 2 * H, dt_name)
    bwd_row = {"where": where, "w_in": 2 * H, "dtype": dt_name, "B": b,
               "T": t_len, "keep": keep, "max_abs_err": abs_err,
               "max_rel_err": err_bwd, "tol": tol,
               "equals_row_2_and_glue_autograd": same_bwd, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "row_2_and_glue_ms": glue_ms, "bound_ms": bound_ms,
               "bound_by": bound_by,
               "bound_simt_ms": GRU.bound_bwd(t_len, b, 2 * H, dt_name,
                                              simt=True)[0],
               "parts_ms": part_ms(lambda: GRU.bbwd(*bargs)),
               "bit_identical_rerun": identical}
    log(f"[flags] gru_bidir_bnd_bwd {head}: max abs err {abs_err:.3g}, max "
        f"err / max(1, max|plain|) {err_bwd:.3g} (tol {tol}), equals row 2 "
        f"and the glue's autograd {same_bwd}, rerun bit-identical "
        f"{identical}, kernel {ms:.4f} ms, row 2 + glue {glue_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, autograd.grad through nn.GRU packed "
        f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; SIMT count "
        f"{bwd_row['bound_simt_ms']:.4f} ms); by part "
        f"{parts_text(bwd_row['parts_ms'])}")
    if not (err_bwd <= tol and same_bwd and identical):
        raise AssertionError(f"fused-boundary backward disagrees: {bwd_row}")
    return fwd_row, bwd_row


def bthd_inputs(lengths, t_len, dt, gen):
    """attn's operands as the fold leaves them: q (pre-scaled), k, v and
    dout ``[B, T, 4 * 128]``, each head's 100 columns random and its 28 pad
    columns 0; the key mask."""
    import torch.nn.functional as nnf

    from pytorch_video_action_tpu_torch.ops import flash as F

    q, k, v, mask, dout = flash_inputs(lengths, t_len, dt, gen)
    flat = [F._flat(nnf.pad(a, (0, BTHD_D - ATTN_D))).contiguous()
            for a in (q, k, v, dout)]
    return (*flat[:3], mask, flat[3])


def _bthd_bounds(lengths, t_len, dt_name, *shape):
    """The bound at d = 128 (the work the padded function does) and at
    attn's own d = 100 (without the pad)."""
    return (flash_bound(lengths, t_len, dt_name, *shape, d=BTHD_D),
            flash_bound(lengths, t_len, dt_name, *shape)[0])


def check_flash_bthd_fwd(where, lengths, t_len, dt_name, rate, gen):
    """Row 17 alt against its plain version and against row 17 on the
    ``[B, H, T, d]`` transposes (bit for bit); timed beside the plain
    version, SDPA on those transposes and its bound at d = 128 and 100.
    Returns its row."""
    import torch

    from pytorch_video_action_tpu_torch.ops import flash as F

    dt = getattr(torch, dt_name)
    q, k, v, mask, _ = bthd_inputs(lengths, t_len, dt, gen)
    out, lse = F.flash_fwd_bthd(q, k, v, mask, ATTN_H, rate, 1234)
    torch.cuda.synchronize()
    ref, ref_lse = F.flash_fwd_bthd_ref(q, k, v, mask, ATTN_H, rate, 1234)
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = rel_err([lse], [ref_lse])[1]
    heads = [F._heads(a, ATTN_H).contiguous() for a in (q, k, v)]
    out4, lse4 = F.flash_fwd(*heads, mask, rate, 1234)
    same = (torch.equal(out, F._flat(out4))
            and torch.equal(lse, lse4.reshape(lse.shape)))
    ms = cuda_ms(lambda: F.flash_fwd_bthd(q, k, v, mask, ATTN_H, rate, 1234),
                 10, 2)
    plain_ms = cuda_ms(lambda: F.flash_fwd_bthd_ref(q, k, v, mask, ATTN_H,
                                                    rate, 1234), 1)
    with torch.no_grad():
        lib_ms = cuda_ms(lambda: sdpa(*heads, mask), 10, 2)
    (bound_ms, bound_by), bound_100 = _bthd_bounds(lengths, t_len, dt_name,
                                                   2, 4, 0, 1)
    tol = TOL[dt_name]
    row = {"where": where, "dtype": dt_name, "rate": rate, "B": len(lengths),
           "T": t_len, "d": BTHD_D, "max_abs_err": err,
           "lse_rel_err": lse_err, "tol": tol, "equals_row_17": same,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_ms_d100": bound_100}
    log(f"[flags] flash_fwd_bthd {where} B={len(lengths)} T={t_len} "
        f"d={BTHD_D} {dt_name} dropout {rate}: max|out-ref|={err:.3g} (tol "
        f"{tol}), lse error {lse_err:.3g}, equals row 17 on the transposes "
        f"{same}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{lib_ms:.4f} ms (dropout 0), bound {bound_ms:.4f} ms ({bound_by}; "
        f"d=100: {bound_100:.4f} ms)")
    if not (err <= tol and lse_err <= TOL["float32"] and same):
        raise AssertionError(f"flash_fwd_bthd disagrees: {row}")
    return row


def check_flash_bthd_bwd(where, lengths, t_len, dt_name, rate, gen):
    """The head-major backward in both forms (the fused row 18 alt in
    place, the split rows 19-20 on transposes) against the plain version
    and against rows 18-20 on the ``[B, H, T, d]`` transposes (bit for
    bit), each rerun bit for bit; row 18 alt timed beside the plain
    version, ``autograd.grad`` through SDPA and its bound at d = 128 and
    100.  Returns its row."""
    import torch

    from pytorch_video_action_tpu_torch.ops import flash as F

    dt = getattr(torch, dt_name)
    q, k, v, mask, dout = bthd_inputs(lengths, t_len, dt, gen)
    out, lse = F.flash_fwd_bthd(q, k, v, mask, ATTN_H, rate, 99)
    args = (q, k, v, mask, ATTN_H, rate, 99, out, lse, dout)
    want = F.flash_bwd_bthd_ref(*args)
    heads = [F._heads(a, ATTN_H).contiguous() for a in (q, k, v, out, dout)]
    lse4 = lse.view(len(lengths), ATTN_H, t_len)
    tol, errs, same, identical = TOL[dt_name], {}, True, True
    for fused in (True, False):
        runs = [F.flash_bwd_bthd(*args, fused=fused) for _ in range(2)]
        ref4 = F.flash_bwd(*heads[:3], mask, rate, 99, heads[3], lse4,
                           heads[4], fused=fused)
        torch.cuda.synchronize()
        errs[fused] = rel_err(runs[0], want)
        identical &= all(torch.equal(a, c) for a, c in zip(*runs))
        same &= all(torch.equal(a, F._flat(r)) for a, r in zip(runs[0],
                                                              ref4))
    delta = F._delta_bthd(dout, out, ATTN_H)
    ms = cuda_ms(lambda: F.flash_bwd_fused_bthd(
        q, k, v, mask, ATTN_H, rate, 99, lse, delta, dout), 5, 1)
    split_ms = cuda_ms(lambda: F.flash_bwd_bthd(*args, fused=False), 5, 1)
    plain_ms = cuda_ms(lambda: F.flash_bwd_bthd_ref(*args), 1, 0)
    leaves = [a.detach().requires_grad_(True) for a in heads[:3]]
    lib_out = sdpa(*leaves, mask)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, leaves, heads[4], retain_graph=True), 5, 1)
    (bound_ms, bound_by), bound_100 = _bthd_bounds(lengths, t_len, dt_name,
                                                   5, 7, 1, 2)
    abs_err, err = errs[True]
    row = {"where": where, "dtype": dt_name, "rate": rate, "B": len(lengths),
           "T": t_len, "d": BTHD_D, "max_abs_err": abs_err,
           "max_rel_err": err, "split_max_rel_err": errs[False][1],
           "tol": tol, "equals_rows_18_20": same,
           "bit_identical_rerun": identical, "ms": ms,
           "split_with_transposes_ms": split_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_ms_d100": bound_100}
    log(f"[flags] flash_bwd_fused_bthd {where} B={len(lengths)} T={t_len} "
        f"d={BTHD_D} {dt_name} dropout {rate}: max err / max(1, max|plain|)"
        f" fused {err:.3g}, split {errs[False][1]:.3g} (tol {tol}), equals "
        f"rows 18-20 on the transposes {same}, reruns bit-identical "
        f"{identical}, kernel {ms:.4f} ms, split with transposes "
        f"{split_ms:.4f} ms, plain {plain_ms:.4f} ms, autograd.grad through "
        f"sdpa {lib_ms:.4f} ms (dropout 0), bound {bound_ms:.4f} ms "
        f"({bound_by}; d=100: {bound_100:.4f} ms), dispatch picks "
        f"{'fused' if use_fused(len(lengths), t_len, d=BTHD_D) else 'split'}")
    if not (max(e[1] for e in errs.values()) <= tol and same and identical):
        raise AssertionError(f"head-major backward disagrees: {row}")
    return row


def card_step(name, batch):
    """One f32 Trainer step of ``name`` on the card from seeded weights:
    ``(loss, gradients)``."""
    import torch

    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.train.loop import Trainer

    model = build_model(name, N_CLASS,
                        generator=torch.Generator().manual_seed(2))
    trainer = Trainer(model, N_CLASS, seed=0, device="cuda")
    ts = trainer.init_state()
    loss = trainer.train_step(ts, batch, seeds=list(
        range(11, 11 + model.n_dropout_sites))).item()
    return loss, {k: p.grad.detach().clone()
                  for k, p in ts.model.named_parameters()}


@contextlib.contextmanager
def fused_boundary(on: bool):
    """``rnn_fused.FUSED_BOUNDARY`` (``PVA_RNN_FUSED_BOUNDARY``) set to
    ``on`` inside the block."""
    from pytorch_video_action_tpu_torch.ops import rnn_fused

    old = rnn_fused.FUSED_BOUNDARY
    rnn_fused.FUSED_BOUNDARY = on
    try:
        yield
    finally:
        rnn_fused.FUSED_BOUNDARY = old


@contextlib.contextmanager
def flash_bthd(on: bool):
    """``PVA_FLASH_BTHD`` set to 1 (``on``) or unset inside the block."""
    old = os.environ.pop("PVA_FLASH_BTHD", None)
    if on:
        os.environ["PVA_FLASH_BTHD"] = "1"
    try:
        yield
    finally:
        os.environ.pop("PVA_FLASH_BTHD", None)
        if old is not None:
            os.environ["PVA_FLASH_BTHD"] = old


def phase_flags(card: str, root: str):
    """JAX's two remaining flags, each set for its half of the phase and
    restored after it: ``PVA_RNN_FUSED_BOUNDARY=1`` (``rnn_fused.
    FUSED_BOUNDARY``) and ``PVA_FLASH_BTHD=1``.  Returns the launches and
    the kernel rows by kernels-line entry."""
    launches, rows = {}, {}
    for name, flag, route in (
            ("PVA_RNN_FUSED_BOUNDARY=1", fused_boundary, _boundary_route),
            ("PVA_FLASH_BTHD=1", flash_bthd, _bthd_route)):
        t0 = time.time()
        with flag(True):
            got, new_rows = route(card, root)
        add_launches(launches, got)
        rows.update(new_rows)
        log(f"[flags] {name} in {time.time() - t0:.1f} s")
    return launches, rows


def _boundary_route(card, root):
    """Rows 1 alt and 2 alt at the main path's shapes (W = 2H = 256; the
    eval form at the largest test forward batch, dropout off; the train
    form and the backward at the largest train batch at keep 0.5 and 0.7,
    and at the bench shape at keep 0.5; f32 and bf16); bigru trained 2 epochs by the train CLI (f32, bf16) and
    served; the flag's invariance on the card (a bigru step, keep 0.5, bit
    for bit against the glue route); one step each of bigru and ctcloss
    against the CPU; frames/s with the flag on and off."""
    import torch

    from pytorch_video_action_tpu_torch.data.dataset import VideoDataset
    from pytorch_video_action_tpu_torch.infer.predict import forward_batches

    route = "PVA_RNN_FUSED_BOUNDARY=1"
    rows, launches = {k: [] for k in BND}, {}
    feats = VideoDataset(data_dir="data", annot_path=root, part="test",
                         split=1, mode=None, verbose=False).features
    t_serve, chunk = max(forward_batches(feats),
                         key=lambda tb: tb[0] * len(tb[1]))
    serve_lens = [len(feats[i]) for i in chunk]
    train_feed, dev_feed = train_feeds(root)
    batch = largest_batch(train_feed)
    train_lens, t_train = batch[1].tolist(), batch[0].shape[1]
    gen = torch.Generator().manual_seed(12)
    t0 = time.time()
    for dt_name in DTYPES:
        rows["gru_bidir_bnd_fwd"].append(check_bnd_eval(
            "main path", serve_lens, t_serve, dt_name, gen))
    for keep in BND_KEEPS:
        for dt_name in DTYPES:
            f, b = check_bnd_train("main path", train_lens, t_train, dt_name,
                                   keep, gen)
            rows["gru_bidir_bnd_fwd_train"].append(f)
            rows["gru_bidir_bnd_bwd"].append(b)
    # and at the bench shape (B=64, T=1024; one video of 1 frame, one of
    # T), as phase 3 holds row 2 there
    bench_lens = torch.randint(1, T_BENCH + 1, (B_BENCH,),
                               generator=gen).tolist()
    bench_lens[0], bench_lens[1] = 1, T_BENCH
    for dt_name in DTYPES:
        f, b = check_bnd_train("bench", bench_lens, T_BENCH, dt_name,
                               BND_KEEPS[0], gen)
        rows["gru_bidir_bnd_fwd_train"].append(f)
        rows["gru_bidir_bnd_bwd"].append(b)
    log(f"[flags] fused-boundary kernel checks in {time.time() - t0:.1f} s")

    steps, forwards = feed_shapes(train_feed), feed_shapes(dev_feed)
    expect = expected_launches("bigru", forwards=forwards * TRAIN_EPOCHS,
                               steps=steps * TRAIN_EPOCHS, boundary=True)
    for dt_name in DTYPES:
        best, got = train_cli_run(root, "bigru", dt_name, expect,
                                  where="_bnd")
        add_launches(launches, got)
        if dt_name == "float32":
            ckpt = f"bigru_{best:.2f}_dev"
    add_launches(launches, serve_route(card, root, "bigru", ckpt, route,
                                       boundary=True))
    small = small_batch(train_feed)
    on = card_step("bigru", small)
    with fused_boundary(False):
        off = card_step("bigru", small)
        for dt_name in DTYPES:
            train_frames_per_sec(card, "bigru", train_feed, dt_name,
                                 " flag off")
    same = on[0] == off[0] and all(torch.equal(g, off[1][k])
                                   for k, g in on[1].items())
    log(f"[flags] bigru one step on the card, {route} against the glue "
        f"route (keep 0.5): loss {on[0]:.6f} and {off[0]:.6f}, loss and "
        f"every gradient bit for bit {same}")
    if not same:
        raise AssertionError("the boundary flag changes bigru's step")
    for dt_name in DTYPES:
        train_frames_per_sec(card, "bigru", train_feed, dt_name, f" {route}")
    per_step = {"gru_bidir_fwd_train": 1, "gru_bidir_bwd": 1}
    for name, layers in (("bigru", 4), ("ctcloss", 4)):
        add_launches(launches, route_step(route, name, small, {
            **per_step, "gru_bidir_bnd_fwd_train": layers - 1,
            "gru_bidir_bnd_bwd": layers - 1}))
    return launches, rows


def _bthd_route(card, root):
    """Rows 17 alt and 18 alt: the forward at attn's serving shape (the
    largest test forward batch padded to T >= 1024) and forward and
    backward at its train batches padded to T >= 1024 below 1536 (f32,
    bf16, dropout 0.3); attn trained 2 epochs (f32) by the train CLI and
    served; one step each of attn and attn at ``--attn_head`` 2 (d 200 ->
    256) against the CPU on the flash path; frames/s with the flag on and
    off."""
    import torch

    from pytorch_video_action_tpu_torch.data.dataset import VideoDataset
    from pytorch_video_action_tpu_torch.infer.predict import forward_batches
    from pytorch_video_action_tpu_torch.models import attention

    route = "PVA_FLASH_BTHD=1"
    min_t = attention.BLOCKWISE_MIN_T
    rows, launches = {k: [] for k in BTHD}, {}
    feats = VideoDataset(data_dir="data", annot_path=root, part="test",
                         split=1, mode=None, verbose=False).features
    t_serve, chunk = max(((t, c) for t, c in forward_batches(feats)
                          if t >= min_t), key=lambda tb: tb[0] * len(tb[1]))
    train_feed, dev_feed = train_feeds(root)
    gen = torch.Generator().manual_seed(13)
    t0 = time.time()
    for dt_name in DTYPES:
        rows["flash_fwd_bthd"].append(check_flash_bthd_fwd(
            "main path", [len(feats[i]) for i in chunk], t_serve, dt_name,
            ATTN_RATE, gen))
    long = {}  # padded T -> a train batch of it, on the flash path
    for ix in train_feed.index_batches():
        t_len = train_feed.collate(ix)[0].shape[1]
        if min_t <= t_len < 1536:
            long.setdefault(t_len, ix)
    for t_len, ix in sorted(long.items()):
        lens = [len(train_feed.dataset.features[i]) for i in ix]
        for dt_name in DTYPES:
            rows["flash_fwd_bthd"].append(check_flash_bthd_fwd(
                "main path", lens, t_len, dt_name, ATTN_RATE, gen))
            rows["flash_bwd_fused_bthd"].append(check_flash_bthd_bwd(
                "main path", lens, t_len, dt_name, ATTN_RATE, gen))
    log(f"[flags] head-major flash kernel checks in "
        f"{time.time() - t0:.1f} s")

    steps, forwards = feed_shapes(train_feed), feed_shapes(dev_feed)
    expect = expected_launches("attn", forwards=forwards * TRAIN_EPOCHS,
                               steps=steps * TRAIN_EPOCHS, bthd=True)
    best, got = train_cli_run(root, "attn", "float32", expect, where="_bthd")
    add_launches(launches, got)
    add_launches(launches, serve_route(card, root, "attn",
                                       f"attn_{best:.2f}_dev", route,
                                       bthd=True))
    train_frames_per_sec(card, "attn", train_feed, "float32", f" {route}")
    small = small_batch(train_feed)
    b, t_len = small[0].shape[:2]
    per_step = {"gru_bidir_fwd_train": 1, "gru_bidir_bwd": 1,
                "flash_fwd_bthd": 1}
    with blockwise_min_t(256):
        for heads in (ATTN_H, 2):
            d = BTHD_D * (ATTN_H // heads)
            bwd = (["flash_bwd_fused_bthd"] if use_fused(b, t_len, heads, d)
                   else ["flash_bwd_dkdv", "flash_bwd_dq"])
            add_launches(launches, route_step(
                route, "attn", small, {**per_step, **dict.fromkeys(bwd, 1)},
                f" --attn_head {heads}", attn_head=heads))
    with flash_bthd(False):
        train_frames_per_sec(card, "attn", train_feed, "float32",
                             " flag off")
    return launches, rows


def kernel_entry(name, source, replaces, launches, rows):
    """One ``kernels`` entry: headline numbers from ``rows[0]`` (f32 at the
    main path's shape), every checked shape under ``shapes``."""
    head = rows[0]
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": head["max_abs_err"], "ms": head["ms"],
             "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
             "bound_by": head["bound_by"], "library_ms": head["library_ms"]}
    # the GRU layer backward's bound and parts; the LSTM scan forwards' split
    for key in ("bound_simt_ms", "parts_ms", "step_us"):
        if key in head:
            entry[key] = head[key]
    return {**entry, "shapes": rows}


def main() -> int:
    import torch

    global GRU, LSTM
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    GRU, LSTM = Cell("gru"), Cell("lstm")

    start = time.time()
    phase_build()
    t0 = time.time()
    bench = phase_kernels()
    log(f"[kernel] kernel phase in {time.time() - t0:.1f} s")
    rows, launches = {}, {}

    def add_rows(new):
        for k, v in new.items():
            rows.setdefault(k, []).extend(v)

    with tempfile.TemporaryDirectory() as root, contextlib.chdir(root):
        t0 = time.time()
        write_dataset(root)
        log(f"[slice] dataset written in {time.time() - t0:.1f} s")
        ckpts = []
        for name in ("bigru", "bilstm", "attn"):
            t0 = time.time()
            ckpt, got, new_rows = phase_slice(card, root, name)
            ckpts.append(ckpt)
            add_launches(launches, got)
            add_rows(new_rows)
            log(f"[slice] {name} serving phase in {time.time() - t0:.1f} s")
        # ms_tcn is served from the checkpoint its training writes, under
        # the inference CLIs' name for it
        t0 = time.time()
        got, new_rows, best = phase_train(card, root, "ms_tcn")
        add_launches(launches, got)
        add_rows(new_rows)
        log(f"[train] ms_tcn training phase in {time.time() - t0:.1f} s")
        t0 = time.time()
        ckpt = f"mstcn_{best:.2f}_dev"
        shutil.copy(os.path.join("models", f"ms_tcn_{best:.2f}_dev.npz"),
                    os.path.join("models", f"{ckpt}.npz"))
        ckpt, got, new_rows = phase_slice(card, root, "mstcn", ckpt)
        ckpts.append(ckpt)
        add_launches(launches, got)
        add_rows(new_rows)
        log(f"[slice] mstcn serving phase in {time.time() - t0:.1f} s")
        t0 = time.time()
        got, new_rows, _ = phase_train(card, root, "vanilla_lstm")
        add_launches(launches, got)
        add_rows(new_rows)
        log(f"[train] vanilla_lstm training phase in {time.time() - t0:.1f} s")
        t0 = time.time()
        ckpt, got, new_rows = phase_vanilla_serving(card, root)
        ckpts.append(ckpt)
        add_launches(launches, got)
        add_rows(new_rows)
        log(f"[slice] vanilla_lstm serving phase in {time.time() - t0:.1f} s")
        # simple_fc likewise, from the checkpoint the train CLI writes
        t0 = time.time()
        got, new_rows, best = phase_train(card, root, "simple_fc")
        add_launches(launches, got)
        log(f"[train] simple_fc training phase in {time.time() - t0:.1f} s")
        t0 = time.time()
        ckpt, got, new_rows = phase_slice(card, root, "simple_fc",
                                          f"simple_fc_{best:.2f}_dev")
        ckpts.append(ckpt)
        add_launches(launches, got)
        log(f"[slice] simple_fc serving phase in {time.time() - t0:.1f} s")
        t0 = time.time()
        add_launches(launches, phase_ensemble(root, ckpts[::-1]))
        log(f"[slice] ensemble phase in {time.time() - t0:.1f} s")
        t0 = time.time()
        for name in ("bigru", "ctcloss", "bilstm", "attn", "win_attn"):
            t1 = time.time()
            got, new_rows, _ = phase_train(card, root, name)
            add_launches(launches, got)
            add_rows(new_rows)
            log(f"[train] {name} training phase in {time.time() - t1:.1f} s")
        t1 = time.time()
        got, new_rows = phase_gru_wide(card, root)
        add_launches(launches, got)
        add_rows(new_rows)
        log(f"[train] GRU scan phase in {time.time() - t1:.1f} s")
        # its own tree and cwd: the feature cache (data-comp/) is per cwd
        lm_root = os.path.join(root, "lm")
        os.makedirs(lm_root)
        with contextlib.chdir(lm_root):
            add_launches(launches, phase_train_lm(lm_root))
        log(f"[train] training phases in {time.time() - t0:.1f} s")
        t0 = time.time()
        got, new_rows = phase_merged(card, root, lm_root)
        add_launches(launches, got)
        add_rows(new_rows)
        log(f"[merged] PVA_RNN_SPLIT=0 phase in {time.time() - t0:.1f} s")
        t0 = time.time()
        got, new_rows = phase_flags(card, root)
        add_launches(launches, got)
        add_rows(new_rows)
        log(f"[flags] flags phase in {time.time() - t0:.1f} s")
    log(f"[done] all phases in {time.time() - start:.1f} s")

    entries = []
    for cell in (GRU, LSTM):
        entries += [(cell.fwd_name, cell.fwd_src, PALLAS + cell.fwd_replaces),
                    (cell.fwd_name + "_train", cell.fwd_src,
                     PALLAS + cell.fwd_replaces),
                    (cell.bwd_name, cell.bwd_src, PALLAS + cell.bwd_replaces)]
    for cell in (GRU, LSTM):
        entries += [(cell.mfwd_name, cell.mfwd_src,
                     PALLAS + cell.mfwd_replaces),
                    (cell.mfwd_name + "_train", cell.mfwd_src,
                     PALLAS + cell.mfwd_replaces),
                    (cell.mbwd_name, cell.mbwd_src,
                     PALLAS + cell.mbwd_replaces)]
    entries += [(name, CSRC + src, SCAN_PALLAS + line)
                for name, (src, line) in (*SCAN.items(), *GSCAN.items())]
    entries += [(name, CSRC + src, FLASH_PALLAS + line)
                for name, (src, line) in FLASH.items()]
    entries += [(name, CSRC + src, CONV_PALLAS + line)
                for name, (src, line) in CONV.items()]
    entries += [(name, CSRC + src, replaces)
                for name, (src, replaces) in (*BND.items(), *BTHD.items())]
    kernels = [kernel_entry(name, src, replaces, launches.get(name, 0),
                            rows.get(name, []) + bench.get(name, []))
               for name, src, replaces in entries]
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels the main path never launched: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
