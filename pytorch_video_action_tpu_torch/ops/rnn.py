"""Bidirectional GRU and LSTM stacks (counterpart of
``pytorch_video_action_tpu/ops/rnn.py``).

Parameter layout follows ``init_rnn`` of the JAX package: a list over
layers of ``{'fwd': p, 'bwd': p}`` where ``p`` holds ``wi [D, gH]``,
``wh [H, gH]``, ``bi [gH]`` and ``bh [gH]`` (right-multiplied; g = 3 gates
r, z, n for the GRU, 4 gates i, f, g, o for the LSTM), all initialised
``U(-1/sqrt(H), 1/sqrt(H))`` like ``torch.nn.GRU`` and ``torch.nn.LSTM``.

``gru_apply`` and ``lstm_apply`` follow ``_run_stack_fused_tm``: the stream
stays time-major across the stack, each layer is one
:func:`rnn_fused.gru_bidir_layer` or :func:`rnn_fused.lstm_bidir_layer`
(the LSTM with both biases folded, ``rnn.py:275-277``), each boundary is
``concat([ys_f, ys_b]) * mask``, and inter-layer hash dropout (train only,
strides ``(2H, T*2H, 1)``) follows every layer but the last.  Under
autograd each layer runs its train form and backward kernel; the boundary
glue is plain torch, differentiated by autograd.

``rnn_fused.SPLIT`` (``PVA_RNN_SPLIT``, read at import; the stack reads
the attribute at call time) picks the layer body as ``_fused_layer_tm``
does (``rnn.py:258-288``): the split layer above by default, else the
merged one, :func:`rnn_fused.gru_merged_layer` or
:func:`rnn_fused.lstm_merged_layer`, on the gate-grouped weights
:func:`_pack_bidir` builds (the LSTM's ``b2`` folds both biases and has
no hidden bias).  The packing is differentiable torch, so its VJP keeps
only the diagonal blocks of ``dwh2``.  Both bodies take the same widths.

``rnn_fused.FUSED_BOUNDARY`` (``PVA_RNN_FUSED_BOUNDARY``, read at import;
the stack reads the attribute at call time) with the split body moves the
GRU stack's boundaries into the layers, as ``_run_stack_fused_tm`` does
(``rnn.py:359-389``): layer 0 runs the split layer, each later layer
:func:`rnn_fused.gru_bidir_bnd_layer` on the previous layer's halves
with the pending boundary's seed (none after the last layer and in eval),
and the stack's output is ``concat * mask`` of the last layer.  The seeds
and the values are the glue's, so the flag never changes a result.  The
LSTM has no such form (nor has JAX), and a one-layer stack no boundary.

Where the fused layer kernels do not take ``H`` (``_HIDDEN``), the
bidirectional GRU and LSTM stacks run JAX's per-layer fallback instead
(``rnn.py:425-477``, its ``_scan_packed`` on ``rnn_pallas``'s scans): per
direction the projection (GRU ``x @ wi + bi``, ``bh`` going to the scan;
LSTM ``x @ wi + bi + bh``), then :func:`rnn_scan.gru_scan` or
:func:`rnn_scan.lstm_scan` (the backward direction on
:func:`masking.masked_reverse` of the input, its output reversed back),
batch-major, with inter-layer hash dropout over ``[B, T, 2H]`` at default
strides, the same stream as the time-major strides above.  JAX packs both
directions into one ``[B, 2H]`` chain with a block-diagonal ``wh``; the
function is the same.  The routing is by ``H`` alone, on the CPU as on the
card.  The unidirectional stack (vanilla_lstm, no ``bwd`` parameters) is
JAX's ``rnn_apply`` loop of ``_run_direction`` (``rnn.py:507-528``) on the
LSTM scan, with hash dropout over ``[B, T, H]`` between layers.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from . import hashmask, rnn_fused
from .masking import masked_reverse
from .rnn_fused import (_HIDDEN, boundary_input, gru_bidir_bnd_layer,
                        gru_bidir_layer, gru_merged_layer, lstm_bidir_layer,
                        lstm_merged_layer, time_mask)
from .rnn_scan import gru_scan, lstm_scan


class RNNDirection(nn.Module):
    """One direction of one GRU (3 gates) or LSTM (4 gates) layer."""

    def __init__(self, input_dim: int, hidden_dim: int, n_gates: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = n_gates * hidden_dim
        self.wi = nn.Parameter(torch.empty(input_dim, g))
        self.wh = nn.Parameter(torch.empty(hidden_dim, g))
        self.bi = nn.Parameter(torch.empty(g))
        self.bh = nn.Parameter(torch.empty(g))
        k = 1.0 / math.sqrt(hidden_dim)
        with torch.no_grad():
            for p in (self.wi, self.wh, self.bi, self.bh):
                p.uniform_(-k, k, generator=generator)


def init_rnn(input_dim: int, hidden_dim: int, num_layers: int, *,
             n_gates: int = 3, bidirectional: bool = True,
             generator: torch.Generator | None = None) -> nn.ModuleList:
    """Stack parameters, layer 0 of width ``input_dim`` and ``2 *
    hidden_dim`` (``hidden_dim`` when not ``bidirectional``: no ``bwd``)
    after it; ``n_gates`` 3 for the GRU, 4 for the LSTM."""
    layers = nn.ModuleList()
    d = input_dim
    dirs = ("fwd", "bwd") if bidirectional else ("fwd",)
    for _ in range(num_layers):
        layers.append(nn.ModuleDict({
            k: RNNDirection(d, hidden_dim, n_gates, generator=generator)
            for k in dirs}))
        d = len(dirs) * hidden_dim
    return layers


def _pack_gate_grouped(mats, h: int, n_gates: int) -> torch.Tensor:
    """Per-direction hidden weights ``[H, gH]`` -> a block-diagonal ``[D*H,
    g*D*H]`` with gate-grouped columns ``[gate0_dir0 | gate0_dir1 | gate1_dir0
    | ...]`` (JAX ``rnn.py:110-123``), as one broadcast product with the
    identity, so that its VJP passes each direction its diagonal blocks and
    drops the others in two kernels."""
    d = len(mats)
    m = torch.stack(mats).view(d, h, n_gates, 1, h)
    eye = torch.eye(d, dtype=m.dtype, device=m.device).view(d, 1, 1, d, 1)
    return (m * eye).reshape(d * h, n_gates * d * h)


def _pack_gate_grouped_vec(vecs, h: int, n_gates: int) -> torch.Tensor:
    """The same gate-grouped packing for bias vectors ``[gH]`` -> ``[g*D*H]``
    (JAX ``rnn.py:126-131``)."""
    d = len(vecs)
    return torch.stack(vecs).view(d, n_gates, h).transpose(0, 1).reshape(
        n_gates * d * h)


def _pack_bidir(cell: str, f, b, h: int, n_gates: int):
    """Gate-grouped ``(b2, wh2, bh2)`` of one layer's two directions for the
    merged body (JAX ``rnn.py:244-255``): the LSTM's ``b2`` folds both
    biases and its ``bh2`` is None (the merged LSTM takes no hidden bias);
    the GRU's ``b2`` holds ``bi``, ``bh2`` its ``bh`` (inside the reset
    gate)."""
    wh2 = _pack_gate_grouped([f.wh, b.wh], h, n_gates)
    if cell == "lstm":
        return (_pack_gate_grouped_vec([f.bi + f.bh, b.bi + b.bh], h,
                                       n_gates), wh2, None)
    return (_pack_gate_grouped_vec([f.bi, b.bi], h, n_gates), wh2,
            _pack_gate_grouped_vec([f.bh, b.bh], h, n_gates))


def _gru_layer(x, f, b, lengths):
    if rnn_fused.SPLIT:
        return gru_bidir_layer(x, f.wi, b.wi, f.bi, b.bi, f.wh, b.wh, f.bh,
                               b.bh, lengths)
    b2, wh2, bh2 = _pack_bidir("gru", f, b, f.wh.shape[0], 3)
    return gru_merged_layer(x, f.wi, b.wi, b2, wh2, bh2, lengths)


def _lstm_layer(x, f, b, lengths):
    if rnn_fused.SPLIT:
        return lstm_bidir_layer(x, f.wi, b.wi, f.bi + f.bh, b.bi + b.bh,
                                f.wh, b.wh, lengths)
    b2, wh2, _ = _pack_bidir("lstm", f, b, f.wh.shape[0], 4)
    return lstm_merged_layer(x, f.wi, b.wi, b2, wh2, lengths)


def _apply_stack(layer_fn, layers, x: torch.Tensor, lengths: torch.Tensor,
                 dropout_rate: float, train: bool, seeds,
                 fused_boundary: bool = False) -> torch.Tensor:
    """``x [B, T, D]`` -> ``[B, T, 2H]``, zero on padded frames, one
    ``layer_fn(x_tm, fwd, bwd, lengths) -> (ys_f, ys_b)`` per layer.  With
    ``fused_boundary`` (the GRU) the layers after the first take the
    previous layer's halves through :func:`rnn_fused.gru_bidir_bnd_layer`,
    which builds the boundary itself.

    ``seeds`` gives one uint32 per inter-layer dropout site
    (``len(layers) - 1``); dropout runs only when ``train`` is set."""
    lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    mask_tb = time_mask(lengths, x.shape[1], x.dtype)
    out = x.transpose(0, 1).contiguous()  # [T, B, W]
    drop = train and dropout_rate > 0.0
    if drop and (seeds is None or len(seeds) < len(layers) - 1):
        raise ValueError("rnn stack: train=True needs one seed per "
                         "inter-layer dropout site")
    keep = 1.0 - dropout_rate
    halves = seed = None
    for li, layer in enumerate(layers):
        f, b = layer["fwd"], layer["bwd"]
        if halves is None:
            ysf, ysb = layer_fn(out, f, b, lengths)
        else:
            ysf, ysb = gru_bidir_bnd_layer(*halves, f.wi, b.wi, f.bi, b.bi,
                                           f.wh, b.wh, f.bh, b.bh, lengths,
                                           seed, keep)
        last = li == len(layers) - 1
        seed = seeds[li] if drop and not last else None
        if fused_boundary and not last:
            halves = (ysf, ysb)  # the next layer builds the boundary
        else:
            out = boundary_input(ysf, ysb, mask_tb, seed, keep)
    return out.transpose(0, 1)


def _scan_direction(cell, p, x, lengths, mask_tm, reverse):
    """One GRU or LSTM direction on the scan, ``x [B, T, D]`` -> masked
    ``[B, T, H]`` (JAX ``_run_direction``)."""
    if reverse:
        x = masked_reverse(x, lengths)
    if cell == "gru":  # bh stays inside the reset gate
        xg = (torch.matmul(x, p.wi) + p.bi).transpose(0, 1)
        ys = gru_scan(xg, p.wh, p.bh, mask_tm)
    else:
        xg = (torch.matmul(x, p.wi) + p.bi + p.bh).transpose(0, 1)
        ys = lstm_scan(xg, p.wh, mask_tm)
    ys = ys.transpose(0, 1)
    return masked_reverse(ys, lengths) if reverse else ys


def _scan_stack(cell, layers, x, lengths, dropout_rate, train, seeds):
    """The GRU or LSTM stack on the scan, batch-major: one direction per
    layer, or two, concatenated, for a stack with ``bwd`` parameters; hash
    dropout over ``[B, T, dirs*H]`` with default strides after every layer
    but the last."""
    lengths = lengths.to(device=x.device, dtype=torch.int32)
    mask_tm = time_mask(lengths, x.shape[1], x.dtype)
    drop = train and dropout_rate > 0.0
    if drop and (seeds is None or len(seeds) < len(layers) - 1):
        raise ValueError("rnn stack: train=True needs one seed per "
                         "inter-layer dropout site")
    out = x
    for li, layer in enumerate(layers):
        out = torch.cat([_scan_direction(cell, layer[k], out, lengths,
                                         mask_tm, k == "bwd")
                         for k in layer], dim=-1)
        if drop and li < len(layers) - 1:
            out = hashmask.hash_dropout(seeds[li], out, 1.0 - dropout_rate)
    return out


def lstm_apply(layers, x: torch.Tensor, lengths: torch.Tensor, *,
               dropout_rate: float = 0.0, train: bool = False,
               seeds=None) -> torch.Tensor:
    """The LSTM stack: ``x [B, T, D]`` -> ``[B, T, 2H]``, or ``[B, T, H]``
    for a unidirectional stack (no ``bwd`` parameters).  The bidirectional
    stack runs the fused layer kernel where it takes ``H`` and the scan
    elsewhere; the unidirectional one always runs the scan."""
    if "bwd" in layers[0] and layers[0]["fwd"].wh.shape[0] in _HIDDEN:
        return _apply_stack(_lstm_layer, layers, x, lengths, dropout_rate,
                            train, seeds)
    return _scan_stack("lstm", layers, x, lengths, dropout_rate, train,
                       seeds)


def gru_apply(layers, x: torch.Tensor, lengths: torch.Tensor, *,
              dropout_rate: float = 0.0, train: bool = False,
              seeds=None) -> torch.Tensor:
    """The bidirectional GRU stack: ``x [B, T, D]`` -> ``[B, T, 2H]``: the
    fused layer kernel where it takes ``H`` (the split body with
    ``FUSED_BOUNDARY`` takes the fused-boundary form after layer 0), the GRU
    scan elsewhere."""
    if layers[0]["fwd"].wh.shape[0] in _HIDDEN:
        return _apply_stack(_gru_layer, layers, x, lengths, dropout_rate,
                            train, seeds, fused_boundary=(
                                rnn_fused.FUSED_BOUNDARY and rnn_fused.SPLIT))
    return _scan_stack("gru", layers, x, lengths, dropout_rate, train, seeds)
