"""Bidirectional GRU stack (counterpart of ``pytorch_video_action_tpu/ops/rnn.py``).

Parameter layout follows ``init_rnn`` of the JAX package: a list over
layers of ``{'fwd': p, 'bwd': p}`` where ``p`` holds ``wi [D, 3H]``,
``wh [H, 3H]``, ``bi [3H]`` and ``bh [3H]`` (right-multiplied, gates r, z,
n), all initialised ``U(-1/sqrt(H), 1/sqrt(H))`` like ``torch.nn.GRU``.

``gru_apply`` follows ``_run_stack_fused_tm``: the stream stays time-major
across the stack, each layer is one :func:`rnn_fused.gru_bidir_layer`, each
boundary is ``concat([ys_f, ys_b]) * mask``, and inter-layer hash dropout
(train only, strides ``(2H, T*2H, 1)``) follows every layer but the last.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from . import hashmask
from .masking import length_mask
from .rnn_fused import gru_bidir_layer


class RNNDirection(nn.Module):
    """One direction of one GRU layer."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = 3 * hidden_dim  # gates r, z, n
        self.wi = nn.Parameter(torch.empty(input_dim, g))
        self.wh = nn.Parameter(torch.empty(hidden_dim, g))
        self.bi = nn.Parameter(torch.empty(g))
        self.bh = nn.Parameter(torch.empty(g))
        k = 1.0 / math.sqrt(hidden_dim)
        with torch.no_grad():
            for p in (self.wi, self.wh, self.bi, self.bh):
                p.uniform_(-k, k, generator=generator)


def init_rnn(input_dim: int, hidden_dim: int, num_layers: int,
             generator: torch.Generator | None = None) -> nn.ModuleList:
    """Bidirectional GRU stack parameters, layer 0 of width ``input_dim`` and
    ``2 * hidden_dim`` after it."""
    layers = nn.ModuleList()
    d = input_dim
    for _ in range(num_layers):
        layers.append(nn.ModuleDict({
            "fwd": RNNDirection(d, hidden_dim, generator=generator),
            "bwd": RNNDirection(d, hidden_dim, generator=generator),
        }))
        d = 2 * hidden_dim
    return layers


def gru_apply(layers, x: torch.Tensor, lengths: torch.Tensor, *,
              dropout_rate: float = 0.0, train: bool = False,
              seeds=None) -> torch.Tensor:
    """``x [B, T, D]`` -> ``[B, T, 2H]``, zero on padded frames.

    ``seeds`` gives one uint32 per inter-layer dropout site
    (``len(layers) - 1``); dropout runs only when ``train`` is set."""
    b_sz, t_len = x.shape[0], x.shape[1]
    lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    mask_tb = length_mask(lengths, t_len).t().to(x.dtype)[:, :, None]
    out = x.transpose(0, 1).contiguous()  # [T, B, W]
    drop = train and dropout_rate > 0.0
    if drop and (seeds is None or len(seeds) < len(layers) - 1):
        raise ValueError("gru_apply: train=True needs one seed per "
                         "inter-layer dropout site")
    keep = 1.0 - dropout_rate
    for li, layer in enumerate(layers):
        f, b = layer["fwd"], layer["bwd"]
        ysf, ysb = gru_bidir_layer(out, f.wi, b.wi, f.bi, b.bi, f.wh, b.wh,
                                   f.bh, b.bh, lengths)
        out = torch.cat([ysf, ysb], dim=-1) * mask_tb
        if drop and li < len(layers) - 1:
            h2 = out.shape[-1]
            out = hashmask.hash_dropout(seeds[li], out, keep,
                                        strides=(h2, t_len * h2, 1))
    return out.transpose(0, 1)
