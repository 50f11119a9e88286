"""Attention models, MultiHeadAttention (``attn``) and ExpWindowAttention
(``win_attn``): counterpart of ``pytorch_video_action_tpu/models/
attention.py``, reference ``networks.py:169-240``.

Padded keys are masked, as in the JAX package (the reference attends its
exact-length batches unmasked).  Sequences of padded length
``BLOCKWISE_MIN_T`` or more take the flash path (``ops/flash.py``: the
kernels on the card, O(T * 64) memory); shorter ones the dense path, plain
torch over the ``[B, H, T, T]`` scores with the same hash dropout stream.
With ``PVA_FLASH_BTHD=1`` the flash path folds the scale and a lane pad
into the projections and runs on the head-major flat layout
(:func:`_mha_flash_bthd`), as JAX's does.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch
import torch.nn.functional as nnf
from torch import nn

from ..ops import hashmask
from ..ops.flash import (NEG_INF, flash_self_attention,
                         flash_self_attention_bthd)
from ..ops.masking import length_mask, masked_mean, take_last_valid
from ..ops.rnn import gru_apply, init_rnn
from .common import Linear, dropout_on, log_softmax

# padded T from which attention takes the flash path; read at call time,
# as the JAX package reads its own (tests lower both)
BLOCKWISE_MIN_T = 1024


class MHA(nn.Module):
    """``torch.nn.MultiheadAttention``'s parameters in the JAX layout:
    ``in_proj_w [E, 3E]`` (q, k, v column blocks) xavier-uniform, zero
    biases, ``out_proj_w [E, E]`` ``U(-1/sqrt(E), 1/sqrt(E))``
    (``init_mha``)."""

    def __init__(self, embed_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        e = embed_dim
        self.in_proj_w = nn.Parameter(torch.empty(e, 3 * e))
        self.in_proj_b = nn.Parameter(torch.zeros(3 * e))
        self.out_proj_w = nn.Parameter(torch.empty(e, e))
        self.out_proj_b = nn.Parameter(torch.zeros(e))
        bound = math.sqrt(6.0 / (4.0 * e))  # xavier on [3E, E]
        k = 1.0 / math.sqrt(e)
        with torch.no_grad():
            self.in_proj_w.uniform_(-bound, bound, generator=generator)
            self.out_proj_w.uniform_(-k, k, generator=generator)


def _use_bthd() -> bool:
    """``PVA_FLASH_BTHD=1``: the flash path on the head-major flat layout
    (JAX's ``_use_bthd``, off by default).  Read at call time."""
    return os.environ.get("PVA_FLASH_BTHD") == "1"


def _mha_flash_bthd(p: MHA, x, num_heads, *, key_mask, rate, seed):
    """The flash path on ``[B, T, H*hdp]`` (JAX ``_mha_flash_bthd``): the
    query scale ``1/sqrt(hd)`` folded into ``wq`` and ``bq``, each head's
    columns of ``wq``, ``wk``, ``wv`` and their biases padded with zeros to
    ``hdp``, the next multiple of 128, and the out projection's rows
    likewise.  The pad lanes add zero products, give zero output columns
    and, the fold being differentiable torch, receive zero gradients."""
    b, t, e = x.shape
    hd = e // num_heads
    dp = (128 - hd % 128) % 128
    hdp = hd + dp
    wq, wk, wv = p.in_proj_w.split(e, dim=1)
    bq, bk, bv = p.in_proj_b.split(e)
    scale = (1.0 / torch.sqrt(torch.tensor(float(hd)))).to(
        p.in_proj_w.dtype)

    def fold(w, bias, s=None):
        w, bias = w.reshape(e, num_heads, hd), bias.reshape(num_heads, hd)
        if s is not None:
            w, bias = w * s, bias * s
        return (nnf.pad(w, (0, dp)).reshape(e, num_heads * hdp),
                nnf.pad(bias, (0, dp)).reshape(num_heads * hdp))

    (wq, bq), (wk, bk), (wv, bv) = fold(wq, bq, scale), fold(wk, bk), fold(
        wv, bv)
    qkv = (torch.matmul(x, torch.cat([wq, wk, wv], dim=1))
           + torch.cat([bq, bk, bv]))
    q, k, v = qkv.split(num_heads * hdp, dim=-1)
    out = flash_self_attention_bthd(q, k, v, key_mask, num_heads, rate, seed)
    wo = nnf.pad(p.out_proj_w.reshape(num_heads, hd, e), (0, 0, 0, dp))
    return torch.matmul(out, wo.reshape(num_heads * hdp, e)) + p.out_proj_b


def mha_self_attention(p: MHA, x: torch.Tensor, num_heads: int, *,
                       key_mask: torch.Tensor | None = None,
                       dropout_rate: float = 0.0, train: bool = False,
                       seed=None) -> torch.Tensor:
    """Self-attention over ``x [B, T, E]`` with an optional key mask
    ``[B, T]``; post-softmax dropout when ``train`` (``seed`` is the
    site's uint32).  ``mha_self_attention`` of the JAX package."""
    b, t, e = x.shape
    hd = e // num_heads
    rate = dropout_rate if train else 0.0
    if t >= BLOCKWISE_MIN_T and key_mask is None:
        key_mask = torch.ones((b, t), dtype=torch.bool, device=x.device)
    if t >= BLOCKWISE_MIN_T and _use_bthd():
        return _mha_flash_bthd(p, x, num_heads, key_mask=key_mask, rate=rate,
                               seed=seed)
    qkv = torch.matmul(x, p.in_proj_w) + p.in_proj_b
    q, k, v = qkv.split(e, dim=-1)

    def heads(z):  # [B, T, E] -> [B, H, T, hd]
        return z.reshape(b, t, num_heads, hd).transpose(1, 2)

    scale = torch.sqrt(torch.tensor(float(hd))).to(x.dtype)
    q, k, v = heads(q) / scale, heads(k), heads(v)
    if t >= BLOCKWISE_MIN_T:
        out = flash_self_attention(q, k, v, key_mask, rate, seed)
    else:
        scores = torch.matmul(q, k.transpose(-1, -2))
        if key_mask is not None:
            scores = torch.where(key_mask[:, None, None, :], scores,
                                 torch.full((), NEG_INF, dtype=scores.dtype,
                                            device=x.device))
        attn = torch.softmax(scores, dim=-1)
        if rate > 0.0:
            attn = hashmask.hash_dropout(seed, attn, 1.0 - rate)
        out = torch.matmul(attn, v)
    out = out.transpose(1, 2).reshape(b, t, e)
    return torch.matmul(out, p.out_proj_w) + p.out_proj_b


@dataclass(frozen=True)
class AttnConfig:
    input_dim: int = 400
    num_heads: int = 4
    hidden_dim: int = 256
    dropout_rate: float = 0.3
    n_class: int = 48
    mode: str = "cont"


class Attn(nn.Module):
    """Self-attention (dropout on the attention matrix), a one-layer
    bidirectional GRU (``hidden_dim // 2`` each way, no dropout), ReLU,
    ``output`` ``hidden_dim -> n_class`` and an f32 log-softmax; ``mode``
    ``cont`` (per frame), ``last`` (the last valid frame) or ``avg`` (the
    mean over valid frames) (``apply_attn``)."""

    name = "attn"
    stateful = False
    n_dropout_sites = 1  # the attention matrix

    def __init__(self, cfg: AttnConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.attention = MHA(cfg.input_dim, generator=generator)
        self.rnn = init_rnn(cfg.input_dim, cfg.hidden_dim // 2, 1, n_gates=3,
                            generator=generator)
        self.output = Linear(cfg.hidden_dim, cfg.n_class, generator=generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, *,
                train: bool = False, seeds=None) -> torch.Tensor:
        """``x [B, T, input_dim]`` -> log-probs ``[B, T, n_class]``
        (``cont``) or ``[B, n_class]``, f32.  ``seeds`` (train only): the
        attention site's."""
        cfg = self.cfg
        drop = dropout_on(self, train, seeds)
        mask = length_mask(lengths.to(x.device), x.shape[1])
        h = mha_self_attention(self.attention, x, cfg.num_heads,
                               key_mask=mask, dropout_rate=cfg.dropout_rate,
                               train=drop, seed=seeds[0] if drop else None)
        h = gru_apply(self.rnn, h, lengths)
        if cfg.mode == "last":
            h = take_last_valid(h, lengths)
        elif cfg.mode == "avg":
            h = masked_mean(h, mask)
        return log_softmax(self.output(torch.relu(h)))


@dataclass(frozen=True)
class WinAttnConfig:
    input_dim: int = 400
    num_heads: int = 4
    n_class: int = 48
    dropout_rate: float = 0.3
    window_size: int = 5
    # True: keys past each video's length are masked, as the JAX default;
    # False attends the zero-pad tail and the batch padding, as the
    # reference does (networks.py:221; JAX's parity-test setting)
    mask_padding: bool = True


class WinAttn(nn.Module):
    """Strided windowed attention (``apply_win_attn``, reference
    ``networks.py:217-240``): for ``f`` in ``range(w, T, w)`` attend over
    frames ``[f-w, f+w]`` (zero past T), keys past each video's length
    masked (unless ``mask_padding`` is off), and write ``output`` of the window's centre at row ``f - w``;
    every other row stays 0 before the f32 log-softmax.  The windows run as
    one batch of ``2w + 1``-frame sequences, on the dense path.
    ``combine_output`` is declared but unused, as in the reference, so
    checkpoints round-trip."""

    name = "win_attn"
    stateful = False
    n_dropout_sites = 1  # the attention matrix

    def __init__(self, cfg: WinAttnConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.attention = MHA(cfg.input_dim, generator=generator)
        self.output = Linear(cfg.input_dim, cfg.n_class, generator=generator)
        self.combine_output = Linear(cfg.n_class * (cfg.window_size + 1),
                                     cfg.n_class, generator=generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, *,
                train: bool = False, seeds=None) -> torch.Tensor:
        """``x [B, T, input_dim]`` -> log-probs ``[B, T, n_class]`` f32."""
        cfg = self.cfg
        drop = dropout_on(self, train, seeds)
        b, t, e = x.shape
        w = cfg.window_size
        centers = torch.arange(w, max(t, w), w, device=x.device)
        if centers.numel() == 0:
            return log_softmax(torch.zeros((b, t, cfg.n_class),
                                           dtype=x.dtype, device=x.device))
        xp = torch.cat([x, x.new_zeros((b, w, e))], dim=1)
        idx = centers[:, None] + torch.arange(-w, w + 1, device=x.device)
        n_win = centers.numel()
        win = xp[:, idx].reshape(b * n_win, 2 * w + 1, e)
        lengths = lengths.to(device=x.device, dtype=torch.int64)
        key_mask = ((idx[None] < lengths[:, None, None]).reshape(
            b * n_win, 2 * w + 1) if cfg.mask_padding else None)
        feat = mha_self_attention(self.attention, win, cfg.num_heads,
                                  key_mask=key_mask,
                                  dropout_rate=cfg.dropout_rate, train=drop,
                                  seed=seeds[0] if drop else None)
        probs = self.output(feat[:, w].reshape(b, n_win, e))
        out = x.new_zeros((b, t, cfg.n_class), dtype=probs.dtype)
        out = out.index_copy(1, centers - w, probs)
        return log_softmax(out)
