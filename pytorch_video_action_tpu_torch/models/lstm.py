"""vanillaLSTM, BiLSTM and BiLSTMWithLM (counterpart of
``pytorch_video_action_tpu/models/lstm.py``, reference ``networks.py:24-141``).

vanillaLSTM runs the unidirectional LSTM stack, the others the
bidirectional one (``ops/rnn.py::lstm_apply``).  ``BiLSTMWithLM`` is the
zoo's one stateful model: its BatchNorm running statistics are module
buffers (``bn1.mean`` ...), updated in place by a ``train=True`` forward
and read by the eval form.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.masking import length_mask, masked_mean, take_last_valid
from ..ops.rnn import init_rnn, lstm_apply
from .common import Linear, dropout, dropout_on, log_softmax


@dataclass(frozen=True)
class VanillaLSTMConfig:
    input_dim: int = 400
    lstm_layer: int = 1
    dropout_rate: float = 0.0
    hidden_dim: int = 64
    n_class: int = 48
    mode: str = "cont"


class VanillaLSTM(nn.Module):
    """The unidirectional LSTM stack, ``linear`` H -> n_class and an f32
    log-softmax; ``mode`` ``last`` takes the last valid frame, every other
    mode runs per frame (JAX ``apply_vanilla_lstm``)."""

    name = "vanilla_lstm"
    stateful = False

    def __init__(self, cfg: VanillaLSTMConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.rnn = init_rnn(cfg.input_dim, cfg.hidden_dim, cfg.lstm_layer,
                            n_gates=4, bidirectional=False,
                            generator=generator)
        self.linear = Linear(cfg.hidden_dim, cfg.n_class,
                             generator=generator)

    @property
    def n_dropout_sites(self) -> int:
        """Seeds a ``train=True`` forward takes: one per inter-layer site."""
        return self.cfg.lstm_layer - 1

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, *,
                train: bool = False, seeds=None) -> torch.Tensor:
        """``x [B, T, input_dim]`` -> log-probs ``[B, T, n_class]`` or, in
        mode ``last``, ``[B, n_class]``, f32."""
        cfg = self.cfg
        drop = dropout_on(self, train, seeds)
        out = lstm_apply(self.rnn, x, lengths, dropout_rate=cfg.dropout_rate,
                         train=drop, seeds=seeds if drop else None)
        if cfg.mode == "last":
            out = take_last_valid(out, lengths)
        return log_softmax(self.linear(out))


@dataclass(frozen=True)
class BiLSTMConfig:
    input_dim: int = 400
    lstm_layer: int = 2
    hidden_dim_1: int = 256
    dropout_rate: float = 0.5
    hidden_dim_2: int = 64
    n_class: int = 48
    mode: str = "cont"


class BiLSTM(nn.Module):
    """Input dropout, the LSTM stack, ``linear`` H1 -> H2, ReLU, dropout,
    ``output`` H2 -> n_class and an f32 log-softmax; ``mode`` ``cont``
    (per frame), ``last`` (the last valid frame) or ``avg`` (the mean of
    ``linear`` over valid frames)."""

    name = "bilstm"
    stateful = False

    def __init__(self, cfg: BiLSTMConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.rnn = init_rnn(cfg.input_dim, cfg.hidden_dim_1 // 2,
                            cfg.lstm_layer, n_gates=4, generator=generator)
        self.linear = Linear(cfg.hidden_dim_1, cfg.hidden_dim_2,
                             generator=generator)
        self.output = Linear(cfg.hidden_dim_2, cfg.n_class,
                             generator=generator)

    @property
    def n_dropout_sites(self) -> int:
        """Seeds a ``train=True`` forward takes: input, inter-layer, mid."""
        return self.cfg.lstm_layer + 1

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, *,
                train: bool = False, seeds=None) -> torch.Tensor:
        """``x [B, T, input_dim]`` -> log-probs ``[B, T, n_class]`` (``cont``)
        or ``[B, n_class]``, f32.  ``seeds`` (train only): input dropout,
        one per inter-layer site, then the mid dropout."""
        cfg = self.cfg
        rate = cfg.dropout_rate
        drop = dropout_on(self, train, seeds)
        n_rnn = cfg.lstm_layer - 1
        out = lstm_apply(self.rnn,
                         dropout(seeds[0] if drop else None, x, rate, drop),
                         lengths, dropout_rate=rate, train=drop,
                         seeds=seeds[1:1 + n_rnn] if drop else None)
        if cfg.mode == "last":
            out = take_last_valid(out, lengths)
        hidden = self.linear(out)
        if cfg.mode == "avg":
            hidden = masked_mean(hidden, length_mask(lengths, x.shape[1]))
        hidden = dropout(seeds[1 + n_rnn] if drop else None,
                         torch.relu(hidden), rate, drop)
        return log_softmax(self.output(hidden))


@dataclass(frozen=True)
class BiLSTMWithLMConfig:
    input_dim: int = 400
    lstm_layer: int = 2
    hidden_dim_1: int = 256
    dropout_rate: float = 0.5
    hidden_dim_2: int = 64
    n_class: int = 48
    context: int = 2


class BatchNorm(nn.Module):
    """BatchNorm1d over rows in f32: ``scale`` and ``bias`` parameters,
    ``mean`` and ``var`` running-stat buffers (JAX ``model_state``).  Batch
    statistics count valid frames only (``models/lstm.py:133-156``)."""

    def __init__(self, dim: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor, train: bool,
                valid: torch.Tensor) -> torch.Tensor:
        """``x [N, dim]`` f32, ``valid [N, 1]`` f32; a train forward also
        updates the running stats (unbiased variance), outside autograd."""
        if train:
            n = valid.sum().clamp(min=1.0)
            mean = (x * valid).sum(dim=0) / n
            var = (((x - mean) ** 2) * valid).sum(dim=0) / n
            with torch.no_grad():
                m = self.momentum
                unbiased = var * n / (n - 1).clamp(min=1.0)
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * unbiased)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias


class BiLSTMWithLM(nn.Module):
    """Input dropout, the LSTM stack, ``bn1``, ``linear`` H1 -> H2, tanh,
    ``bn2``, then a per-video scan over time: each frame's log-probs come
    from ``output`` applied to the previous ``context`` frames' log-probs
    (detached) and the frame's hidden vector; the context is carried
    unchanged over padded frames and padded outputs are 0
    (``models/lstm.py:159-211``)."""

    name = "bilstm_lm"
    stateful = True

    def __init__(self, cfg: BiLSTMWithLMConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.rnn = init_rnn(cfg.input_dim, cfg.hidden_dim_1 // 2,
                            cfg.lstm_layer, n_gates=4, generator=generator)
        self.linear = Linear(cfg.hidden_dim_1, cfg.hidden_dim_2,
                             generator=generator)
        self.output = Linear(cfg.context * cfg.n_class + cfg.hidden_dim_2,
                             cfg.n_class, generator=generator)
        self.bn1 = BatchNorm(cfg.hidden_dim_1)
        self.bn2 = BatchNorm(cfg.hidden_dim_2)

    @property
    def n_dropout_sites(self) -> int:
        """Seeds a ``train=True`` forward takes: input and inter-layer."""
        return self.cfg.lstm_layer

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, *,
                train: bool = False, seeds=None) -> torch.Tensor:
        """``x [B, T, input_dim]`` -> log-probs ``[B, T, n_class]`` in x's
        dtype, 0 on padded frames."""
        cfg = self.cfg
        b, t, _ = x.shape
        rate = cfg.dropout_rate
        drop = dropout_on(self, train, seeds)
        out = lstm_apply(self.rnn,
                         dropout(seeds[0] if drop else None, x, rate, drop),
                         lengths, dropout_rate=rate, train=drop,
                         seeds=seeds[1:] if drop else None)
        mask = length_mask(lengths, t)
        # the statistics in f32: bf16 sums and counts over B*T rows round
        valid = mask.reshape(-1, 1).to(torch.float32)
        flat = self.bn1(out.reshape(-1, cfg.hidden_dim_1).float(), train,
                        valid)
        hidden = torch.tanh(self.linear(flat.to(x.dtype)))
        hidden = self.bn2(hidden.float(), train, valid)
        hidden = hidden.to(x.dtype).reshape(b, t, cfg.hidden_dim_2)
        n_c = cfg.n_class
        ctx_dim = cfg.context * n_c
        w_ctx, w_hid = self.output.w[:ctx_dim], self.output.w[ctx_dim:]
        base = torch.matmul(hidden, w_hid) + self.output.b  # [B, T, C]
        # the context entering each frame; it is built from detached
        # log-probs, so the scan needs no autograd and the log-probs that
        # carry gradient are computed for all frames at once below
        with torch.no_grad():
            ctx = torch.zeros(b, ctx_dim, dtype=x.dtype, device=x.device)
            ctxs = []
            for s in range(t):
                ctxs.append(ctx)
                logp = torch.log_softmax(base[:, s] + ctx @ w_ctx, dim=-1)
                ctx = torch.where(mask[:, s, None],
                                  torch.cat([ctx[:, n_c:], logp], dim=-1), ctx)
            ctx_seq = torch.stack(ctxs, dim=1)  # [B, T, ctx_dim]
        logp = torch.log_softmax(base + torch.matmul(ctx_seq, w_ctx), dim=-1)
        return logp * mask.to(x.dtype)[:, :, None]
