"""BiGRU (counterpart of ``pytorch_video_action_tpu/models/gru.py``,
reference ``networks.py:143-167``): input dropout, a bidirectional GRU
stack, a linear layer and an f32 log-softmax."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.rnn import gru_apply, init_rnn
from .common import Linear, dropout, dropout_on, log_softmax


@dataclass(frozen=True)
class BiGRUConfig:
    input_dim: int = 400
    gru_layer: int = 4
    hidden_dim_1: int = 256
    dropout_rate: float = 0.5
    hidden_dim_2: int = 64  # declared-but-unused `linear` in the reference (:155)
    n_class: int = 48


class BiGRU(nn.Module):
    name = "bigru"
    stateful = False

    def __init__(self, cfg: BiGRUConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.rnn = init_rnn(cfg.input_dim, cfg.hidden_dim_1 // 2,
                            cfg.gru_layer, n_gates=3, generator=generator)
        self.output = Linear(cfg.hidden_dim_1, cfg.n_class,
                             generator=generator)

    @property
    def n_dropout_sites(self) -> int:
        """Seeds a ``train=True`` forward takes: input + inter-layer."""
        return self.cfg.gru_layer

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, *,
                train: bool = False, seeds=None) -> torch.Tensor:
        """``x [B, T, input_dim]`` -> log-probs ``[B, T, n_class]`` f32.

        ``seeds`` (train only): ``seeds[0]`` for the input dropout, then one
        per inter-layer dropout site."""
        rate = self.cfg.dropout_rate
        drop = dropout_on(self, train, seeds)
        x = dropout(seeds[0] if drop else None, x, rate, drop)
        out = gru_apply(self.rnn, x, lengths, dropout_rate=rate, train=drop,
                        seeds=seeds[1:] if drop else None)
        return log_softmax(self.output(out))
