"""Shared building blocks (counterpart of ``pytorch_video_action_tpu/models/common.py``).

``Linear`` keeps the JAX package's layout, ``w [in, out]`` and ``b [out]``,
initialised ``U(-1/sqrt(in), 1/sqrt(in))`` like ``torch.nn.Linear``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import hashmask


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_dim, out_dim))
        self.b = nn.Parameter(torch.empty(out_dim))
        k = 1.0 / math.sqrt(in_dim)
        with torch.no_grad():
            self.w.uniform_(-k, k, generator=generator)
            self.b.uniform_(-k, k, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self, x)


def linear(p, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p.w) + p.b


def dropout(seed, x: torch.Tensor, rate: float, train: bool) -> torch.Tensor:
    """Hash-stream inverted dropout, a no-op unless ``train``."""
    if not train or rate <= 0.0:
        return x
    if seed is None:
        raise ValueError("dropout: train=True needs a seed")
    return hashmask.hash_dropout(seed, x, 1.0 - rate)


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    # always f32: under bf16 the body computes in bf16, normalisation does not
    return torch.log_softmax(x.to(torch.float32), dim=-1)
