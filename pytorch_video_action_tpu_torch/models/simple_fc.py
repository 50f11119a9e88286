"""SimpleFC (counterpart of ``pytorch_video_action_tpu/models/simple_fc.py``,
reference ``networks.py:9-22``): a per-frame MLP 400 -> 256 -> 128 -> 32 ->
n_class with ReLU between.  It returns **raw logits**, and the train step
takes NLL over them all the same: the reference quirk, kept because it
changes how the model trains.  No dropout, no sequence state."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .common import Linear


@dataclass(frozen=True)
class SimpleFCConfig:
    input_dim: int = 400
    n_class: int = 48


class SimpleFC(nn.Module):
    name = "simple_fc"
    stateful = False
    n_dropout_sites = 0

    def __init__(self, cfg: SimpleFCConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.fc1 = Linear(cfg.input_dim, 256, generator=generator)
        self.fc2 = Linear(256, 128, generator=generator)
        self.fc3 = Linear(128, 32, generator=generator)
        self.fc4 = Linear(32, cfg.n_class, generator=generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, *,
                train: bool = False, seeds=None) -> torch.Tensor:
        """``x [B, T, input_dim]`` -> raw logits ``[B, T, n_class]`` in x's
        dtype; ``lengths``, ``train`` and ``seeds`` change nothing."""
        h = torch.relu(self.fc1(x))
        h = torch.relu(self.fc2(h))
        h = torch.relu(self.fc3(h))
        return self.fc4(h)
