"""Length masking (counterpart of ``pytorch_video_action_tpu/ops/masking.py``)."""

from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """``[B, T]`` boolean validity mask from per-sequence lengths."""
    return (torch.arange(t, dtype=torch.int64, device=lengths.device)[None, :]
            < lengths.to(torch.int64)[:, None])
