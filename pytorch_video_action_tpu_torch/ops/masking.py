"""Length masking (counterpart of ``pytorch_video_action_tpu/ops/masking.py``)."""

from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """``[B, T]`` boolean validity mask from per-sequence lengths."""
    return (torch.arange(t, dtype=torch.int64, device=lengths.device)[None, :]
            < lengths.to(torch.int64)[:, None])


def take_last_valid(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``x[b, len_b - 1]``, the last valid step of each sequence
    (``--pred_mode last``)."""
    idx = (lengths.to(torch.int64) - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx.to(x.device)]


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                axis: int = 1) -> torch.Tensor:
    """Mean over valid frames (``--pred_mode avg``), the count clamped to at
    least 1."""
    m = mask.to(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    return (x * m).sum(dim=axis) / m.sum(dim=axis).clamp(min=1)
