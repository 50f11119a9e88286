"""Length masking (counterpart of ``pytorch_video_action_tpu/ops/masking.py``)."""

from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """``[B, T]`` boolean validity mask from per-sequence lengths."""
    return (torch.arange(t, dtype=torch.int64, device=lengths.device)[None, :]
            < lengths.to(torch.int64)[:, None])


def masked_reverse(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each sequence's valid prefix along time; zeros stay at the
    tail: ``out[b, t] = x[b, len_b - 1 - t]`` for ``t < len_b``, else 0.
    Applied twice it is the identity on valid frames.  A reverse-direction
    scan reads its input through it.  Plain indexing; autograd gives its
    gradient."""
    b, t = x.shape[0], x.shape[1]
    view = (b, t, *([1] * (x.dim() - 2)))
    idx = (lengths.to(device=x.device, dtype=torch.int64)[:, None] - 1
           - torch.arange(t, dtype=torch.int64, device=x.device)[None, :])
    valid = (idx >= 0).view(view)
    gathered = torch.gather(x, 1, idx.clamp(0, t - 1).view(view).expand_as(x))
    return torch.where(valid, gathered, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


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
