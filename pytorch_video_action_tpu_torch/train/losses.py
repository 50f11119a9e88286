"""Losses with reference semantics (counterpart of
``pytorch_video_action_tpu/train/losses.py``, reference ``train.py:266-271``):

* ``ms_tcn``  -> CrossEntropyLoss(ignore_index=-1) over raw logits,
* everything else ported -> NLLLoss(ignore_index=-1) over log-softmax
  outputs.

Both are masked means over the valid targets, the count clamped to at
least 1, matching torch's 'mean' reduction with ``ignore_index``.  The
target pick is a plain ``gather``.  ``make_loss_fn`` picks one by model
name, as the JAX one does.  CTC is ROADMAP item 12.
"""

from __future__ import annotations

import torch

from .. import TARGET_PAD


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """NLLLoss(ignore_index=-1): log-probs ``[..., C]``, targets ``[...]``."""
    log_probs = log_probs.reshape(-1, log_probs.shape[-1])
    targets = targets.reshape(-1)
    valid = targets != TARGET_PAD
    safe = torch.where(valid, targets, torch.zeros_like(targets))
    picked = log_probs.gather(1, safe[:, None])[:, 0]
    picked = torch.where(valid, picked, torch.zeros_like(picked))
    return -picked.sum() / valid.sum().clamp(min=1)


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """CrossEntropyLoss(ignore_index=-1) over raw logits."""
    return nll_loss(torch.log_softmax(logits, dim=-1), targets)


def make_loss_fn(model_name: str):
    """Loss selector mirroring ``train.py:266-271``: cross-entropy over
    ms_tcn's logits, NLL over every other ported model's log-probs."""
    if model_name in ("ms_tcn", "mstcn"):
        return cross_entropy_loss
    if model_name == "ctcloss":
        from ..models import not_ported

        raise not_ported(model_name)
    return nll_loss
