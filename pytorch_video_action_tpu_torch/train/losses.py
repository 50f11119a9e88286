"""Losses with reference semantics (counterpart of
``pytorch_video_action_tpu/train/losses.py``, reference ``train.py:266-271``):

* ``ms_tcn``  -> CrossEntropyLoss(ignore_index=-1) over raw logits,
* ``ctcloss`` -> CTCLoss(blank=n_class, zero_infinity=True),
* everything else -> NLLLoss(ignore_index=-1) over log-softmax outputs
  (simple_fc's raw logits too, the reference quirk).

The first two are masked means over the valid targets, the count clamped
to at least 1, matching torch's 'mean' reduction with ``ignore_index``.
The target pick is a plain ``gather``.  CTC is torch's mean reduction: the
per-sequence NLL over the target length, averaged over the batch.
``make_loss_fn`` picks one by model name, as the JAX one does.
"""

from __future__ import annotations

import numpy as np
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


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor,
             targets: torch.Tensor, target_lengths: torch.Tensor,
             blank_id: int) -> torch.Tensor:
    """CTC with torch's mean reduction and ``zero_infinity``, the JAX
    ``ctc_loss`` (``train/losses.py:51-78``): each sequence's NLL (0 where
    it is not finite) over ``max(target length, 1)``, averaged over the
    batch.  ``log_probs [B, T, K]`` f32, ``targets [B, L]`` zero-padded.
    The per-sequence NLL is ``torch.nn.functional.ctc_loss``'s (the JAX
    package's is optax's, plain XLA)."""
    per_seq = torch.nn.functional.ctc_loss(
        log_probs.transpose(0, 1), targets.to(torch.int64),
        input_lengths.to(torch.int64), target_lengths.to(torch.int64),
        blank=blank_id, reduction="none", zero_infinity=True)
    per_seq = torch.where(torch.isfinite(per_seq), per_seq,
                          torch.zeros_like(per_seq))
    denom = target_lengths.to(per_seq.dtype).clamp(min=1)
    return (per_seq / denom).mean()


def prepare_ctc_targets(labels_flat, batch: int
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Host-side CTC targets (JAX ``prepare_ctc_targets``, reference
    ``train.py:311-323``): each video's valid frame labels (the -1 padding
    left out) collapsed by ``unique_consecutive``; zero-padded ``targets
    [B, L_max]`` int64 and ``target_lengths [B]`` int32."""
    rows = np.asarray(labels_flat).reshape(batch, -1)
    collapsed = []
    for row in rows:
        row = row[row != TARGET_PAD]
        keep = np.ones(len(row), dtype=bool)
        keep[1:] = row[1:] != row[:-1]
        collapsed.append(row[keep])
    max_l = max((len(c) for c in collapsed), default=1) or 1
    targets = np.zeros((batch, max_l), dtype=np.int64)
    lengths = np.zeros((batch,), dtype=np.int32)
    for i, c in enumerate(collapsed):
        targets[i, :len(c)] = c
        lengths[i] = len(c)
    return targets, lengths


def make_loss_fn(model_name: str, n_class: int | None = None):
    """Loss selector mirroring ``train.py:266-271``: cross-entropy over
    ms_tcn's logits; for ctcloss ``fn(log_probs, input_lengths, targets,
    target_lengths)`` with blank = ``n_class``; NLL over every other
    model's output."""
    if model_name in ("ms_tcn", "mstcn"):
        return cross_entropy_loss
    if model_name == "ctcloss":
        if n_class is None:
            raise ValueError("make_loss_fn('ctcloss') needs n_class, the "
                             "blank's index")

        def fn(log_probs, input_lengths, targets, target_lengths):
            return ctc_loss(log_probs, input_lengths, targets,
                            target_lengths, n_class)
        return fn
    return nll_loss
