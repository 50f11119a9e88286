"""Adam with a StepLR-equivalent schedule (counterpart of
``pytorch_video_action_tpu/train/optim.py``).

Reference (``train.py:273-274``): ``Adam(lr, betas=(0.9, 0.999),
eps=1e-8)`` with ``StepLR(step_size, gamma)`` stepped once per epoch, and
only when ``lr_step_size > 0 and lr_gamma < 1`` (``train.py:334-335``).
The learning rate is set per epoch from an epoch counter.
"""

from __future__ import annotations

import torch


def make_optimizer(lr: float, lr_step_size: int, lr_gamma: float):
    """``(factory, lr_for_epoch)``: ``factory(params)`` builds the Adam
    optimizer; ``lr_for_epoch(epoch)`` is ``lr * gamma^(epoch // step)``
    when the schedule is on, else ``lr``."""

    def lr_for_epoch(epoch: int) -> float:
        if lr_step_size > 0 and lr_gamma < 1:
            return lr * (lr_gamma ** (epoch // lr_step_size))
        return lr

    def factory(params) -> torch.optim.Optimizer:
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    return factory, lr_for_epoch


def set_lr(optimizer: torch.optim.Optimizer, new_lr: float):
    """Set the learning rate of every parameter group, in place."""
    for group in optimizer.param_groups:
        group["lr"] = new_lr
    return optimizer
