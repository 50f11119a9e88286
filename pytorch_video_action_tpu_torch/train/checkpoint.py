"""Checkpoints with the reference naming contract (counterpart of
``pytorch_video_action_tpu/train/checkpoint.py``).

Path: ``models/{model}_{dev_acc:.2f}_dev.npz``.  Format: a flat ``.npz`` of
``/``-joined tree paths (``rnn/0/fwd/wi``) -> float32 arrays, the same
files the JAX package reads and writes.  numpy only.
"""

from __future__ import annotations

import os

import numpy as np

from ..models.params import flatten, unflatten


def checkpoint_name(model: str, dev_acc: float) -> str:
    return f"{model}_{dev_acc:.2f}_dev"


def save_params(path: str, params) -> None:
    """Write a params tree (nested dicts/lists of arrays) to ``path``,
    appending ``.npz`` when missing.  Write-then-rename, so an existing
    checkpoint survives an interrupted write."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: np.asarray(v) for k, v in flatten(params, "/").items()}
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:  # file object: savez won't append '.npz'
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_params(path: str):
    """Params tree of numpy arrays from a checkpoint."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return unflatten(flat, "/")
