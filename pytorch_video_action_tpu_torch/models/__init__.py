"""Model registry and factory (counterpart of
``pytorch_video_action_tpu/models/__init__.py``).

Only ``bigru`` is ported.  Every other name of the JAX package raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import torch

from .gru import BiGRU, BiGRUConfig

# names accepted by the inference drivers' checkpoint-filename parsing
# (inference.py:82-94; note 'mstcn' there vs 'ms_tcn' in train.py)
INFERENCE_NAMES = ["simple_fc", "vanilla_lstm", "bilstm", "bigru", "attn", "mstcn"]

_ROADMAP_ITEM = {
    "vanilla_lstm": 9, "bilstm": 9, "bilstm_lm": 9,
    "attn": 10, "win_attn": 10,
    "ms_tcn": 11, "mstcn": 11,
    "simple_fc": 12, "ctcloss": 12,
}


def not_ported(name: str) -> Exception:
    item = _ROADMAP_ITEM.get(name)
    if item is None:
        return NotImplementedError(f"unknown model: {name}")
    return NotImplementedError(
        f"model {name!r} is not ported to PyTorch yet (ROADMAP.md, "
        f"'Modules to port', item {item})")


def build_model(name: str, n_class: int, *,
                generator: torch.Generator | None = None) -> torch.nn.Module:
    """Build a model with the inference drivers' default hyperparameters
    (``inference.py:83-94``), the checkpoint contract.  ``generator`` seeds
    the initial weights."""
    if name == "bigru":
        return BiGRU(BiGRUConfig(n_class=n_class), generator=generator)
    raise not_ported(name)
