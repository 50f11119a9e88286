"""Checkpoint-name parsing and model loading (counterpart of
``pytorch_video_action_tpu/infer/loader.py``).

Contract (reference ``inference.py:81-105``): checkpoint filenames are
``{model}_{acc:.2f}_dev``; the model type is
``'_'.join(name.split('.')[0].split('_')[:-1])`` and the model is built with
default hyperparameters.  A type the port has not ported yet raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import os

import torch

from ..models import INFERENCE_NAMES, build_model
from ..models.params import from_jax_params
from ..train.checkpoint import load_params


def parse_model_type(model_filename: str) -> str:
    return "_".join(model_filename.split(".")[0].split("_")[:-1])


def load_models(
    pretrained_names: list[str],
    n_class: int,
    models_dir: str = "models",
    device: str | torch.device = "cpu",
) -> dict[str, torch.nn.Module]:
    """``{checkpoint_filename: model}`` in the given order (the first model
    has voting priority, like the reference's dict ordering)."""
    out: dict[str, torch.nn.Module] = {}
    for model_filename in pretrained_names:
        mtype = parse_model_type(model_filename)
        if mtype not in INFERENCE_NAMES:
            print(f"Unknown model type {mtype!r} for {model_filename}; skipping")
            continue
        model = build_model(mtype, n_class)
        path = os.path.join(models_dir, f"{model_filename}.npz")
        try:
            params = load_params(path)
        except OSError as e:
            print(e)
            print(f"Model {model_filename} not found in {path}!")
            continue
        model.load_state_dict(from_jax_params(mtype, params))
        out[model_filename] = model.to(device).eval()
        print(f"Load pretrained model: {model_filename}")
    return out
