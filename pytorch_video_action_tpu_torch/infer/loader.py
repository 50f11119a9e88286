"""Checkpoint-name parsing and model loading (counterpart of
``pytorch_video_action_tpu/infer/loader.py``).

Contract (reference ``inference.py:81-105``): checkpoint filenames are
``{model}_{acc:.2f}_dev``; the model type is
``'_'.join(name.split('.')[0].split('_')[:-1])`` and the model is built with
default hyperparameters; ``attn_head`` is handed to ``build_model`` as
the JAX loader hands it (attn's defaults keep 4 heads).  Every inference
name is served: simple_fc, vanilla_lstm, bilstm, bigru, attn and mstcn.
The train CLI names
an ms_tcn checkpoint ``ms_tcn_...``, which is not an inference name: it is
skipped as "Unknown model type", as in JAX, and serves once renamed
``mstcn_...``.
A checkpoint that cannot be read (missing, not an npz,
truncated) is skipped with the error and a "not found" line, as in JAX.
"""

from __future__ import annotations

import os

import torch

from ..models import INFERENCE_NAMES, build_model
from ..models.params import load_jax_params
from ..train.checkpoint import load_params


def parse_model_type(model_filename: str) -> str:
    return "_".join(model_filename.split(".")[0].split("_")[:-1])


def load_models(
    pretrained_names: list[str],
    n_class: int,
    models_dir: str = "models",
    device: str | torch.device = "cuda",
    attn_head: int = 4,
) -> dict[str, torch.nn.Module]:
    """``{checkpoint_filename: model}`` in the given order (the first model
    has voting priority, like the reference's dict ordering), on ``device``:
    the card unless the caller asks for the CPU."""
    out: dict[str, torch.nn.Module] = {}
    for model_filename in pretrained_names:
        mtype = parse_model_type(model_filename)
        if mtype not in INFERENCE_NAMES:
            print(f"Unknown model type {mtype!r} for {model_filename}; skipping")
            continue
        model = build_model(mtype, n_class, attn_head=attn_head, defaults=True)
        path = os.path.join(models_dir, f"{model_filename}.npz")
        try:
            params, state = load_params(path, with_state=True)
        except Exception as e:  # noqa: BLE001 -- the JAX loader's contract
            print(e)
            print(f"Model {model_filename} not found in {path}!")
            continue
        load_jax_params(model, mtype, params, state)
        out[model_filename] = model.to(device).eval()
        print(f"Load pretrained model: {model_filename}")
    return out
