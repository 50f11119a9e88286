"""Batched frame prediction for the inference drivers (counterpart of
``pytorch_video_action_tpu/infer/predict.py``).

Videos are grouped into length buckets and batched through the model in the
JAX package's order; argmax and max run on the device and only ``[T]``-sized
results come back to the host, where the voting runs.
"""

from __future__ import annotations

import copy
from collections import defaultdict

import numpy as np
import torch

from .. import N_FEAT
from ..data.collate import bucket_length


def forward_batches(features: list, bucket_multiple: int = 128,
                    batch_size: int = 8) -> list[tuple[int, list[int]]]:
    """``(padded_length, video indices)`` of every forward batch, in order."""
    buckets: dict[int, list[int]] = defaultdict(list)
    for i, f in enumerate(features):
        buckets[bucket_length(len(f), bucket_multiple)].append(i)
    return [(t_pad, idxs[s:s + batch_size])
            for t_pad, idxs in sorted(buckets.items())
            for s in range(0, len(idxs), batch_size)]


def frame_predictions(
    model: torch.nn.Module,
    features: list[np.ndarray],
    bucket_multiple: int = 128,
    batch_size: int = 8,
    dropout_at_test: bool = False,
    seed: int = 0,
    dtype: str | None = None,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per video: (predicted_class [T] i64, max_log_prob [T] f32), on the
    device the model lies on.

    ``max_log_prob`` is the per-frame maximum of the model output over
    classes, the reference's ``_`` from ``torch.max(outputs.data, 1)``
    (``inference.py:123``).  ``dropout_at_test`` keeps dropout on, like the
    reference ``inference.py`` that never calls ``net.eval()``; its seeds
    come from a ``torch.Generator`` seeded with ``seed``.  ``dtype=
    'bfloat16'`` runs the forward on a bf16 copy of the model and inputs;
    argmax and max stay f32.
    """
    device = next(model.parameters()).device
    cd = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    if cd != torch.float32:
        model = copy.deepcopy(model).to(cd)
    gen = torch.Generator().manual_seed(seed)
    n_seeds = model.n_dropout_sites

    results: list = [None] * len(features)
    with torch.no_grad():
        for t_pad, chunk in forward_batches(features, bucket_multiple,
                                            batch_size):
            b = len(chunk)
            x = np.zeros((b, t_pad, N_FEAT), dtype=np.float32)
            lengths = np.zeros((b,), dtype=np.int32)
            for j, vi in enumerate(chunk):
                f = np.asarray(features[vi], dtype=np.float32)
                x[j, :len(f)] = f
                lengths[j] = len(f)
            x_d = torch.from_numpy(x).to(device=device, dtype=cd)
            l_d = torch.from_numpy(lengths).to(device)
            seeds = None
            if dropout_at_test:
                seeds = torch.randint(0, 2 ** 32, (n_seeds,),
                                      generator=gen).tolist()
            out = model(x_d, l_d, train=dropout_at_test, seeds=seeds)
            maxp, preds = out.float().max(dim=-1)
            preds, maxp = preds.cpu().numpy(), maxp.cpu().numpy()
            for j, vi in enumerate(chunk):
                n = int(lengths[j])
                results[vi] = (preds[j, :n].astype(np.int64), maxp[j, :n])
    return results
