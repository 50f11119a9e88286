"""Per-segment multi-model ensemble voting (counterpart of
``pytorch_video_action_tpu/infer/ensemble.py``, reference ``inference.py``).

The device computes every model's frame predictions for every video; the
host then votes per segment with zero-avoidance, per-model confidence and
the cross-model mode with its tie-breaks (``inference.py:113-192``).
Segment boundaries come from ground-truth run-lengths on dev and from
``segment.txt`` on test (``inference.py:124-127``).
"""

from __future__ import annotations

import numpy as np

from ..utils.runlength import run_length_segments
from .predict import frame_predictions
from .voting import model_segment_result, select_across_models


def run_ensemble(
    dataset,
    models: dict,
    part: str = "test",
    prob_pref: str = "big",
    quirk_argsort1: bool = False,
    bucket_multiple: int = 128,
    batch_size: int = 8,
    verbose: bool = True,
    dropout_at_test: bool = False,
    dtype: str | None = None,
):
    """Dev accuracy (float) for ``part='dev'``, else the flat list of
    predicted segment labels."""
    all_preds = {
        key: frame_predictions(
            model, dataset.features, bucket_multiple=bucket_multiple,
            batch_size=batch_size, dropout_at_test=dropout_at_test,
            dtype=dtype)
        for key, model in models.items()
    }

    results: list[int] = []
    correct_segment = 0
    total_segment = 0
    n_videos = len(dataset.features)
    for i in range(n_videos):
        if verbose and i % 10 == 0:
            print(f"{i} out of {n_videos}")
        if part == "dev":
            label_seq, segments = run_length_segments(np.asarray(dataset.labels[i]))
        else:
            label_seq = []
            segments = dataset.segment_lines[i]

        seg_votes: dict[str, dict[str, list]] = {}
        seg_order: list[str] = []
        for key in models:
            preds, maxp = all_preds[key][i]
            prob_sum = float(maxp.sum())
            for index in range(len(segments) - 1):
                start, end = int(segments[index]), int(segments[index + 1])
                seg_key = f"{start}-{end}"
                if seg_key not in seg_votes:
                    seg_votes[seg_key] = {"label": [], "probability": [],
                                          "no_of_frames": []}
                    seg_order.append(seg_key)
                label, conf, n_frames = model_segment_result(
                    preds, maxp, start, end, prob_sum, quirk_argsort1)
                # all-zero segments are ignored entirely (inference.py:151)
                if label != 0:
                    seg_votes[seg_key]["label"].append(label)
                    seg_votes[seg_key]["probability"].append(conf)
                    seg_votes[seg_key]["no_of_frames"].append(n_frames)

        for seg_index, seg_key in enumerate(seg_order):
            votes = seg_votes[seg_key]
            if not votes["label"] and verbose:
                print("Blank prediction.")
            label = select_across_models(
                votes["label"], votes["probability"], votes["no_of_frames"],
                prob_pref)
            if part == "dev":
                if (seg_index < len(label_seq)
                        and int(label_seq[seg_index]) == int(label)):
                    correct_segment += 1
            else:
                results.append(label)
        if part == "dev":
            total_segment += len(label_seq)

    if part == "dev":
        accuracy = 100.0 * correct_segment / max(total_segment, 1)
        if verbose:
            print("Accuracy: ", accuracy)
        return accuracy
    return results
