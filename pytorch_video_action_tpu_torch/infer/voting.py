"""Host-side segment voting (counterpart of
``pytorch_video_action_tpu/infer/voting.py``).

These decide segment accuracy at the margin, so they follow the reference:

* majority vote = ``bincount`` argmax -> lowest label index on ties,
* zero-avoidance second choice (``inference.py:147-148``): the reference's
  literal ``argsort(bincount)[1]`` picks the *second smallest* count; the
  default is the intended second-most-frequent, ``quirk_argsort1=True``
  the literal behaviour,
* cross-model mode with the reference's tie-breaks (``inference.py:159-179``).
"""

from __future__ import annotations

from collections import Counter

import numpy as np


def zero_avoided_vote(pred_segment: np.ndarray, quirk_argsort1: bool = False) -> int:
    counts = np.bincount(pred_segment)
    vote = int(counts.argmax())
    if vote == 0 and counts.shape[0] > 1:
        if quirk_argsort1:
            vote = int(np.argsort(counts, kind="stable")[1])
        else:
            vote = int(np.argsort(-counts, kind="stable")[1])
    return vote


def model_segment_result(
    preds: np.ndarray,
    maxp: np.ndarray,
    start: int,
    end: int,
    video_prob_sum: float,
    quirk_argsort1: bool = False,
) -> tuple[int, float, int]:
    """One model's vote on one segment: (label, confidence, n_agreeing_frames).

    Confidence = mean over agreeing frames of the per-frame max log-prob
    normalised by the whole video's sum of maxes (``inference.py:142,152-153``).
    """
    seg_preds = preds[start:end]
    label = zero_avoided_vote(seg_preds, quirk_argsort1)
    agree = np.nonzero(seg_preds == label)[0]
    norm = maxp[start:end] / video_prob_sum
    conf = float(norm[agree].mean()) if agree.size else 0.0
    return label, conf, int(agree.size)


def select_across_models(
    labels: list[int],
    probabilities: list[float],
    frames: list[int],
    prob_pref: str,
) -> int:
    """Modal label; on a tie prefer by frame count, or, when all counts are
    equal, by probability per ``prob_pref`` in {'big', 'small'}.  Empty -> 0
    (the reference's 'Blank prediction' path)."""
    if not labels:
        return 0
    counts = Counter(labels)
    top = max(counts.values())
    modal = [l for l, c in counts.items() if c == top]
    if len(modal) == 1:
        return modal[0]
    if len(set(frames)) == 1:
        if prob_pref == "big":
            idx = probabilities.index(max(probabilities))
        else:
            idx = probabilities.index(min(probabilities))
    else:
        idx = frames.index(max(frames))
    return labels[idx]
