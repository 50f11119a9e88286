"""Run-length utilities over frame-label sequences (own copy of
``pytorch_video_action_tpu/utils/runlength.py``).

Walk the label sequence and, each time the label changes, emit the previous
run.  ``boundaries`` starts with 0 and ends with ``len(labels)``, so segment
``i`` spans ``[boundaries[i], boundaries[i+1])``.
"""

from __future__ import annotations


def run_length_segments(labels) -> tuple[list, list[int]]:
    """Collapse a frame-label sequence into (segment_labels, boundaries),
    like the reference ``get_label_length_seq`` (``train.py:70-83``)."""
    labels = list(labels)
    seg_labels: list = []
    boundaries: list[int] = [0]
    if not labels:
        boundaries.append(0)
        return seg_labels, boundaries
    start = 0
    for i in range(len(labels)):
        if labels[i] != labels[start]:
            seg_labels.append(labels[start])
            boundaries.append(i)
            start = i
    seg_labels.append(labels[start])
    boundaries.append(len(labels))
    return seg_labels, boundaries
