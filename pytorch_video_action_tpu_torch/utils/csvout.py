"""Kaggle submission CSV writer (own copy of
``pytorch_video_action_tpu/utils/csvout.py``).

Byte-format contract (reference ``inference.py:196-205``): header
``Id,Category``, one ``<index>,<label>`` row per segment, **no trailing
newline after the last row**.
"""

from __future__ import annotations


def write_submission(path: str, results: list) -> None:
    lines = "Id,Category\n"
    for index, result in enumerate(results):
        lines += f"{index},{result}"
        if index != len(results) - 1:
            lines += "\n"
    with open(path, "w") as f:
        f.write(lines)
