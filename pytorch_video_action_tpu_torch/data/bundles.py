"""Split-bundle / class-mapping / ground-truth parsing (own copy of
``pytorch_video_action_tpu/data/bundles.py``).

* bundle: one header line, then one ``./data/groundTruth/<video>.txt`` path
  per line (reference ``data_utils.py:75-79``); the prefix is stripped, with
  the reference's fixed 19-character slice as the fallback.
* ``mapping_bf.txt``: ``<id> <class_name>`` lines, id 0 = SIL
  (``data_utils.py:123-137``).
* ground-truth label file: one class name per line (``data_utils.py:150-154``).
* ``segment.txt``: one space-separated boundary list per test video
  (``data_utils.py:88-94``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

_BUNDLE_PREFIX = "./data/groundTruth/"  # 19 chars, matching the [19:] slice


def read_lines(filename: str, offset_start: int = 0, offset_end: int = 0) -> list[str]:
    """Stripped lines longer than one character, without ``offset_start``
    header and ``offset_end`` footer lines (reference ``_read_file``,
    ``data_utils.py:110-114``)."""
    with open(filename, "r") as f:
        lines = [x.strip() for x in f.readlines() if len(x.strip()) > 1]
    end = len(lines) - offset_end
    return lines[offset_start:end]


def strip_bundle_prefix(path: str) -> str:
    if path.startswith(_BUNDLE_PREFIX):
        return path[len(_BUNDLE_PREFIX):]
    return path[19:]  # reference parity fallback (data_utils.py:119)


def bundle_path(annot_path: str, part: str, split: int) -> str:
    """Test -> Kaggle splits dir, train/dev -> new_splits
    (reference ``data_utils.py:74-77``)."""
    if part == "test":
        return os.path.join(annot_path, "splits", "splits",
                            f"{part}.split{split}.bundle")
    return os.path.join(annot_path, "splits", "new_splits",
                        f"{part}.split{split}.bundle")


def load_split_filenames(annot_path: str, part: str, split: int) -> list[str]:
    lines = read_lines(bundle_path(annot_path, part, split), offset_start=1)
    return [strip_bundle_prefix(line) for line in lines]


@dataclass
class ClassMapping:
    class_ids: dict[str, int] = field(default_factory=dict)
    class_names: list[str] = field(default_factory=list)

    @property
    def n_class(self) -> int:
        return len(self.class_names)


def parse_class_mapping(lines: list[str]) -> ClassMapping:
    mapping = ClassMapping()
    for pair in lines:
        parts = pair.split(" ")
        if len(parts) < 2:
            continue
        mapping.class_ids[parts[1]] = int(parts[0])
        mapping.class_names.append(parts[1])
    return mapping


def load_class_mapping(annot_path: str) -> ClassMapping:
    path = os.path.join(annot_path, "splits", "splits", "mapping_bf.txt")
    return parse_class_mapping(read_lines(path))


def load_label_file(ground_truth_dir: str, mapping: ClassMapping,
                    filename: str) -> np.ndarray:
    """Per-frame integer labels from a ground-truth file."""
    names = read_lines(os.path.join(ground_truth_dir, filename))
    return np.array([mapping.class_ids[n] for n in names], dtype=np.int64)


def load_segment_file(path: str = "./segment.txt") -> list[list[int]]:
    """Test-video segment boundaries."""
    with open(path, "r") as f:
        raw = f.readlines()
    return [[int(tok) for tok in line.replace("\n", "").split(" ") if tok != ""]
            for line in raw]
