"""VideoDataset: in-memory Breakfast-features dataset (counterpart of
``pytorch_video_action_tpu/data/dataset.py``, reference
``data_utils.py:66-290``).

Parts train/dev/test; modes ``None`` (whole videos) and ``'active'`` (SIL,
class 0, frames removed, ``data_utils.py:215-231``).
The test part loads ``segment.txt``, slices each feature matrix to
``[first_boundary:last_boundary]`` and re-bases the boundaries to 0
(``data_utils.py:181-190``).
"""

from __future__ import annotations

import os

import numpy as np

from . import bundles, features as feat_io


class VideoDataset:
    def __init__(
        self,
        data_dir: str = "./data",
        annot_path: str = ".",
        part: str = "train",
        split: int = 3,
        mode: str | None = "active",
        cache_dir: str = "data-comp",
        verbose: bool = True,
    ):
        self.part = part.lower().strip()
        self.split = split
        self.mode = mode
        self.data_dir = data_dir
        self.cache_dir = cache_dir
        self._verbose = verbose
        if self.part not in ("train", "dev", "test"):
            raise ValueError("part must be one of train/dev/test")
        if mode not in (None, "active"):
            raise NotImplementedError(
                f"VideoDataset mode {mode!r} is not ported yet (ROADMAP.md, "
                "'Modules to port', item 6)")

        self.filenames = bundles.load_split_filenames(annot_path, self.part, split)
        self.class_mapping = bundles.load_class_mapping(annot_path)
        self.ground_truth_dir = os.path.join(annot_path, "groundTruth", "groundTruth")

        if self.part == "test":
            self._log("Load Segment file")
            seg_path = os.path.join(annot_path, "segment.txt")
            if not os.path.exists(seg_path) and os.path.exists("./segment.txt"):
                seg_path = "./segment.txt"  # reference hardcodes cwd (data_utils.py:90)
            self.segment_lines: list[list[int]] = bundles.load_segment_file(seg_path)
        else:
            self.segment_lines = []

        self._log(f"Loading all {part} data...")
        self._load_all_data()
        self._log(f"{len(self.features)} {part} instances have been loaded.")

        if mode == "active":
            self._log("Excluding out SIL frames...")
            self.features, self.labels = exclude_label(self.features, self.labels, 0)

    def _log(self, msg: str) -> None:
        if self._verbose:
            print(msg)

    def _load_all_data(self) -> None:
        os.makedirs(self.cache_dir, exist_ok=True)
        feat_cache, label_cache = feat_io.cache_paths(
            self.cache_dir, self.part, self.split)
        if self.part == "test":
            raw = feat_io.load_cached(feat_cache)
            if raw is not None:
                self._log("Pickle files found. Loading from pickles")
            else:
                self._log("Loading the data, please wait...")
                raw = [feat_io.load_feature_file(self.data_dir, fn)
                       for fn in self.filenames]
                feat_io.save_cache(feat_cache, raw)
            self.features = []
            for i, feature in enumerate(raw):
                segs = self.segment_lines[i]
                start, end = int(segs[0]), int(segs[-1])
                self.features.append(np.asarray(feature)[start:end, :])
                self.segment_lines[i] = [int(s) - start for s in segs]
            self.labels = None
        else:
            f_cached = feat_io.load_cached(feat_cache)
            l_cached = feat_io.load_cached(label_cache)
            if f_cached is not None and l_cached is not None:
                self._log("Pickle files found. Loading from pickles")
                self.features, self.labels = f_cached, l_cached
            else:
                self._log("Loading the data, please wait...")
                self.features = [feat_io.load_feature_file(self.data_dir, fn)
                                 for fn in self.filenames]
                self.labels = [bundles.load_label_file(
                    self.ground_truth_dir, self.class_mapping, fn)
                    for fn in self.filenames]
                feat_io.save_cache(feat_cache, self.features)
                feat_io.save_cache(label_cache, self.labels)

    @property
    def n_class(self) -> int:
        return self.class_mapping.n_class

    def __len__(self) -> int:
        return len(self.features)


def exclude_label(features, labels, label) -> tuple[list, list]:
    """Delete all frames carrying ``label`` (reference ``_exclude_label``)."""
    out_feats, out_labels = [], []
    for feats, labs in zip(features, labels):
        labs = np.asarray(labs)
        keep = labs != label
        out_labels.append(labs[keep])
        out_feats.append(np.asarray(feats)[keep])
    return out_feats, out_labels
