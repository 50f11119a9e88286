"""I3D feature I/O: gzipped text with an ``.npy`` object cache (own copy of
``pytorch_video_action_tpu/data/features.py``).

Each video's features load with ``np.loadtxt('<data_dir>/<stem>.gz')``
(reference ``data_utils.py:144-147``); a whole split is cached as a pickled
object array under ``data-comp/`` with the reference's names
(``data_utils.py:161-212``), so existing caches keep working.  The JAX
package's native gz parser is a host speed-up the port does not have yet.
"""

from __future__ import annotations

import os

import numpy as np


def load_feature_file(data_dir: str, filename: str) -> np.ndarray:
    """One video's ``[T, 400]`` float32 feature matrix from ``<stem>.gz``."""
    stem = os.path.splitext(filename)[0]
    arr = np.loadtxt(os.path.join(data_dir, f"{stem}.gz"), dtype="float32")
    if arr.ndim == 1:  # single-frame video
        arr = arr.reshape(1, -1)
    return arr


def cache_paths(cache_dir: str, part: str, split: int) -> tuple[str, str]:
    """Reference cache naming contract (``data_utils.py:162-163``)."""
    return (
        os.path.join(cache_dir, f"{part}-{split}-features.npy"),
        os.path.join(cache_dir, f"{part}-{split}-labels.npy"),
    )


def load_cached(path: str):
    """The cached list of arrays, or None when there is no readable cache:
    any failure to read or unpickle it (a missing file, a corrupt one, a
    pickle naming a module that no longer imports) sends the caller back to
    the gz files, as JAX's does."""
    try:
        return list(np.load(path, allow_pickle=True))
    except Exception:
        return None


def save_cache(path: str, arrays: list[np.ndarray]) -> None:
    try:
        obj = np.empty(len(arrays), dtype=object)
        for i, a in enumerate(arrays):
            obj[i] = a
        np.save(path, obj, allow_pickle=True)
    except Exception as e:  # non-fatal, mirrors the reference's warning path
        print("[WARNING] Failed to save data cache\n  > ", e)
