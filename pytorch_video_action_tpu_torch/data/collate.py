"""Padded batch collation (own copy of
``pytorch_video_action_tpu/data/collate.py``).

Padded lengths round up to multiples of ``bucket_multiple`` (default 128),
so batches come in few distinct shapes; ``bucket_multiple <= 1`` keeps the
exact length.  Padded frames are zeros and padded targets ``TARGET_PAD``
(-1).  Targets are per frame (``pred_mode='cont'``) or one per instance,
flattened to ``[B * y_len]`` like the reference (``train.py:183-205``).
"""

from __future__ import annotations

import numpy as np

from .. import N_FEAT, TARGET_PAD


def bucket_length(length: int, bucket_multiple: int = 128, min_len: int = 0) -> int:
    length = max(length, min_len, 1)
    if bucket_multiple <= 1:
        return length
    return -(-length // bucket_multiple) * bucket_multiple


def pad_batch(batch, batchsize: int | None = None, pred_mode: str = "cont",
              train_mode: str = "active", bucket_multiple: int = 128):
    """Collate ``[(features [T,400], labels [T] or [1] or [0]), ...]``.

    Returns ``(padded [B,T_pad,400] f32, lengths [B] i32, targets
    [B*y_len] i64, mask [B,T_pad] bool)``.  Only the ported train modes,
    ``'active'`` and whole videos, are taken: ``'segment'`` raises."""
    if train_mode == "segment":
        raise NotImplementedError(
            "train_mode 'segment' is not ported yet (ROADMAP.md, 'Modules "
            "to port', item 6)")
    xs = [np.asarray(item[0], dtype=np.float32) for item in batch]
    ys = [np.asarray(item[1]) for item in batch]
    b = batchsize if batchsize is not None else len(batch)
    x_len = np.array([x.shape[0] for x in xs], dtype=np.int32)
    t_pad = bucket_length(int(x_len.max()), bucket_multiple)
    padded = np.zeros((b, t_pad, N_FEAT), dtype=np.float32)
    y_len = t_pad if pred_mode == "cont" else 1
    targets = np.full((b, y_len), TARGET_PAD, dtype=np.int64)
    lengths = np.zeros((b,), dtype=np.int32)
    lengths[:len(xs)] = x_len
    for i, (x, y) in enumerate(zip(xs, ys)):
        n = x.shape[0]
        padded[i, :n] = x
        if y.size == 0:
            continue  # test part: no labels
        if pred_mode != "cont":
            targets[i, :] = y.reshape(-1)[0]
        else:
            targets[i, :n] = y[:n]
    mask = np.arange(t_pad, dtype=np.int32)[None, :] < lengths[:, None]
    return padded, lengths, targets.reshape(-1), mask


class BatchFeed:
    """Sampler + collate over an in-RAM dataset, in the JAX package's order:
    the sampler's batches, or the dataset in order (shuffled when asked)
    in chunks of ``batch_size``."""

    def __init__(self, dataset, batch_sampler=None, batch_size: int = 1,
                 pred_mode: str = "cont", train_mode: str = "active",
                 bucket_multiple: int = 128, shuffle: bool = False,
                 seed: int | None = None):
        if train_mode == "segment":
            raise NotImplementedError(
                "train_mode 'segment' is not ported yet (ROADMAP.md, "
                "'Modules to port', item 6)")
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.batch_size = batch_size
        self.pred_mode = pred_mode
        self.train_mode = train_mode
        self.bucket_multiple = bucket_multiple
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def index_batches(self):
        """One epoch of index batches."""
        if self.batch_sampler is not None:
            yield from self.batch_sampler
        else:
            order = np.arange(len(self.dataset))
            if self.shuffle:
                self._rng.shuffle(order)
            for i in range(0, len(order), self.batch_size):
                yield order[i:i + self.batch_size].tolist()

    def collate(self, idxs):
        """Collate one index batch to fixed-shape arrays."""
        return pad_batch([self.dataset[i] for i in idxs], batchsize=len(idxs),
                         pred_mode=self.pred_mode, train_mode=self.train_mode,
                         bucket_multiple=self.bucket_multiple)

    def __iter__(self):
        for idxs in self.index_batches():
            yield self.collate(idxs)

    def __len__(self) -> int:
        if self.batch_sampler is not None:
            return self.batch_sampler.batch_count()
        return -(-len(self.dataset) // self.batch_size)
