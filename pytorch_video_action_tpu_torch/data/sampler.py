"""Length-bucketed batch sampling (own copy of
``pytorch_video_action_tpu/data/sampler.py``, reference
``data_utils.py:10-63``): shuffle, sort by length, group indices by exact
length, flatten in length order, pad the tail to a batch-size multiple by
duplicating samples drawn from the last ``2*k`` entries, chunk into
fixed-size batches, shuffle batch order.

Pure Python on a seeded ``random.Random``: for the same inputs and seed it
gives the same batches in the same order as the JAX package's sampler.
``freeze_composition=True`` keeps the batch list of ``__init__`` for every
epoch (the reference's literal behaviour); otherwise each epoch draws new
batches.  ``__len__`` is the number of batches.
"""

from __future__ import annotations

import random
from collections import OrderedDict


class BucketBatchSampler:
    def __init__(self, inputs, batch_size: int, seed: int | None = None,
                 freeze_composition: bool = False):
        self.batch_size = batch_size
        self._rng = random.Random(seed)
        self.ind_n_len = [(i, len(p)) for i, p in enumerate(inputs)]
        self.freeze_composition = freeze_composition
        self.batch_list = self._generate_batch_map()
        self.num_batches = len(self.batch_list)

    def _generate_batch_map(self) -> list[list[int]]:
        ind_n_len = list(self.ind_n_len)
        self._rng.shuffle(ind_n_len)  # mix samples sharing a length
        ind_n_len.sort(key=lambda x: x[1])
        batch_map: OrderedDict[int, list[int]] = OrderedDict()
        for idx, length in ind_n_len:
            batch_map.setdefault(length, []).append(idx)
        flat: list[int] = []
        for indices in batch_map.values():
            flat += indices
        # duplicate-pad the tail so every batch is exactly batch_size
        if len(flat) % self.batch_size != 0:
            addition_count = self.batch_size - (len(flat) % self.batch_size)
            addition_sample = flat[(-2 * addition_count):]
            self._rng.shuffle(addition_sample)
            flat += addition_sample[:addition_count]
        return [flat[i:i + self.batch_size]
                for i in range(0, len(flat), self.batch_size)]

    def batch_count(self) -> int:
        return self.num_batches

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self):
        if not self.freeze_composition:
            self.batch_list = self._generate_batch_map()
        batches = list(self.batch_list)
        self._rng.shuffle(batches)
        yield from batches
