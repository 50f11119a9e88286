"""Length buckets (own copy of ``bucket_length`` from
``pytorch_video_action_tpu/data/collate.py``).

Padded lengths round up to multiples of ``bucket_multiple`` (default 128),
so batches come in few distinct shapes; ``bucket_multiple <= 1`` keeps the
exact length.
"""

from __future__ import annotations


def bucket_length(length: int, bucket_multiple: int = 128, min_len: int = 0) -> int:
    length = max(length, min_len, 1)
    if bucket_multiple <= 1:
        return length
    return -(-length // bucket_multiple) * bucket_multiple
