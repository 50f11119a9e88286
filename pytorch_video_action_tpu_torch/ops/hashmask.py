"""Counter-based dropout masks: murmur3-fmix32 over element indices.

Counterpart of ``pytorch_video_action_tpu/ops/hashmask.py``: for the same
uint32 seed, shape, offset and strides, :func:`keep_mask` is bit-equal to
the JAX ``hashmask.keep_mask``.

uint32 arithmetic is emulated in int64 with ``& 0xFFFFFFFF`` on every
device, because torch's CPU uint32 ``>>`` and ``<`` raise.  Products are
split into 16-bit halves so no intermediate leaves int64's range.

Seeds are explicit uint32 integers.  The JAX package derives them from
PRNG key splits (``hashmask.rng_seed_u32``), which the port cannot
reproduce; its callers draw seeds from a ``torch.Generator``.  So a run
with dropout at test time (``--parity_quirks``) draws other masks than
the JAX package does, and its CSV is not expected to equal the JAX one.
"""

from __future__ import annotations

import torch

GOLDEN = 0x9E3779B9
_M32 = 0xFFFFFFFF


def threshold(keep: float) -> int:
    """uint32 compare threshold such that P(fmix32(x) < threshold) == keep."""
    return min(_M32, int(round(keep * 2.0 ** 32)))


def _mul32(v, c: int):
    """``(v * c) mod 2**32`` for v in [0, 2**32) (int or int64 tensor)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (v * lo + (((v * hi) & 0xFFFF) << 16)) & _M32


def fmix32(v):
    """murmur3 finalizer over uint32 values held in ints or int64 tensors."""
    v = v ^ (v >> 16)
    v = _mul32(v, 0x85EBCA6B)
    v = v ^ (v >> 13)
    v = _mul32(v, 0xC2B2AE35)
    v = v ^ (v >> 16)
    return v


def stream_key(seed: int, offset: int | None = None) -> int:
    """Scalar key of the (seed, offset) stream, as ``keep_mask`` folds it."""
    key = int(seed) & _M32
    if offset is not None:
        key ^= _mul32(int(offset) & _M32, 0x85EBCA77)
    return fmix32((key + GOLDEN) & _M32)


def keep_mask(seed: int, shape, thresh: int, offset: int | None = None,
              strides=None, device=None) -> torch.Tensor:
    """iid-Bernoulli(keep) boolean mask over ``shape``.

    The element index is the row-major position, or ``sum(i_a * strides[a])``
    when ``strides`` is given (a time-major ``[T, B, C]`` view of a
    batch-major stream passes ``strides=(C, T*C, 1)``)."""
    shape = tuple(int(s) for s in shape)
    if strides is None:
        strides, stride = [], 1
        for size in reversed(shape):
            strides.append(stride)
            stride *= size
        strides = strides[::-1]
    idx = torch.zeros(shape, dtype=torch.int64, device=device)
    for axis, (size, stride) in enumerate(zip(shape, strides)):
        view = [1] * len(shape)
        view[axis] = size
        iota = torch.arange(size, dtype=torch.int64, device=device).view(view)
        idx = (idx + _mul32(iota, int(stride) & _M32)) & _M32
    return fmix32(idx ^ stream_key(seed, offset)) < int(thresh)


def hash_dropout(seed: int, x: torch.Tensor, keep: float,
                 strides=None) -> torch.Tensor:
    """Inverted dropout with the keep-mask drawn from the hash stream."""
    km = keep_mask(seed, x.shape, threshold(keep), strides=strides,
                   device=x.device)
    return torch.where(km, x * (1.0 / keep), torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
