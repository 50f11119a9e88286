"""The port's counter-hash dropout stream (``pytorch_video_action_tpu_torch/
ops/hashmask.py``) is bit-equal to the JAX package's ``ops/hashmask.py`` for
the same uint32 seeds, shapes, offsets and strides.  The port emulates
uint32 in int64, so the edge seeds near 2**32 are the ones to watch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_video_action_tpu.ops import hashmask as J
from pytorch_video_action_tpu_torch.ops import hashmask as P

SEEDS = [0, 1, 0x9E3779B9, 0xFFFFFFFF, 2 ** 31 + 12345]


@pytest.mark.parametrize("keep", [0.0, 0.1, 0.5, 0.7, 1.0])
def test_threshold_matches(keep):
    assert P.threshold(keep) == J.threshold(keep)


def test_fmix32_matches_on_random_words():
    words = np.random.default_rng(0).integers(0, 2 ** 32, 4096, dtype=np.uint64)
    words = np.concatenate([words, [0, 1, 2 ** 32 - 1, 2 ** 31]]).astype(np.uint64)
    want = np.asarray(J.fmix32(jnp.asarray(words.astype(np.uint32))))
    got = P.fmix32(torch.from_numpy(words.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,offset,strides", [
    ((257,), None, None),
    ((6, 33), 7, None),
    ((3, 5, 40), None, None),
    ((3, 5, 40), 2 ** 32 - 3, None),
    # time-major [T, B, 2H] view of a batch-major stream (ops/rnn.py:403-406)
    ((9, 4, 32), None, (32, 9 * 32, 1)),
])
def test_keep_mask_bit_equal(seed, shape, offset, strides):
    thresh = P.threshold(0.5)
    want = np.asarray(J.keep_mask(jnp.uint32(seed), shape, thresh,
                                  offset=offset, strides=strides))
    got = P.keep_mask(seed, shape, thresh, offset=offset, strides=strides)
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_strided_time_major_mask_equals_batch_major_transpose():
    t, b, c = 7, 3, 16
    bm = P.keep_mask(11, (b, t, c), P.threshold(0.5))
    tm = P.keep_mask(11, (t, b, c), P.threshold(0.5), strides=(c, t * c, 1))
    assert torch.equal(tm, bm.transpose(0, 1))


def test_hash_dropout_matches_jax_for_key_seed():
    key = jax.random.PRNGKey(3)
    x = np.random.default_rng(1).normal(size=(4, 10, 24)).astype(np.float32)
    want = np.asarray(J.hash_dropout(key, jnp.asarray(x), 0.5))
    got = P.hash_dropout(int(J.rng_seed_u32(key)), torch.from_numpy(x), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)
