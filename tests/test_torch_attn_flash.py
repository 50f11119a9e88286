"""The port's flash attention (``pytorch_video_action_tpu_torch/ops/
flash.py``) against the JAX package's ``flash_self_attention`` on its XLA
path (what JAX runs on the CPU; ``tests/test_flash_pallas.py`` pins the
Pallas kernels to it): values, and gradients through ``jax.vjp``.

Inputs are numpy draws from a seed; the dropout seed is the one JAX
derives from its PRNG key (``hashmask.rng_seed_u32``).  f32 throughout,
1e-5 of each tensor's largest element (at least 1): the same sums in
another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_video_action_tpu.ops import flash as jflash
from pytorch_video_action_tpu.ops import hashmask as jhash
from pytorch_video_action_tpu_torch.ops import flash as F

TOL = 1e-5
KEY = jax.random.PRNGKey(7)
SEED = int(jhash.rng_seed_u32(KEY))

# (B, H, T, d, lengths): ragged key masks with a zero-length video, T not a
# multiple of the 64-column block
CASES = [(3, 2, 150, 20, [150, 77, 0]), (2, 4, 64, 100, [64, 1]),
         (1, 1, 97, 8, [50])]


def _case(b, h, t, d, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.normal(size=(b, h, t, d)).astype(np.float32)
                     for _ in range(4))
    q /= np.sqrt(d)
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, mask, dout


def _jax(q, k, v, mask, dout, rate):
    def f(a, b, c):
        return jflash.flash_self_attention(
            a, b, c, jnp.asarray(mask), rate, KEY if rate > 0 else None, 64)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(a) for a in (out, *vjp(jnp.asarray(dout)))]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol, what):
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, (what, err)


@pytest.mark.parametrize("case", CASES, ids=["ragged", "d100", "one_row"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_plain_versions_match_jax(case, rate):
    """Both block sizes of the scan give JAX's values and gradients, so
    they sample the same dropout mask."""
    q, k, v, mask, dout = _case(*case)
    want = _jax(q, k, v, mask, dout, rate)
    tq, tk, tv, tm, tdo = _t(q, k, v, mask, dout)
    for block in (64, 48):
        out, lse, row_valid = F.flash_fwd_ref(tq, tk, tv, tm, rate, SEED,
                                              block=block)
        grads = F.flash_bwd_ref(tq, tk, tv, tm, rate, SEED, out, lse, tdo,
                                block=block)
        for name, g, w in zip(("out", "dq", "dk", "dv"), (out, *grads),
                              want):
            assert g.dtype == torch.float32 and g.shape == w.shape, name
            _close(g.numpy(), w, TOL, f"{name} block {block}")
        # rows of a zero-length video: zero output, zero lse, zero grads
        dead = ~tm.any(dim=-1)
        assert (out[dead] == 0).all() and (lse[dead] == 0).all()
        assert not row_valid[dead].any() and row_valid[~dead].all()
        assert (grads[0][dead] == 0).all()


def test_lse_matches_jax_scan():
    q, k, v, mask, _ = _case(*CASES[0])
    _, want, _ = jflash._flash_fwd_scan(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        0.3, KEY, 64)
    _, lse, _ = F.flash_fwd_ref(*_t(q, k, v, mask), 0.3, SEED)
    _close(lse.numpy(), np.asarray(want), TOL, "lse")


@pytest.mark.parametrize("col0,t_kv,cols", [(0, 150, 64), (128, 150, 64),
                                            (64, 97, 33)])
def test_block_keep_mask_bit_equals_jax(col0, t_kv, cols):
    shape = (3, 2, 37, cols)
    want = np.asarray(jflash._block_keep_mask(KEY, col0, t_kv, 0.7, shape))
    got = F.block_keep_mask(SEED, col0, t_kv, 0.7, shape).numpy()
    assert np.array_equal(got, want)


def test_block_keep_mask_is_the_dense_stream():
    """The flash stream over all columns is ``hash_dropout``'s row-major
    stream over ``[B, H, T, T]``: the dense path draws the same mask."""
    from pytorch_video_action_tpu_torch.ops import hashmask

    shape = (2, 3, 40, 40)
    dense = hashmask.keep_mask(SEED, shape, hashmask.threshold(0.7))
    assert torch.equal(F.block_keep_mask(SEED, 0, 40, 0.7, shape), dense)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_autograd_function_is_the_plain_backward(rate):
    """On CPU tensors the wrappers are the plain versions, and
    ``flash_self_attention`` differentiates through ``flash_bwd``."""
    q, k, v, mask, dout = _case(*CASES[0], seed=3)
    tq, tk, tv, tm, tdo = _t(q, k, v, mask, dout)
    leaves = [a.clone().requires_grad_(True) for a in (tq, tk, tv)]
    out = F.flash_self_attention(*leaves, tm, rate, SEED)
    out.backward(tdo)
    ref_out, lse, _ = F.flash_fwd_ref(tq, tk, tv, tm, rate, SEED)
    want = F.flash_bwd_ref(tq, tk, tv, tm, rate, SEED, ref_out, lse, tdo)
    assert torch.equal(out.detach(), ref_out)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    got_out, got_lse = F.flash_fwd(tq, tk, tv, tm, rate, SEED)
    assert torch.equal(got_out, ref_out) and torch.equal(got_lse, lse)


def test_bf16_plain_versions_stay_near_f32():
    """bf16 operands, f32 softmax state: near the f32 result on the same
    (bf16-representable) inputs.  They differ by the rounding of the
    dropped p, of ds and of the outputs to bf16 (2**-8 relative each); ds
    has both signs, so its sums over 64 rows cancel and dk moves most:
    4.1e-2 of its largest element here with dropout, under the 6e-2
    allowed."""
    q, k, v, mask, dout = _case(*CASES[1], seed=4)
    b16 = [a.to(torch.bfloat16) if a.dtype == torch.float32 else a
           for a in _t(q, k, v, mask, dout)]
    f32 = [a.float() if a.dtype == torch.bfloat16 else a for a in b16]
    res = {}
    for name, (tq, tk, tv, tm, tdo) in (("f32", f32), ("bf16", b16)):
        out, lse, _ = F.flash_fwd_ref(tq, tk, tv, tm, 0.3, SEED)
        res[name] = (out, *F.flash_bwd_ref(tq, tk, tv, tm, 0.3, SEED, out,
                                           lse, tdo))
        assert lse.dtype == torch.float32
    for g, w in zip(res["bf16"], res["f32"]):
        assert g.dtype == torch.bfloat16
        _close(g.float().numpy(), w.numpy(), 6e-2, "bf16")


def test_wrappers_have_no_fallback():
    q = torch.zeros((1, 1, 4, 8), device="meta")
    mask = torch.ones((1, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        F.flash_fwd(q, q, q, mask)
    with pytest.raises(ValueError, match="no kernel"):
        F.flash_bwd(q, q, q, mask, 0.0, None, q, q[..., 0], q)
    for part in (F.flash_bwd_fused, F.flash_bwd_dkdv, F.flash_bwd_dq):
        with pytest.raises(ValueError, match="no kernel"):
            part(q, q, q, mask, 0.0, None, q[..., 0], q[..., 0], q)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_backward_parts_are_the_plain_backward(rate):
    """On CPU tensors the fused and the split wrappers, from ``delta``, give
    the plain backward's gradients (dq in f32)."""
    q, k, v, mask, dout = _t(*_case(*CASES[0], seed=5))
    out, lse, _ = F.flash_fwd_ref(q, k, v, mask, rate, SEED)
    want = F.flash_bwd_ref(q, k, v, mask, rate, SEED, out, lse, dout)
    delta = (dout * out).sum(dim=-1)
    args = (q, k, v, mask, rate, SEED, lse, delta, dout)
    fused = F.flash_bwd_fused(*args)
    split = (F.flash_bwd_dq(*args), *F.flash_bwd_dkdv(*args))
    for got in (fused, split):
        assert got[0].dtype == torch.float32
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_dropout_needs_a_seed():
    q, k, v, mask = _t(*_case(*CASES[2])[:4])
    with pytest.raises(ValueError, match="seed"):
        F.flash_fwd_ref(q, k, v, mask, 0.3, None)


@pytest.mark.parametrize("bh,t,fused", [
    (32, 1024, True), (32, 1280, True), (32, 1408, False), (32, 2560, False),
    (16, 4096, False), (4, 1280, True), (4, 2560, False), (200, 4096, True)])
def test_backward_dispatch(bh, t, fused):
    """On 132 SMs at d=100: the fused form while its partial-dq scratch
    fits the budget (B*H = 32 at batch 8 up to T = 1280), the split
    beyond; one chunk (B*H >= SMs) needs no scratch."""
    assert F.use_fused(bh, t, t, 100, 132) is fused
    chunks = F.fused_chunks(bh, t, 132)
    assert 1 <= chunks <= -(-t // F.TILE)
    assert chunks == max(1, min(-(-t // 64), 132 // bh))
