"""The port's flash attention on the head-major flat layout
(``PVA_FLASH_BTHD=1``: ``ops/flash.py``'s ``bthd`` section and
``models/attention.py::_mha_flash_bthd``) against the JAX package.

On the CPU the wrappers run their plain versions: the ``[B, H, T, d]``
views of ``[B, T, H*d]`` around ``flash_fwd_ref`` and the backward's, and
the backward's dispatch (the fused form in place, or the split on
transposes).  They are held against JAX's ``flash_self_attention`` on its
XLA path on transposed operands (``tests/test_flash_pallas.py`` pins the
Pallas ``bthd`` forms to it), and ``mha_self_attention`` under the flag
against JAX's unfolded path, train and eval, and the attn model under the
flag against JAX's.  The CUDA kernels are held against the plain versions
in ``test_torch_cuda_kernels.py``, which runs only with a card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_video_action_tpu.models import attention as JA
from pytorch_video_action_tpu.models import build_model as jbuild
from pytorch_video_action_tpu.ops import flash as jflash
from pytorch_video_action_tpu.ops import hashmask as jhash
from pytorch_video_action_tpu.train import checkpoint as jckpt
from pytorch_video_action_tpu_torch.models import attention as A
from pytorch_video_action_tpu_torch.models import build_model
from pytorch_video_action_tpu_torch.models.params import from_jax_params
from pytorch_video_action_tpu_torch.ops import flash as F

KEY = jax.random.PRNGKey(7)
SEED = int(jhash.rng_seed_u32(KEY))
N_CLASS = 7


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _flat(a):  # [B, H, T, d] -> [B, T, H*d]
    b, h, t, d = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b, t, h * d))


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("fused", [True, False])  # the fused form / split
def test_bthd_matches_jax_on_transposed_operands(rate, fused):
    """q, k, v, dout ``[B, T, H*d]`` (H=2, d=128, T=200, a fully masked
    video) through the port's head-major forward and backward against
    JAX's ``flash_self_attention`` on the ``[B, H, T, d]`` operands: out
    to 5e-5 and dq, dk, dv to 2e-4 (``tests/test_flash_pallas.py``'s
    tolerances); lse ``[B*H, T]``."""
    b, h, t, d = 2, 2, 200, 128
    rng = np.random.default_rng(0)
    q, k, v, dout = (rng.normal(size=(b, h, t, d)).astype(np.float32)
                     for _ in range(4))
    mask = rng.random((b, t)) > 0.2
    mask[-1] = False

    def f(a, b_, c):
        return jflash.flash_self_attention(
            a, b_, c, jnp.asarray(mask), rate, KEY if rate else None, 64)

    jout, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(dout))
    tq, tk, tv, tdo = (torch.from_numpy(_flat(a)) for a in (q, k, v, dout))
    tm = torch.from_numpy(mask)
    out, lse = F.flash_fwd_bthd(tq, tk, tv, tm, h, rate, SEED)
    assert out.shape == (b, t, h * d) and lse.shape == (b * h, t)
    np.testing.assert_allclose(out.numpy(), _flat(np.asarray(jout)),
                               atol=5e-5, rtol=1e-4)
    grads = F.flash_bwd_bthd(tq, tk, tv, tm, h, rate, SEED, out, lse, tdo,
                             fused=fused)
    for name, g, w in zip("qkv", grads, jgrads):
        assert g.shape == (b, t, h * d) and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), _flat(np.asarray(w)),
                                   atol=2e-4, rtol=1e-3, err_msg=f"d{name}")
    # the autograd Function is the same backward
    leaves = [a.clone().requires_grad_(True) for a in (tq, tk, tv)]
    got = torch.autograd.grad(
        F.flash_self_attention_bthd(*leaves, tm, h, rate, SEED), leaves, tdo)
    for g, w in zip(got, grads):
        assert torch.equal(g, w)


def test_bthd_equals_the_bhtd_plain_versions():
    """The head-major plain versions are the ``[B, H, T, d]`` ones on
    transposes, bit for bit (out, lse and the three gradients)."""
    b, h, t, d = 2, 3, 70, 16
    rng = np.random.default_rng(1)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(b, h, t, d)).astype(
        np.float32)) for _ in range(4))
    mask = torch.from_numpy(np.arange(t)[None, :] < np.array([[70], [31]]))
    out, lse, _ = F.flash_fwd_ref(q, k, v, mask, 0.3, SEED)
    want = F.flash_bwd_ref(q, k, v, mask, 0.3, SEED, out, lse, dout)
    fl = [torch.from_numpy(_flat(a.numpy())) for a in (q, k, v, dout)]
    bout, blse = F.flash_fwd_bthd_ref(*fl[:3], mask, h, 0.3, SEED)
    assert torch.equal(bout, F._flat(out)) and torch.equal(
        blse, lse.reshape(b * h, t))
    got = F.flash_bwd_bthd_ref(*fl[:3], mask, h, 0.3, SEED, bout, blse, fl[3])
    for g, w in zip(got, want):
        assert torch.equal(g, F._flat(w))


def test_bthd_wrappers_count_no_cpu_launch_and_raise_without_kernel():
    b, h, t, d = 1, 2, 8, 4
    q = torch.randn(b, t, h * d)
    mask = torch.ones(b, t, dtype=torch.bool)
    counts = (F.flash_fwd_bthd.launches, F.flash_bwd_fused_bthd.launches)
    out, lse = F.flash_fwd_bthd(q, q, q, mask, h)
    F.flash_bwd_bthd(q, q, q, mask, h, 0.0, None, out, lse, q)
    assert (F.flash_fwd_bthd.launches,
            F.flash_bwd_fused_bthd.launches) == counts
    qm = q.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        F.flash_fwd_bthd(qm, qm, qm, mask.to("meta"), h)
    with pytest.raises(ValueError, match="no kernel"):
        F.flash_bwd_fused_bthd(qm, qm, qm, mask.to("meta"), h, 0.0, None,
                               lse.to("meta"), lse.to("meta"), qm)
    with pytest.raises(ValueError):  # H*d not a multiple of the heads
        F._check_bthd("flash_fwd_bthd", q, q, q, mask, 3)


@pytest.mark.parametrize("train", [False, True])
def test_mha_under_the_flag_matches_jax_unfolded(monkeypatch, train):
    """``mha_self_attention`` with ``PVA_FLASH_BTHD=1`` (the folded, padded
    projection: hd=8 pads to 128) at ``BLOCKWISE_MIN_T`` lowered, against
    JAX's unfolded flash path: the output and every parameter's and x's
    gradient of a cotangent, 5e-4 (``tests/test_flash_pallas.py``)."""
    monkeypatch.setattr(A, "BLOCKWISE_MIN_T", 64)
    monkeypatch.setattr(JA, "BLOCKWISE_MIN_T", 64)
    monkeypatch.setenv("PVA_FLASH_BTHD", "1")
    monkeypatch.setenv("PVA_FLASH_PALLAS", "0")
    rng = np.random.default_rng(5)
    b, t, e, h = 2, 160, 16, 2
    x = rng.normal(size=(b, t, e)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([[t], [t - 37]])
    cot = rng.normal(size=(b, t, e)).astype(np.float32)
    p = JA.init_mha(jax.random.PRNGKey(0), e)
    rate = 0.3 if train else 0.0

    def run(p, xx):
        out = JA.mha_self_attention(p, xx, h, key_mask=jnp.asarray(mask),
                                    dropout_rate=rate, train=train, rng=KEY)
        return jnp.sum(out * cot), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(run, argnums=(0, 1),
                                               has_aux=True)(p, jnp.asarray(x))
    mha = A.MHA(e)
    with torch.no_grad():
        for k, v in p.items():
            getattr(mha, k).copy_(torch.from_numpy(np.array(v)))
    calls = []
    fn = F.flash_self_attention_bthd
    monkeypatch.setattr(A, "flash_self_attention_bthd",
                        lambda *a: calls.append(a[0].shape) or fn(*a))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = A.mha_self_attention(mha, xt, h, key_mask=torch.from_numpy(mask),
                               dropout_rate=rate, train=train,
                               seed=SEED if train else None)
    (out * torch.from_numpy(cot)).sum().backward()
    assert calls == [(b, t, h * 128)]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=5e-4,
                               rtol=1e-3)
    for k, w in jgp.items():
        np.testing.assert_allclose(getattr(mha, k).grad.numpy(),
                                   np.asarray(w), atol=5e-4, rtol=1e-3,
                                   err_msg=k)


def test_attn_under_the_flag_matches_jax(monkeypatch):
    """The attn model at ``BLOCKWISE_MIN_T`` lowered to 256 (padded T=320,
    dropout on with the JAX seed) under ``PVA_FLASH_BTHD=1`` against the
    JAX model: log-probs on valid frames and every gradient, 5e-4.  (At
    T=256 exactly JAX's own float32 step is the one that stands apart:
    ``test_torch_attn_t256.py`` holds the port there against JAX in
    float64; ROADMAP.md §3, reference behaviour the port keeps.)"""
    monkeypatch.setattr(A, "BLOCKWISE_MIN_T", 256)
    monkeypatch.setattr(JA, "BLOCKWISE_MIN_T", 256)
    monkeypatch.setenv("PVA_FLASH_BTHD", "1")
    monkeypatch.setenv("PVA_FLASH_PALLAS", "0")
    mdef = jbuild("attn", N_CLASS)
    params = mdef.init(jax.random.PRNGKey(1))
    model = build_model("attn", N_CLASS)
    model.load_state_dict(from_jax_params("attn", jax.tree.map(np.asarray,
                                                               params)))
    t = 320
    rng = np.random.default_rng(3)
    lengths = np.array([t, 150], np.int32)
    x = rng.normal(size=(2, t, 400)).astype(np.float32)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    valid = np.arange(t)[None, :] < lengths[:, None]
    cot = rng.normal(size=(2, t, N_CLASS)).astype(np.float32) * valid[
        :, :, None]
    key = jax.random.PRNGKey(9)

    def jf(p):
        out = mdef.apply(p, jnp.asarray(x), jnp.asarray(lengths), train=True,
                         rng=key)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jf, has_aux=True))(params)
    seed = int(jhash.rng_seed_u32(jax.random.split(key, 2)[0]))
    out = model(torch.from_numpy(x), torch.from_numpy(lengths), train=True,
                seeds=[seed])
    (out * torch.from_numpy(cot)).sum().backward()
    assert _rel_err(out.detach().numpy()[valid],
                    np.asarray(want)[valid]) <= 5e-4
    flat = {k: np.asarray(v) for k, v in jckpt._flatten(jgrads).items()}
    for k, p in model.named_parameters():
        assert _rel_err(p.grad.numpy(), flat[k.replace(".", "/")]) <= 5e-4, k
