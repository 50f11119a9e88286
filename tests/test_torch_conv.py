"""The port's MS-TCN convolutions (``pytorch_video_action_tpu_torch/ops/
conv.py``) against the JAX package's XLA oracles, which the JAX suite pins
against the Pallas kernels (``tests/test_pallas_kernels.py``): the layer's
plain versions (eval, global-stream train form, per-video form, VJP), the
stage's, and ``DilatedResidualFn`` on the CPU.

Inputs are made from numpy seeds and handed to both: B=3 videos of T=40
frames with ragged lengths and non-zero values on the padded rows (as
``conv_in`` leaves them), C=64, dilations on both sides of T (d < T,
d = T-1, d = T, d >> T).  Tolerances: f32 1e-5 for the forwards (the
same sums in another order; the stage's relative to its largest value),
the backward at
``test_conv_fused_bwd_matches_autodiff``'s 2e-4 absolute, 1e-3 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_video_action_tpu.ops import conv as jconv
from pytorch_video_action_tpu.ops import conv_pallas as jpallas
from pytorch_video_action_tpu.ops import hashmask as jhash
from pytorch_video_action_tpu_torch.ops import conv as P

B, T = 3, 40
LENGTHS = np.array([40, 23, 7])
DILATIONS = [1, 8, 39, 40, 4096]


def _layer(seed, scale=0.1):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)
    return {"conv_dilated": {"w": mk(3, P.C, P.C), "b": mk(P.C)},
            "conv_1x1": {"w": mk(1, P.C, P.C), "b": mk(P.C)}}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, P.C)).astype(np.float32)  # padded rows too
    mask = (np.arange(T)[None, :] < LENGTHS[:, None]).astype(np.float32)
    dy = rng.normal(size=(B, T, P.C)).astype(np.float32)
    return x, mask, dy


def _torch_layer(layer):
    return [torch.from_numpy(layer[k][p]) for k, p in
            (("conv_dilated", "w"), ("conv_dilated", "b"),
             ("conv_1x1", "w"), ("conv_1x1", "b"))]


def _jax_tree(layer):
    return jax.tree.map(jnp.asarray, layer)


@pytest.mark.parametrize("dilation", DILATIONS)
@pytest.mark.parametrize("train", [False, True])
def test_layer_matches_jax_default_path(dilation, train):
    layer = _layer(dilation)
    x, mask, _ = _inputs(dilation + 1)
    key = jax.random.PRNGKey(dilation)
    want = jconv.dilated_residual_layer(
        _jax_tree(layer), jnp.asarray(x), jnp.asarray(mask)[:, :, None],
        dilation=dilation, dropout_rate=0.5, train=train, rng=key)
    seed = int(jhash.rng_seed_u32(key))
    got = P.layer_ref(*_torch_layer(layer), torch.from_numpy(x),
                      torch.from_numpy(mask), dilation,
                      0.5 if train else 1.0, seed=seed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert not got[1, 23:].any() and not got[2, 7:].any()
    if train:
        km = P.keep_bits((B, T, P.C), 0.5, seed=seed)
        jkm = jhash.keep_mask(jnp.uint32(seed), (B, T, P.C),
                              jhash.threshold(0.5))
        np.testing.assert_array_equal(km.numpy(), np.asarray(jkm))


@pytest.mark.parametrize("dilation", [1, 39, 4096])
def test_layer_per_video_stream_matches_pallas_oracle(dilation):
    layer = _layer(10 + dilation)
    x, mask, _ = _inputs(20 + dilation)
    seeds = np.random.default_rng(dilation).integers(0, 2 ** 32, B,
                                                     dtype=np.uint32)
    want = jpallas.hash_dropout_reference(
        _jax_tree(layer), jnp.asarray(x), jnp.asarray(mask), dilation, 0.5,
        jnp.asarray(seeds))
    got = P.layer_ref(*_torch_layer(layer), torch.from_numpy(x),
                      torch.from_numpy(mask), dilation, 0.5, seeds=seeds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def _stacked(layers):
    wd = np.stack([l["conv_dilated"]["w"] for l in layers])
    bd = np.stack([l["conv_dilated"]["b"] for l in layers])
    wp = np.stack([l["conv_1x1"]["w"][0] for l in layers])
    bp = np.stack([l["conv_1x1"]["b"] for l in layers])
    return wd, bd, wp, bp


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_stage_matches_pallas_oracle(rate):
    """5 layers at T=40: dilations 1, 2, 4, 8, 16 (the model's 2^i); at
    T=12 the last two collapse to d = T."""
    layers = [_layer(30 + i) for i in range(5)]
    wd, bd, wp, bp = _stacked(layers)
    x, mask, _ = _inputs(7)
    seeds = np.random.default_rng(3).integers(0, 2 ** 32, (B, 5),
                                              dtype=np.uint32)
    keep = 1.0 - rate
    for t in (T, 12):
        wcat = jnp.asarray(wd.reshape(5, 3 * P.C, P.C))
        want = jpallas._stage_xla(
            wcat, jnp.asarray(bd), jnp.asarray(wp), jnp.asarray(bp),
            jnp.asarray(x[:, :t]), jnp.asarray(mask[:, :t, None]),
            jnp.asarray(seeds) if rate else None,
            tuple(P.stage_dilations(5, t)), keep)
        got = P.stage_ref(*map(torch.from_numpy, (wd, bd, wp, bp)),
                          torch.from_numpy(x[:, :t].copy()),
                          torch.from_numpy(mask[:, :t].copy()), keep,
                          seeds if rate else None)
        # five residual layers grow the values to about 6 at dropout 0.5:
        # 1e-5 of the largest
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dilation", DILATIONS)
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_layer_bwd_matches_jax_vjp(dilation, rate):
    layer = _layer(40 + dilation)
    x, mask, dy = _inputs(50 + dilation)
    key = jax.random.PRNGKey(7)
    jmask = jnp.asarray(mask)[:, :, None]

    def f(lay, xx):
        return jconv.dilated_residual_layer(
            lay, xx, jmask, dilation=dilation, dropout_rate=rate,
            train=True, rng=key)

    _, vjp = jax.vjp(f, _jax_tree(layer), jnp.asarray(x))
    glay, gx = vjp(jnp.asarray(dy))
    w_d, b_d, w_p, _ = _torch_layer(layer)
    got = P.layer_bwd_ref(w_d, b_d, w_p, torch.from_numpy(x),
                          torch.from_numpy(mask), torch.from_numpy(dy),
                          dilation, 1.0 - rate,
                          seed=int(jhash.rng_seed_u32(key)))
    want = [gx, glay["conv_dilated"]["w"], glay["conv_dilated"]["b"],
            glay["conv_1x1"]["w"], glay["conv_1x1"]["b"]]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("dilation", [1, 39, 40])
@pytest.mark.parametrize("keep", [1.0, 0.5])
def test_autograd_function_equals_autograd_through_plain(dilation, keep):
    """``DilatedResidualFn`` on CPU tensors: the plain forward, backward
    through ``layer_bwd_ref``, equal to autograd through ``layer_ref``."""
    x, mask, dy = _inputs(60 + dilation)
    grads = []
    for use_fn in (True, False):
        ws = [w.clone().requires_grad_(True)
              for w in _torch_layer(_layer(70 + dilation))]
        xt = torch.from_numpy(x).requires_grad_(True)
        args = (*ws, xt, torch.from_numpy(mask), dilation, keep, 1234)
        y = (P.DilatedResidualFn.apply(*args) if use_fn
             else P.layer_ref(*args[:-1], seed=1234))
        y.backward(torch.from_numpy(dy))
        grads.append([xt.grad, *(w.grad for w in ws)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_bf16_layer_within_bf16_of_jax():
    """bf16: the port takes f32 operands and rounds once at the output; the
    JAX XLA path rounds each product and sum to bf16.  They stay within
    3e-2 of the f32 result's scale (measured here: about 1.6e-2)."""
    layer = _layer(80, scale=0.1)
    x, mask, _ = _inputs(81)
    key = jax.random.PRNGKey(1)
    jtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), layer)
    want = jconv.dilated_residual_layer(
        jtree, jnp.asarray(x, jnp.bfloat16),
        jnp.asarray(mask, jnp.bfloat16)[:, :, None], dilation=4,
        dropout_rate=0.5, train=True, rng=key)
    got = P.layer_ref(*(w.to(torch.bfloat16) for w in _torch_layer(layer)),
                      torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(mask), 4, 0.5,
                      seed=int(jhash.rng_seed_u32(key)))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert diff <= 3e-2 * max(1.0, np.abs(np.asarray(want, np.float32)).max())


def test_wrappers_take_the_plain_versions_on_cpu():
    layer = _torch_layer(_layer(90))
    x, mask, dy = (torch.from_numpy(a) for a in _inputs(91))
    wd, bd, wp, bp = (torch.stack([w] * 2) for w in
                      (layer[0], layer[1], layer[2][0], layer[3]))
    counts = (P.dilated_residual_layer.launches,
              P.dilated_residual_layer_bwd.launches, P.fused_stage.launches)
    assert torch.equal(P.dilated_residual_layer(*layer, x, mask, 8, 0.5, 5),
                       P.layer_ref(*layer, x, mask, 8, 0.5, 5))
    for a, b in zip(P.dilated_residual_layer_bwd(*layer[:3], x, mask, dy, 8,
                                                 0.5, 5),
                    P.layer_bwd_ref(*layer[:3], x, mask, dy, 8, 0.5, 5)):
        assert torch.equal(a, b)
    assert torch.equal(P.fused_stage(wd, bd, wp, bp, x, mask),
                       P.stage_ref(wd, bd, wp, bp, x, mask))
    assert counts == (P.dilated_residual_layer.launches,
                      P.dilated_residual_layer_bwd.launches,
                      P.fused_stage.launches)
    meta = x.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        P.dilated_residual_layer(*layer, meta, mask, 8)


def test_dropout_without_a_seed_raises():
    layer = _torch_layer(_layer(95))
    x, mask, _ = (torch.from_numpy(a) for a in _inputs(96))
    with pytest.raises(ValueError, match="seed"):
        P.layer_ref(*layer, x, mask, 1, 0.5)


def test_init_conv1d_draws_the_jax_distribution():
    p = P.init_conv1d(400, 64, 1, torch.Generator().manual_seed(0))
    k = 1.0 / np.sqrt(400)
    assert p.w.shape == (1, 400, 64) and p.b.shape == (64,)
    assert p.w.abs().max().item() <= k and p.b.abs().max().item() <= k
    assert p.w.abs().max().item() > 0.95 * k
    jp = jconv.init_conv1d(jax.random.PRNGKey(0), 400, 64, 1)
    assert jp["w"].shape == tuple(p.w.shape)
