"""The port's GRU scan (``pytorch_video_action_tpu_torch/ops/rnn_scan.py``)
and the bidirectional GRU stack's scan route (``ops/rnn.py::gru_apply`` at
widths the fused layer kernel does not take) against the JAX package.

On the CPU the wrappers run their plain PyTorch versions.  Those are held
against the JAX package's XLA scan ``rnn._scan_packed("gru", ...)`` (Pallas
is off on the CPU), forward and ``jax.vjp``, and the stack against JAX's
``gru_apply`` on its XLA fallback, which packs both directions into one
scan.  The CUDA kernels themselves are held against the plain versions in
``test_torch_cuda_kernels.py``, which runs only with a card.

f32: 1e-5 of each tensor's largest element (at least 1), the same sums in
another order; bf16: 3e-2 (the port carries h and the gate math in f32
and rounds h before the product, the XLA scan rounds every step's values).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_video_action_tpu.models import attention as jattn
from pytorch_video_action_tpu.models import gru as jgru
from pytorch_video_action_tpu.ops import hashmask as jhash
from pytorch_video_action_tpu.ops import rnn as R
from pytorch_video_action_tpu.train import checkpoint as jckpt
from pytorch_video_action_tpu_torch.models import build_model
from pytorch_video_action_tpu_torch.models.params import from_jax_params
from pytorch_video_action_tpu_torch.ops import rnn as PR
from pytorch_video_action_tpu_torch.ops import rnn_scan as S


@pytest.fixture
def xla_scan():
    """JAX's scan on its XLA path, whatever PVA_USE_PALLAS says."""
    orig = R.USE_PALLAS
    R.USE_PALLAS = False
    yield
    R.USE_PALLAS = orig


def _inputs(seed, t, b, w):
    """``xg [T, B, 3W]``, ``wh [W, 3W]``, ``bh [3W]``, prefix-form lengths
    (one at T, one at 1 when B > 2), a cotangent ``[T, B, W]``."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(w)
    xg = rng.normal(0, 0.5, size=(t, b, 3 * w)).astype(np.float32)
    wh = rng.uniform(-k, k, size=(w, 3 * w)).astype(np.float32)
    bh = rng.uniform(-k, k, size=(3 * w,)).astype(np.float32)
    lengths = rng.integers(1, t + 1, b)
    lengths[0] = t
    if b > 2:
        lengths[-1] = 1
    cot = rng.normal(size=(t, b, w)).astype(np.float32)
    return xg, wh, bh, np.asarray(lengths, np.int32), cot


def _mask(lengths, t):
    return (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)[
        :, :, None]


@functools.lru_cache(maxsize=4)
def _jax_case(seed, t, b, w, dtype):
    """The inputs of ``_inputs(seed, t, b, w)`` and the XLA scan's masked
    ys and gradients of sum(ys * cot) on them, computed once for both
    backwards of the port."""
    xg, wh, bh, lengths, cot = _inputs(seed, t, b, w)
    mask = _mask(lengths, t)
    return (xg, wh, bh, mask, cot), _jax(xg, wh, bh, mask, cot,
                                         getattr(jnp, dtype))


def _jax(xg, wh, bh, mask, cot, dtype=jnp.float32):
    """The XLA scan's masked ys and the gradients of sum(ys * cot)."""
    w = wh.shape[0]

    def f(a, b, c):
        ys = R._scan_packed("gru", a, b, c, jnp.asarray(mask, dtype), w)
        return jnp.sum(ys.astype(jnp.float32) * cot), ys

    (_, ys), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(xg, dtype), jnp.asarray(wh, dtype),
        jnp.asarray(bh, dtype))
    return [np.asarray(v, np.float32) for v in (ys, *grads)]


def _port(xg, wh, bh, mask, cot, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (xg, wh, bh)]
    ys = S.gru_scan(*leaves, torch.from_numpy(mask).to(dtype))
    (ys.float() * torch.from_numpy(cot)).sum().backward()
    return [v.detach().float().numpy()
            for v in (ys, *(a.grad for a in leaves))]


def _close(got, want, tol, names=("ys", "dxg", "dwh", "dbh")):
    for g, w, name in zip(got, want, names):
        assert g.shape == w.shape, name
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= tol * scale, name


@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("w,t,b", [(12, 24, 3), (20, 17, 2), (24, 40, 5)])
def test_scan_matches_xla_f32(monkeypatch, xla_scan, w, t, b, recompute):
    """Ragged lengths: the raw recurrence, masked, equals the XLA scan that
    freezes the carry, and so do both backwards (the saving forward and
    the saved-gates backward, or the eval form and the recompute
    backward)."""
    monkeypatch.setattr(S, "RECOMPUTE_BWD", recompute)
    args, want = _jax_case(w + t, t, b, w, "float32")
    _close(_port(*args), want, 1e-5)


@pytest.mark.parametrize("recompute", [False, True])
def test_scan_bf16_close_to_xla_bf16(monkeypatch, xla_scan, recompute):
    monkeypatch.setattr(S, "RECOMPUTE_BWD", recompute)
    args, want = _jax_case(7, 24, 3, 20, "bfloat16")
    _close(_port(*args, torch.bfloat16), want, 3e-2)


def test_plain_versions_against_xla_vjp(xla_scan):
    """Each plain version on its own, unmasked (every frame valid): the
    eval and saving forwards against the XLA scan, the residuals against
    the gates recomputed from ys, and both backwards against jax.vjp."""
    t, b, w = 16, 4, 12
    xg, wh, bh, _, cot = _inputs(3, t, b, w)
    ones = np.ones((t, b, 1), np.float32)
    ys_j, vjp = jax.vjp(
        lambda a, c, d: R._scan_packed("gru", a, c, d, jnp.asarray(ones), w),
        *(jnp.asarray(v) for v in (xg, wh, bh)))
    want = [np.asarray(v) for v in (ys_j, *vjp(jnp.asarray(cot)))]
    xt, wt, bt, dy = (torch.from_numpy(v) for v in (xg, wh, bh, cot))
    ys = S.gru_scan_fwd(xt, wt, bt)
    ys2, res = S.gru_scan_fwd_save(xt, wt, bt)
    assert torch.equal(ys, ys2) and res.shape == (t, b, 4 * w)
    hp = S._shift(ys)
    hg = torch.matmul(hp, wt) + bt
    r = torch.sigmoid(xt[..., :w] + hg[..., :w])
    assert torch.allclose(res[..., :w], r, atol=1e-6)
    assert torch.allclose(res[..., 3 * w:], hg[..., 2 * w:], atol=1e-6)
    for got in (S.gru_scan_bwd_saved(res, hp, dy, wt),
                S.gru_scan_bwd(xt, hp, dy, wt, bt)):
        _close([ys.numpy(), *(g.numpy() for g in got)], want, 1e-5)


@pytest.mark.parametrize("recompute", [False, True])
def test_gru_scan_fn_gradcheck(monkeypatch, recompute):
    """GRUScanFn's backward (saved-gates or recompute) is the derivative of
    its forward, in float64."""
    monkeypatch.setattr(S, "RECOMPUTE_BWD", recompute)
    xg, wh, bh, _, _ = _inputs(11, 6, 2, 5)
    args = [torch.from_numpy(v).double().requires_grad_() for v in
            (xg, wh * 2, bh)]
    assert torch.autograd.gradcheck(S.GRUScanFn.apply, args)


# the scans' eight wrappers: each refuses a W past the forwards' widest
# launch, naming itself and the width
SCAN_WRAPPERS = ("gru_scan_fwd", "gru_scan_fwd_save", "gru_scan_bwd_saved",
                 "gru_scan_bwd", "lstm_scan_fwd", "lstm_scan_fwd_save",
                 "lstm_scan_bwd_saved", "lstm_scan_bwd")


def test_wrappers_refuse_other_devices_and_widths():
    xg = torch.zeros(2, 1, 12, device="meta")
    wh = torch.zeros(4, 12, device="meta")
    bh = torch.zeros(12, device="meta")
    for fn in (S.gru_scan_fwd, S.gru_scan_fwd_save):
        with pytest.raises(ValueError, match="no kernel"):
            fn(xg, wh, bh)
    for dtype in (torch.float32, torch.bfloat16):
        widest = S.widest_chain(dtype, 132, _gpcs)
        assert widest == 25592  # one row's h buffers and carries: 225 KiB
        for where in SCAN_WRAPPERS:
            S.check_width(where, widest, dtype, 132, _gpcs)
            with pytest.raises(ValueError, match=f"{where}: W={widest + 1} "
                                                 f".*at most {widest}"):
                S.check_width(where, widest + 1, dtype, 132, _gpcs)


# The eval form's chain geometry (row 9, csrc/gru_scan_fwd.cu on
# scan_chain.cuh): ``fits`` of a card of 132 SMs whose GPCs hold 30
# clusters of 4 blocks, 15 of 8 and 7 of 16, or one that runs no 16-block
# cluster.
def _gpcs(nc):
    return {4: 30, 8: 15, 16: 7}.get(nc, 132 // nc)


def _no16(nc):
    return 0 if nc == 16 else _gpcs(nc)


def _check_chain(geo, w, size):
    """A unit's four lane groups of s slices fit one warp and the block's
    threads the kernel's 256; every block owns a unit, every round too;
    the slices cover W, the registers' FWD_REG_VALS first, then ``ls`` of
    shared memory (none in rounds), the rest through L2; h's two buffers,
    the mbarriers and the weights or carries fit the shared memory."""
    u = -(-w // geo.nc)
    ut = -(-u // geo.rounds)
    assert (geo.nc - 1) * u < w and (geo.rounds - 1) * ut < u
    assert 32 % (4 * geo.s) == 0
    assert 4 * ut * geo.s <= geo.threads <= S.FWD_THREADS
    assert geo.s * geo.depth >= w and geo.ls % (16 // size) == 0
    assert min(geo.depth, S.FWD_REG_VALS) + geo.ls <= geo.depth
    assert geo.smem <= S.FWD_SMEM
    assert geo.rounds == 1 or geo.ls == 0


def _widths(widest):
    """Every W up to 2048 (where the geometry's tiers change), then every
    97th up to the widest and the last few below it."""
    return sorted({*range(1, 2049), *range(2049, widest, 97),
                   *range(widest - 8, widest + 1)})


@pytest.mark.parametrize("fits", [_gpcs, _no16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_fwd_geometry_covers_every_width(dtype, fits):
    """Every W the GRU scan takes (up to the forwards' widest launch) has a
    launch within the register and shared-memory budgets, at serving,
    training and bench batches, for both forwards (row 10 runs row 9's
    chain); the backwards (rows 11 and 12) take every such W too (row 11's
    chain with its 3W gradients a row, row 12's buffers in one of their
    forms); two blocks at W=96 (attn's and BiGRU 192's scan), eight at
    W=256 (BiGRU 512's) whose registers hold wh; W=768 through L2 or in
    rounds."""
    size = 4 if dtype == torch.float32 else 2
    widest = S.widest_chain(dtype, 132, fits)
    for w in _widths(widest):
        for b in (1, 3, 8, 64):
            geo = S.chain_geometry(b, w, dtype, 132, fits)
            _check_chain(geo, w, size)
            _check_chain(S.chain_geometry(b, w, dtype, 132, fits, inputs=3,
                                          gx=True, carries=2), w, size)
            form = S.scan_form("gru_scan_bwd", b, w)
            assert form.rows == 1 or form.form == "full"
    with pytest.raises(ValueError, match="no launch"):
        S.chain_geometry(1, widest + 1, dtype, 132, fits)
    geo = S.chain_geometry(3, 96, dtype, 132, fits)
    assert geo.nc == 2 and geo.depth <= S.FWD_REG_VALS
    geo = S.chain_geometry(8, 256, dtype, 132, fits)
    assert (geo.nc, geo.rows) == (8, 1) and geo.depth <= S.FWD_REG_VALS
    geo = S.chain_geometry(8, 768, dtype, 132, fits)
    assert geo.depth > S.FWD_REG_VALS + geo.ls or geo.rounds > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_bwd_saved_takes_every_width_the_forward_takes(dtype):
    """Row 11's chain (``scan_launch("gru_scan_bwd_saved")``: 3W rounded
    gradients a row, two carries a unit in rounds) at every W the forwards'
    widest launch allows (25592 on a 132-SM card), at serving, training and
    bench batches: the forward's blocks and slices where registers alone
    hold wh (W=256: eight blocks, one row a chain at B=8), rounds past
    W=1024 with one, two or four rows a chain, and past W=8824, where even
    one row's two buffers of 3W gradients pass the shared memory, the
    gradients in device memory (gx), one row a chain; each launch's shared
    memory is its buffers, the mbarriers and its weights or carries."""
    widest = S.widest_chain(dtype, 132, _gpcs)
    widths = sorted({*range(1, 1025, 7), *range(1025, widest, 97),
                     *range(widest - 4, widest + 1), 8824, 8825, 12000})
    size = 4 if dtype == torch.float32 else 2
    reg = S.FWD_REG_VALS
    for w in widths:
        for b in (1, 8, 64):
            geo = S.chain_geometry(b, w, dtype, 132, _gpcs, inputs=3,
                                   gx=True, carries=2)
            _check_chain(geo, w, size)
            fwd = S.chain_geometry(b, w, dtype, 132, _gpcs)
            assert geo.nc >= fwd.nc
            if fwd.depth <= reg:
                assert (geo.nc, geo.s) == (fwd.nc, fwd.s)
            assert (geo.rounds > 1) == (w > 1024)
            buffers = 0 if geo.gx else 8 * geo.rows * 3 * geo.s * (
                max(geo.depth, reg) + 4)
            own = (geo.threads * geo.ls * size if geo.rounds == 1
                   else 4 * 2 * geo.rounds * geo.rows * geo.threads)
            assert geo.smem == buffers + 16 + own
            assert geo.gx == (w > 8824)
            assert not geo.gx or (geo.rows == 1 and geo.rounds > 1)
            if geo.rounds > 1:
                assert geo.rows in (1, 2, 4)
    geo = S.chain_geometry(8, 256, dtype, 132, _gpcs, inputs=3, gx=True,
                           carries=2)
    assert geo[:3] == (8, 2, 1) and geo.depth <= reg
    with pytest.raises(ValueError, match="no launch takes W=8825"):
        S.chain_geometry(3, 8825, dtype, 132, _gpcs, inputs=3, carries=2)


def test_gru_fwd_geometry_takes_wide_widths_in_rounds():
    """On a card that runs no 16-block cluster, widths past 64 units of an
    8-block chain (W > 512) take rounds, every weight through L2."""
    for w in (513, 640, 768):
        for dtype in (torch.float32, torch.bfloat16):
            geo = S.chain_geometry(8, w, dtype, 132, _no16)
            assert geo.nc == 8 and geo.rounds == 2 and geo.ls == 0


# ------------------------------------------------ the stack on the scan


def _jax_layers(rng, w_in, h, n_layers):
    layers, d, k = [], w_in, 1.0 / np.sqrt(h)
    for _ in range(n_layers):
        layers.append({
            dn: {"wi": rng.uniform(-k, k, (d, 3 * h)).astype(np.float32),
                 "wh": rng.uniform(-k, k, (h, 3 * h)).astype(np.float32),
                 "bi": rng.uniform(-k, k, (3 * h,)).astype(np.float32),
                 "bh": rng.uniform(-k, k, (3 * h,)).astype(np.float32)}
            for dn in ("fwd", "bwd")})
        d = 2 * h
    return layers


def _spy(monkeypatch):
    """Record which route each layer direction takes: the fused layer
    (never, at these widths) or the GRU scan's saving forward."""
    calls = []
    monkeypatch.setattr(PR, "gru_bidir_layer",
                        lambda *a: calls.append("fused"))
    save = S.gru_scan_fwd_save
    monkeypatch.setattr(S, "gru_scan_fwd_save",
                        lambda *a: calls.append("scan") or save(*a))
    return calls


def _rel(got, want):
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


@pytest.mark.parametrize("h", [12, 20])
def test_gru_apply_outside_the_fused_widths_matches_jax(monkeypatch, xla_scan,
                                                        h):
    """Two layers, inter-layer dropout on with the JAX seed, ragged
    lengths: gru_apply runs the scan (both directions of both layers) and
    matches JAX's gru_apply, forward and every gradient."""
    calls = _spy(monkeypatch)
    rng = np.random.default_rng(h)
    t, b, w_in, n_layers = 24, 3, 16, 2
    layers = _jax_layers(rng, w_in, h, n_layers)
    x = rng.normal(size=(b, t, w_in)).astype(np.float32)
    lengths = np.array([24, 13, 1], np.int32)
    g = rng.normal(size=(b, t, 2 * h)).astype(np.float32)
    key = jax.random.PRNGKey(h)

    def jloss(params, xx):
        out = R.gru_apply(params, xx, jnp.asarray(lengths), h,
                          bidirectional=True, dropout_rate=0.5, train=True,
                          rng=key)
        return jnp.sum(out * g), out

    (_, jout), (jgrads, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, layers), jnp.asarray(x))
    _, sub = jax.random.split(key)
    seeds = [int(jhash.rng_seed_u32(sub))]

    mods = PR.init_rnn(w_in, h, n_layers)
    with torch.no_grad():
        for layer, jl in zip(mods, layers):
            for dn in ("fwd", "bwd"):
                for k, v in jl[dn].items():
                    getattr(layer[dn], k).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = PR.gru_apply(mods, xt, torch.from_numpy(lengths), dropout_rate=0.5,
                       train=True, seeds=seeds)
    (out * torch.from_numpy(g)).sum().backward()
    assert calls == ["scan"] * 4
    assert _rel(out.detach().numpy(), np.asarray(jout)) <= 1e-5
    assert _rel(xt.grad.numpy(), np.asarray(jdx)) <= 1e-5
    for layer, jl in zip(mods, jgrads):
        for dn in ("fwd", "bwd"):
            for k in ("wi", "wh", "bi", "bh"):
                got = getattr(layer[dn], k).grad.numpy()
                assert _rel(got, np.asarray(jl[dn][k])) <= 1e-5, (dn, k)


MODELS = {
    # BiGRU at hidden_dim_1 24 (H=12), two layers; attn at hidden_dim 40
    # (H=20): its one GRU layer after the attention
    "bigru": (jgru.BiGRUConfig, jgru.init, jgru.apply,
              dict(gru_layer=2, hidden_dim_1=24, n_class=7)),
    "attn": (jattn.AttnConfig, jattn.init_attn, jattn.apply_attn,
             dict(hidden_dim=40, n_class=7)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_at_widths_the_fused_layer_refuses_match_jax(monkeypatch,
                                                            xla_scan, name):
    """The models built with ``cfg_overrides`` at such a width (the JAX
    configs with the same fields): train form, the JAX step's dropout
    seeds, log-probs on valid frames and every gradient."""
    calls = _spy(monkeypatch)
    cfg_cls, init, apply, fields = MODELS[name]
    cfg = cfg_cls(**fields)
    params = init(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(2)
    t, b = 24, 3
    lengths = np.array([24, 13, 1], np.int32)
    x = rng.normal(size=(b, t, 400)).astype(np.float32)
    valid = np.arange(t)[None, :] < lengths[:, None]
    cot = rng.normal(size=(b, t, 7)).astype(np.float32) * valid[:, :, None]
    key = jax.random.PRNGKey(3)

    def jf(p):
        out = apply(p, cfg, jnp.asarray(x), jnp.asarray(lengths), train=True,
                    rng=key)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jf, has_aux=True))(params)
    if name == "bigru":  # models/gru.py:37, rnn.py:522
        r_in, r_rnn = jax.random.split(key, 2)
        _, sub = jax.random.split(r_rnn)
        seeds = [int(jhash.rng_seed_u32(r)) for r in (r_in, sub)]
    else:  # the attention site (models/attention.py)
        seeds = [int(jhash.rng_seed_u32(jax.random.split(key, 2)[0]))]
    model = build_model(name, 7, cfg_overrides={
        k: v for k, v in fields.items() if k != "n_class"})
    model.load_state_dict(from_jax_params(name, jax.tree.map(np.asarray,
                                                             params)))
    out = model(torch.from_numpy(x), torch.from_numpy(lengths), train=True,
                seeds=seeds)
    (out * torch.from_numpy(cot)).sum().backward()
    assert calls == ["scan"] * (4 if name == "bigru" else 2)
    assert _rel(out.detach().numpy()[valid], np.asarray(want)[valid]) <= 1e-5
    jgrads = {k: np.asarray(v) for k, v in jckpt._flatten(jgrads).items()}
    for k, p in model.named_parameters():
        assert _rel(p.grad.numpy(), jgrads[k.replace(".", "/")]) <= 1e-5, k
