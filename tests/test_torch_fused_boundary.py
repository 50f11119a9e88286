"""The GRU stack's fused-boundary form (``PVA_RNN_FUSED_BOUNDARY=1``) of the
port's ``ops/rnn_fused.py`` and ``ops/rnn.py`` against the JAX package.

On the CPU the wrappers run their plain versions (the boundary the glue
builds, then the split layer and its backward, then the boundary's VJP),
tied by ``GRUBidirBndLayerFn``.  They are held against
``rnn_fused_pallas.gru_bidir_fused_split_bnd`` in Pallas interpret mode
(one call at the smallest shape), the stack under the flag against JAX's
XLA GRU stack (which JAX pins equal to its own boundary route,
``tests/test_rnn_fused.py::test_fused_boundary_matches_glue``) and against
the port's own glue route bit for bit, and bigru and ctcloss under the
flag against the JAX models.  The CUDA kernels are held against the plain
versions in ``test_torch_cuda_kernels.py``, which runs only with a card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_video_action_tpu.models import ModelDef
from pytorch_video_action_tpu.models import build_model as jbuild
from pytorch_video_action_tpu.models import gru as jgru
from pytorch_video_action_tpu.ops import hashmask as jhash
from pytorch_video_action_tpu.ops import rnn as JR
from pytorch_video_action_tpu.ops import rnn_fused_pallas as F
from pytorch_video_action_tpu.train import checkpoint as jckpt
from pytorch_video_action_tpu_torch.models import build_model
from pytorch_video_action_tpu_torch.models.params import from_jax_params
from pytorch_video_action_tpu_torch.ops import hashmask
from pytorch_video_action_tpu_torch.ops import rnn as R
from pytorch_video_action_tpu_torch.ops import rnn_fused as P

N_CLASS = 7
TOL = 1e-5  # f32, the same products summed in other orders


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _layer(seed, t=16, b=8, h=16):
    """Halves ``xa``, ``xb [T, B, H]``, one layer's per-direction weights at
    W = 2H (numpy), lengths and output gradients."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    shapes = ([(2 * h, 3 * h)] * 2 + [(3 * h,)] * 2 + [(h, 3 * h)] * 2
              + [(3 * h,)] * 2)
    ws = [rng.uniform(-k, k, s).astype(np.float32) for s in shapes]
    xa, xb = (rng.normal(size=(t, b, h)).astype(np.float32)
              for _ in range(2))
    lengths = np.asarray([16, 9, 1, 16, 5, 14, 12, 8][:b], np.int32)
    dys = [rng.normal(size=(t, b, h)).astype(np.float32) for _ in range(2)]
    return xa, xb, ws, lengths, dys


# ------------------------------------------------ (a) the Pallas kernel


def test_plain_versions_match_pallas_interpret():
    """One interpret-mode call of ``gru_bidir_fused_split_bnd`` (T=16, B=8,
    H=16, f32, dropout at keep 0.5): ys and the whole VJP, ``d xa`` and
    ``d xb`` included, against the plain versions through
    ``GRUBidirBndLayerFn``.  1e-5 of the largest element."""
    xa, xb, ws, lengths, dys = _layer(3)
    seed, keep = 0x2468ACE1, 0.5
    ln = jnp.asarray(lengths)

    def jf(*a):
        return F.gru_bidir_fused_split_bnd(
            *a, ln, jnp.uint32(seed), True, jhash.threshold(keep), 1.0 / keep)

    jargs = [jnp.asarray(a) for a in (xa, xb, *ws)]
    (jysf, jysb), vjp = jax.vjp(jf, *jargs)
    want = vjp((jnp.asarray(dys[0]), jnp.asarray(dys[1])))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (xa, xb, *ws)]
    ysf, ysb = P.gru_bidir_bnd_layer(*leaves, torch.from_numpy(lengths),
                                     seed, keep)
    assert _rel_err(ysf.detach().numpy(), jysf) <= TOL
    assert _rel_err(ysb.detach().numpy(), jysb) <= TOL
    got = torch.autograd.grad((ysf, ysb), leaves,
                              [torch.from_numpy(d) for d in dys])
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        assert _rel_err(g.numpy(), w) <= TOL, (i, _rel_err(g.numpy(), w))


# ---------------------------------------- (b) the stack against JAX's


def _stack(seed, w_in, h, n_layers):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    layers, d = [], w_in
    for _ in range(n_layers):
        layers.append({
            dn: {"wi": rng.uniform(-k, k, (d, 3 * h)).astype(np.float32),
                 "wh": rng.uniform(-k, k, (h, 3 * h)).astype(np.float32),
                 "bi": rng.uniform(-k, k, (3 * h,)).astype(np.float32),
                 "bh": rng.uniform(-k, k, (3 * h,)).astype(np.float32)}
            for dn in ("fwd", "bwd")})
        d = 2 * h
    return layers


def _port_stack(layers, x, lengths, cot, rate, train, seeds):
    """The port's gru_apply on the JAX weights: ``(out, x grad, {(layer,
    direction, name): grad})``."""
    mods = R.init_rnn(x.shape[-1], layers[0]["fwd"]["wh"].shape[0],
                      len(layers))
    with torch.no_grad():
        for layer, jl in zip(mods, layers):
            for dn in ("fwd", "bwd"):
                for k, v in jl[dn].items():
                    getattr(layer[dn], k).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = R.gru_apply(mods, xt, torch.from_numpy(lengths), dropout_rate=rate,
                      train=train, seeds=seeds)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = {(i, dn, k): getattr(layer[dn], k).grad
             for i, layer in enumerate(mods) for dn in ("fwd", "bwd")
             for k in ("wi", "wh", "bi", "bh")}
    return out.detach(), xt.grad, grads


def _stack_case(rate):
    rng = np.random.default_rng(17)
    t, b, w_in, h, n_layers = 24, 4, 20, 16, 4
    layers = _stack(5, w_in, h, n_layers)
    x = rng.normal(size=(b, t, w_in)).astype(np.float32)
    lengths = np.array([24, 13, 1, 7], np.int32)
    cot = rng.normal(size=(b, t, 2 * h)).astype(np.float32)
    key = jax.random.PRNGKey(int(rate * 10))
    seeds, r = [], key
    for _ in range(n_layers - 1):
        r, sub = jax.random.split(r)
        seeds.append(int(jhash.rng_seed_u32(sub)))
    return layers, x, lengths, cot, key, seeds


@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_stack_under_the_flag_matches_jax(monkeypatch, rate):
    """A 4-layer stack at H=16, T=24, ragged lengths, dropout on with the
    JAX seeds: the port's gru_apply with ``FUSED_BOUNDARY`` against
    ``jax.grad`` of JAX's XLA stack, forward and every gradient, 1e-5."""
    layers, x, lengths, cot, key, seeds = _stack_case(rate)
    h = layers[0]["fwd"]["wh"].shape[0]

    def jloss(params, xx):
        out = JR.gru_apply(params, xx, jnp.asarray(lengths), h,
                           bidirectional=True, dropout_rate=rate, train=True,
                           rng=key)
        return jnp.sum(out * cot), out

    monkeypatch.setattr(JR, "USE_PALLAS", False)
    (_, jout), (jgrads, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, layers), jnp.asarray(x))
    monkeypatch.setattr(P, "FUSED_BOUNDARY", True)
    out, dx, grads = _port_stack(layers, x, lengths, cot, rate, True, seeds)
    assert _rel_err(out.numpy(), jout) <= TOL
    assert _rel_err(dx.numpy(), jdx) <= TOL
    for (i, dn, k), g in grads.items():
        assert _rel_err(g.numpy(), jgrads[i][dn][k]) <= TOL, (i, dn, k)


@pytest.mark.parametrize("rate,train", [(0.5, True), (0.3, True),
                                        (0.5, False)])
def test_flag_never_changes_values(monkeypatch, rate, train):
    """The stack with the flag on against the flag off, same weights,
    batch and seeds: the output and every gradient bit for bit (the
    boundary and its VJP take the glue's rounding steps)."""
    layers, x, lengths, cot, _, seeds = _stack_case(rate)
    runs = {}
    for flag in (True, False):
        monkeypatch.setattr(P, "FUSED_BOUNDARY", flag)
        runs[flag] = _port_stack(layers, x, lengths, cot, rate, train, seeds)
    on, off = runs[True], runs[False]
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    for k, g in off[2].items():
        assert torch.equal(on[2][k], g), k


def test_flag_picks_the_layer_body(monkeypatch):
    """Under ``FUSED_BOUNDARY`` with the split body the GRU stack runs
    layer 0 on the split layer and the others on the boundary form; with
    the merged body, with one layer or for the LSTM, the flag changes
    nothing (CPU calls counted by a wrapper around each)."""
    calls = []
    for name in ("gru_bidir_layer", "gru_bidir_bnd_layer",
                 "gru_merged_layer", "lstm_bidir_layer"):
        def counted(*a, _f=getattr(R, name), _n=name):
            calls.append(_n)
            return _f(*a)
        monkeypatch.setattr(R, name, counted)
    monkeypatch.setattr(P, "FUSED_BOUNDARY", True)
    x = torch.randn(2, 6, 8)
    lengths = torch.tensor([6, 3], dtype=torch.int32)
    R.gru_apply(R.init_rnn(8, 16, 3), x, lengths)
    R.gru_apply(R.init_rnn(8, 16, 1), x, lengths)
    R.lstm_apply(R.init_rnn(8, 16, 2, n_gates=4), x, lengths)
    monkeypatch.setattr(P, "SPLIT", False)
    R.gru_apply(R.init_rnn(8, 16, 2), x, lengths)
    assert calls == (["gru_bidir_layer"] + ["gru_bidir_bnd_layer"] * 2
                     + ["gru_bidir_layer"] + ["lstm_bidir_layer"] * 2
                     + ["gru_merged_layer"] * 2)


# ------------------------------------------------------ (c) the models


def _models(name):
    """The JAX ModelDef and the port model; ctcloss at 2 x 16."""
    if name == "bigru":
        return jbuild(name, N_CLASS), build_model(name, N_CLASS)
    narrow = dict(gru_layer=2, hidden_dim_1=32)
    cfg = jgru.BiGRUConfig(n_class=N_CLASS + 1, **narrow)
    mdef = ModelDef(name, cfg, lambda rng: jgru.init(rng, cfg),
                    lambda p, x, l, **kw: jgru.apply(p, cfg, x, l, **kw),
                    "log_probs")
    return mdef, build_model(name, N_CLASS, cfg_overrides=narrow)


@pytest.mark.parametrize("name,n_layers", [("bigru", 4), ("ctcloss", 2)])
def test_models_under_the_flag_match_jax(monkeypatch, name, n_layers):
    """The train forward (dropout on, the JAX seeds: input dropout, then
    one a boundary) and every parameter's gradient under
    ``FUSED_BOUNDARY`` against ``jax.grad`` of the JAX model on its XLA
    path, 1e-5 of the largest element."""
    monkeypatch.setattr(P, "FUSED_BOUNDARY", True)
    mdef, model = _models(name)
    params = mdef.init(jax.random.PRNGKey(1))
    model.load_state_dict(from_jax_params(name, jax.tree.map(np.asarray,
                                                             params)))
    rng = np.random.default_rng(2)
    t = 20
    lengths = np.array([t, t // 2 + 1, 1], np.int32)
    x = rng.normal(size=(3, t, 400)).astype(np.float32)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    cot = rng.normal(size=(3, t, N_CLASS + (name == "ctcloss"))).astype(
        np.float32)
    key = jax.random.PRNGKey(4)

    def jf(p):
        out = mdef.apply(p, jnp.asarray(x), jnp.asarray(lengths), train=True,
                         rng=key)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jf, has_aux=True))(params)
    keys = jax.random.split(key, 2)
    seeds, r = [int(jhash.rng_seed_u32(keys[0]))], keys[1]
    for _ in range(n_layers - 1):
        r, sub = jax.random.split(r)
        seeds.append(int(jhash.rng_seed_u32(sub)))
    out = model(torch.from_numpy(x), torch.from_numpy(lengths), train=True,
                seeds=seeds)
    (out * torch.from_numpy(cot)).sum().backward()
    valid = np.arange(t)[None, :] < lengths[:, None]
    assert _rel_err(out.detach().numpy()[valid],
                    np.asarray(want)[valid]) <= TOL
    flat = {k: np.asarray(v) for k, v in jckpt._flatten(jgrads).items()}
    for k, p in model.named_parameters():
        assert _rel_err(p.grad.numpy(), flat[k.replace(".", "/")]) <= TOL, k


# ------------------------------------------------------ (d) the wrappers


def _torch_layer(device="cpu", requires_grad=False, dtype=torch.float32):
    xa, xb, ws, lengths, dys = _layer(9, t=10, b=3, h=16)
    ts = [torch.from_numpy(a).to(device, dtype).requires_grad_(requires_grad)
          for a in (xa, xb, *ws)]
    return ts, torch.from_numpy(lengths).to(device), [
        torch.from_numpy(d).to(device, dtype) for d in dys]


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers return the plain versions' values and
    count no launch; the plain backward is the glue's VJP of row 2's."""
    (xa, xb, *ws), lengths, dys = _torch_layer()
    seed, keep = 77, 0.7
    counts = (P.gru_bidir_bnd_fwd.launches, P.gru_bidir_bnd_fwd.train_launches,
              P.gru_bidir_bnd_bwd.launches)
    fwd = P.gru_bidir_bnd_fwd(xa, xb, *ws, lengths, seed, keep, train=True)
    for g, w in zip(fwd, P.gru_bidir_bnd_layer_ref(xa, xb, *ws, lengths,
                                                   seed, keep, train=True)):
        assert torch.equal(g, w)
    wif, wib, _, _, whf, whb, _, _ = ws
    got = P.gru_bidir_bnd_bwd(xa, xb, wif, wib, whf, whb, lengths, *fwd, *dys,
                              seed, keep)
    # the glue: autograd of the boundary into row 2's dx
    leaves = [xa.clone().requires_grad_(True), xb.clone().requires_grad_(True)]
    x = P.boundary_input(*leaves, P.time_mask(lengths, 10, xa.dtype), seed,
                         keep)
    dx = P.gru_bidir_layer_bwd_ref(x.detach(), wif, wib, whf, whb, lengths,
                                   *fwd, *dys)[0]
    want = torch.autograd.grad(x, leaves, dx)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (P.gru_bidir_bnd_fwd.launches, P.gru_bidir_bnd_fwd.train_launches,
            P.gru_bidir_bnd_bwd.launches) == counts


def test_boundary_scale_rounds_to_the_dtype():
    """In bf16 the boundary's dropout scale is bf16's 1/0.7, as the glue's
    ``hash_dropout`` rounds it (and the kernels receive it)."""
    (xa, xb, *_), lengths, _ = _torch_layer(dtype=torch.bfloat16)
    mask_tb = P.time_mask(lengths, 10, xa.dtype)
    x = P.boundary_input(xa, xb, mask_tb, 5, 0.7)
    h2 = x.shape[-1]
    cat = torch.cat([xa, xb], dim=-1) * mask_tb
    assert torch.equal(x, hashmask.hash_dropout(5, cat, 0.7,
                                                strides=(h2, 10 * h2, 1)))
    assert P._dropout_args(5, 0.7, torch.bfloat16)[2] == 1.4296875
    assert P._dropout_args(None, 0.7, torch.bfloat16)[3] == 0


def test_wrappers_raise_on_device_without_kernel():
    (xa, xb, *ws), lengths, _ = _torch_layer("meta", requires_grad=True)
    with pytest.raises(ValueError, match="no kernel"):
        P.gru_bidir_bnd_layer(xa, xb, *ws, lengths, 3, 0.5)
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
        P.gru_bidir_bnd_layer(xa, xb, *ws, lengths)
    ys = torch.empty(10, 3, 16, device="meta")
    res = torch.empty(10, 3, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        P.gru_bidir_bnd_bwd(xa, xb, ws[0], ws[1], ws[4], ws[5], lengths, ys,
                            ys, res, res, ys, ys)


@pytest.mark.parametrize("case", ["dtype", "halves", "width", "hidden"])
def test_boundary_checks_raise(case):
    """What the kernels refuse, checked before a launch."""
    (xa, xb, *ws), lengths, _ = _torch_layer()
    if case == "dtype":
        xa, xb = xa.double(), xb.double()
    elif case == "halves":
        xb = xb[:, :, :8].contiguous()
    elif case == "width":  # wi is [2H, 3H]; halves of 12 give W = 24
        xa, xb = xa[..., :12].contiguous(), xb[..., :12].contiguous()
    elif case == "hidden":  # H = 12: no kernel template
        ws = [torch.zeros(32, 36), torch.zeros(32, 36), torch.zeros(36),
              torch.zeros(36), torch.zeros(12, 36), torch.zeros(12, 36),
              torch.zeros(36), torch.zeros(36)]
    with pytest.raises((TypeError, ValueError)):
        P._check((xa, xb), tuple(ws), lengths, "gru_bidir_bnd_fwd")
