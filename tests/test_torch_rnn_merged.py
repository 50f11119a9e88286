"""The merged-body bidirectional layers (``PVA_RNN_SPLIT=0``) of the port's
``ops/rnn_fused.py`` and ``ops/rnn.py`` against the JAX package.

On the CPU the wrappers run their plain versions, tied to their backwards
by ``GRUMergedLayerFn`` and ``LSTMMergedLayerFn``.  They are held against
``rnn_fused_pallas.gru_bidir_fused`` and ``lstm_bidir_fused`` in Pallas
interpret mode (one call each at the smallest shape), the stacks under
``SPLIT = False`` against the JAX models on their XLA path and against the
port's own split route, and the packing helpers against JAX's.  The CUDA
kernels are held against the plain versions in
``test_torch_cuda_kernels.py``, which runs only with a card.
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
from pytorch_video_action_tpu_torch.ops import rnn as R
from pytorch_video_action_tpu_torch.ops import rnn_fused as P

N_CLASS = 7


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _layer(seed, cell, t=16, b=8, h=16, w=16):
    """Per-direction weights (numpy), their JAX packing, x, lengths, dys."""
    g = 4 if cell == "lstm" else 3
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    wif, wib = (rng.uniform(-k, k, (w, g * h)).astype(np.float32)
                for _ in range(2))
    whf, whb = (rng.uniform(-k, k, (h, g * h)).astype(np.float32)
                for _ in range(2))
    bif, bib, bhf, bhb = (rng.uniform(-k, k, (g * h,)).astype(np.float32)
                          for _ in range(4))
    if cell == "lstm":
        bif, bib = bif + bhf, bib + bhb
    pack = {"wh2": JR._pack_gate_grouped([jnp.asarray(whf),
                                          jnp.asarray(whb)], h, g),
            "bi2": JR._pack_gate_grouped_vec([jnp.asarray(bif),
                                              jnp.asarray(bib)], h, g),
            "bh2": JR._pack_gate_grouped_vec([jnp.asarray(bhf),
                                              jnp.asarray(bhb)], h, g)}
    x = rng.normal(size=(t, b, w)).astype(np.float32)
    lengths = np.asarray([16, 9, 1, 16, 5, 14, 12, 8][:b], np.int32)
    dys = [rng.normal(size=(t, b, h)).astype(np.float32) for _ in range(2)]
    args = [x, wif, wib, np.asarray(pack["bi2"]), np.asarray(pack["wh2"])]
    if cell == "gru":
        args.append(np.asarray(pack["bh2"]))
    return args, lengths, dys


# ------------------------------------------------ (a) the Pallas kernels


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_plain_versions_match_pallas_interpret(cell):
    """One interpret-mode call of each TPU kernel (T=16, B=8, H=16, W=16,
    f32): the train form's ys and kernel-order residuals (and the LSTM's
    cs), and the whole VJP, dwh2's off-diagonal blocks included.  f32, the
    same products summed in another order: 1e-5 of the largest element."""
    args, lengths, dys = _layer(3, cell)
    ln = jnp.asarray(lengths)
    jargs = [jnp.asarray(a) for a in args]
    if cell == "gru":
        jfwd = F._fwd_call(*jargs, ln, train=True, interpret=True)
        kernel = F.gru_bidir_fused
        fwd, layer = P.gru_merged_layer_ref, P.gru_merged_layer
    else:
        jfwd = F._lstm_fwd_call(*jargs, ln, train=True, interpret=True)
        kernel = F.lstm_bidir_fused
        fwd, layer = P.lstm_merged_layer_ref, P.lstm_merged_layer
    _, vjp = jax.vjp(lambda *a: kernel(*a, ln, True), *jargs)
    want = vjp((jnp.asarray(dys[0]), jnp.asarray(dys[1])))
    targs = [torch.from_numpy(np.array(a)) for a in args]
    lt = torch.from_numpy(lengths)
    got_fwd = fwd(*targs, lt, train=True)
    assert len(got_fwd) == len(jfwd)
    for g, w in zip(got_fwd, jfwd):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel_err(g.numpy(), w) <= 1e-5
    leaves = [a.clone().requires_grad_(True) for a in targs]
    ysf, ysb = layer(*leaves, lt)
    got = torch.autograd.grad((ysf, ysb), leaves,
                              [torch.from_numpy(d) for d in dys])
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        assert _rel_err(g.numpy(), w) <= 1e-5, (i, _rel_err(g.numpy(), w))


# ----------------------------------------- (b) the models against JAX


def _jax_seeds(name, key, n_layers):
    """The dropout seeds of one JAX forward from ``key``: the GRU models
    split it into input and RNN keys, the LSTM into input, RNN and mid
    keys, attn into attention and RNN keys; the RNN key is split once an
    inter-layer site."""
    if name == "attn":
        return [int(jhash.rng_seed_u32(jax.random.split(key, 2)[0]))]
    keys = jax.random.split(key, 3 if name == "bilstm" else 2)
    seeds = [int(jhash.rng_seed_u32(keys[0]))]
    r_rnn = keys[1]
    for _ in range(n_layers - 1):
        r_rnn, sub = jax.random.split(r_rnn)
        seeds.append(int(jhash.rng_seed_u32(sub)))
    if name == "bilstm":
        seeds.append(int(jhash.rng_seed_u32(keys[2])))
    return seeds


def _batch(seed, b=3, t=20):
    rng = np.random.default_rng(seed)
    lengths = np.array([t, t // 2 + 1, 1][:b], np.int32)
    x = rng.normal(size=(b, t, 400)).astype(np.float32)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    return x, lengths


def _port_step(model, x, lengths, seeds, cot):
    """The port model's train forward and the gradients of ``sum(out *
    cot)``: ``(out, {jax name: gradient})``."""
    model.zero_grad()
    out = model(torch.from_numpy(x), torch.from_numpy(lengths), train=True,
                seeds=seeds)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), {k.replace(".", "/"): p.grad.numpy()
                                  for k, p in model.named_parameters()}


# (model, its recurrent layers): BiGRU 4 x 128, BiLSTM 2 x 128, attn's one
# GRU layer 2 x 128 at their defaults; ctcloss, the BiGRU with n_class + 1
# outputs, at 2 x 16 (its default width is bigru's, run above)
MODELS = [("bigru", 4), ("bilstm", 2), ("attn", 1), ("ctcloss", 2)]
CTC_NARROW = dict(gru_layer=2, hidden_dim_1=32)


def _models(name):
    """The JAX ModelDef and the port model (its weights still to set)."""
    if name != "ctcloss":
        return jbuild(name, N_CLASS), build_model(name, N_CLASS)
    cfg = jgru.BiGRUConfig(n_class=N_CLASS + 1, **CTC_NARROW)
    mdef = ModelDef(name, cfg, lambda rng: jgru.init(rng, cfg),
                    lambda p, x, l, **kw: jgru.apply(p, cfg, x, l, **kw),
                    "log_probs")
    return mdef, build_model(name, N_CLASS, cfg_overrides=CTC_NARROW)


@pytest.mark.parametrize("name,n_layers", MODELS)
def test_merged_route_matches_jax_models(monkeypatch, name, n_layers):
    """The train forward (dropout on, the JAX seeds handed over, ragged
    lengths) and every parameter's gradient of the port under ``SPLIT =
    False`` against ``jax.grad`` of the JAX model on its XLA path.  f32:
    1e-5 of the largest element."""
    monkeypatch.setattr(P, "SPLIT", False)
    mdef, model = _models(name)
    params = mdef.init(jax.random.PRNGKey(1))
    model.load_state_dict(from_jax_params(name, jax.tree.map(np.asarray,
                                                             params)))
    x, lengths = _batch(2)
    key = jax.random.PRNGKey(4)
    cot = np.random.default_rng(5).normal(
        size=(3, 20, N_CLASS + (name == "ctcloss"))).astype(np.float32)

    def jf(p):
        out = mdef.apply(p, jnp.asarray(x), jnp.asarray(lengths), train=True,
                         rng=key)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jf, has_aux=True))(params)
    got, grads = _port_step(model, x, lengths,
                            _jax_seeds(name, key, n_layers), cot)
    valid = np.arange(20)[None, :] < lengths[:, None]
    assert _rel_err(got[valid], np.asarray(want)[valid]) <= 1e-5
    flat = {k: np.asarray(v) for k, v in jckpt._flatten(jgrads).items()}
    assert grads.keys() == flat.keys()
    for k, w in flat.items():
        assert _rel_err(grads[k], w) <= 1e-5, (k, _rel_err(grads[k], w))


# ----------------------------------------------- (c) the flag and values


@pytest.mark.parametrize("name,n_layers", MODELS[:2])
def test_flag_never_changes_values(monkeypatch, name, n_layers):
    """The port's train forward and every gradient under ``SPLIT = False``
    against ``SPLIT = True``, same weights, batch and seeds, f32: within
    1e-6 of the largest element (the merged body sums its hidden product
    over 2H rows, half of them zeros, the split one over H)."""
    model = build_model(name, N_CLASS,
                        generator=torch.Generator().manual_seed(3))
    x, lengths = _batch(6)
    cot = np.random.default_rng(7).normal(size=(3, 20, N_CLASS)).astype(
        np.float32)
    seeds = list(range(31, 31 + model.n_dropout_sites))
    out = {}
    for split in (True, False):
        monkeypatch.setattr(P, "SPLIT", split)
        out[split] = _port_step(model, x, lengths, seeds, cot)
    assert _rel_err(out[False][0], out[True][0]) <= 1e-6
    for k, w in out[True][1].items():
        assert _rel_err(out[False][1][k], w) <= 1e-6, k


def test_flag_picks_the_layer_body(monkeypatch):
    """Under ``SPLIT = False`` the stack runs the merged wrappers and none
    of the split ones (CPU calls counted by a wrapper around each)."""
    calls = []
    for name in ("gru_bidir_layer", "gru_merged_layer", "lstm_bidir_layer",
                 "lstm_merged_layer"):
        def counted(*a, _f=getattr(R, name), _n=name):
            calls.append(_n)
            return _f(*a)
        monkeypatch.setattr(R, name, counted)
    x = torch.randn(2, 6, 8)
    lengths = torch.tensor([6, 3], dtype=torch.int32)
    for split in (True, False):
        monkeypatch.setattr(P, "SPLIT", split)
        R.gru_apply(R.init_rnn(8, 16, 2), x, lengths)
        R.lstm_apply(R.init_rnn(8, 16, 1, n_gates=4), x, lengths)
    assert calls == ["gru_bidir_layer"] * 2 + ["lstm_bidir_layer"] + \
        ["gru_merged_layer"] * 2 + ["lstm_merged_layer"]


# ------------------------------------------------ (d) the packing helpers


@pytest.mark.parametrize("n_gates", [3, 4])
def test_packing_matches_jax_and_its_vjp_keeps_the_diagonal(n_gates):
    h = 8
    rng = np.random.default_rng(n_gates)
    mats = [rng.normal(size=(h, n_gates * h)).astype(np.float32)
            for _ in range(2)]
    vecs = [rng.normal(size=(n_gates * h,)).astype(np.float32)
            for _ in range(2)]
    want = np.asarray(JR._pack_gate_grouped([jnp.asarray(m) for m in mats],
                                            h, n_gates))
    want_vec = np.asarray(JR._pack_gate_grouped_vec(
        [jnp.asarray(v) for v in vecs], h, n_gates))
    tm = [torch.from_numpy(m).requires_grad_(True) for m in mats]
    tv = [torch.from_numpy(v).requires_grad_(True) for v in vecs]
    wh2 = R._pack_gate_grouped(tm, h, n_gates)
    b2 = R._pack_gate_grouped_vec(tv, h, n_gates)
    assert np.array_equal(wh2.detach().numpy(), want)
    assert np.array_equal(b2.detach().numpy(), want_vec)
    # the VJP of a dense cotangent: each direction gets its diagonal blocks
    cot = torch.from_numpy(rng.normal(size=want.shape).astype(np.float32))
    cot_vec = torch.from_numpy(rng.normal(size=want_vec.shape).astype(
        np.float32))
    gm = torch.autograd.grad(wh2, tm, cot)
    gv = torch.autograd.grad(b2, tv, cot_vec)
    for d in range(2):
        rows = cot[d * h:(d + 1) * h]
        assert torch.equal(gm[d], P._dense(rows, h, n_gates, d))
        assert torch.equal(gv[d], P._dense(cot_vec, h, n_gates, d))
    # and agrees with JAX's VJP of its packing
    _, jvjp = jax.vjp(lambda a, b: JR._pack_gate_grouped([a, b], h, n_gates),
                      *(jnp.asarray(m) for m in mats))
    for g, w in zip(gm, jvjp(jnp.asarray(cot.numpy()))):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_pack_bidir_folds_the_lstm_biases():
    layer = R.init_rnn(4, 8, 1, n_gates=4)[0]
    f, b = layer["fwd"], layer["bwd"]
    b2, wh2, bh2 = R._pack_bidir("lstm", f, b, 8, 4)
    assert torch.equal(b2, R._pack_gate_grouped_vec([f.bi + f.bh,
                                                     b.bi + b.bh], 8, 4))
    assert wh2.shape == (16, 64) and bh2 is None
    f, b = R.init_rnn(4, 8, 1)[0].values()
    b2, _, bh2 = R._pack_bidir("gru", f, b, 8, 3)
    assert torch.equal(b2, R._pack_gate_grouped_vec([f.bi, b.bi], 8, 3))
    assert torch.equal(bh2, R._pack_gate_grouped_vec([f.bh, b.bh], 8, 3))


# ------------------------------------------------------- (e) the wrappers


def _merged_args(cell, device="cpu", requires_grad=False):
    args, lengths, dys = _layer(9, cell, t=10, b=3, h=16, w=6)
    ts = [torch.from_numpy(np.array(a)).to(device).requires_grad_(
          requires_grad)
          for a in args]
    return ts, torch.from_numpy(lengths).to(device), dys


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_wrappers_take_the_plain_version_on_cpu(cell):
    args, lengths, dys = _merged_args(cell)
    fwd = P.gru_merged_fwd if cell == "gru" else P.lstm_merged_fwd
    ref = P.gru_merged_layer_ref if cell == "gru" else P.lstm_merged_layer_ref
    bwd = P.gru_merged_bwd if cell == "gru" else P.lstm_merged_bwd
    bref = (P.gru_merged_layer_bwd_ref if cell == "gru"
            else P.lstm_merged_layer_bwd_ref)
    counts = (fwd.launches, fwd.train_launches, bwd.launches)
    for g, w in zip(fwd(*args, lengths, train=True),
                    ref(*args, lengths, train=True)):
        assert torch.equal(g, w)
    out = fwd(*args, lengths, train=True)
    hp2 = P._prev_kernel_order(out[0], out[1])
    dyt = [torch.from_numpy(d) for d in dys]
    x, wif2, wib2, _, wh2 = args[:5]
    if cell == "gru":
        bargs = (x, out[2], hp2, *dyt, wif2, wib2, wh2, lengths)
    else:
        cp2 = torch.cat([torch.zeros_like(out[2][:1]), out[2][:-1]])
        bargs = (x, out[3], hp2, cp2, *dyt, wif2, wib2, wh2, lengths)
    for g, w in zip(bwd(*bargs), bref(*bargs)):
        assert torch.equal(g, w)
    # the counts are of kernel launches: a CPU call adds none
    assert (fwd.launches, fwd.train_launches, bwd.launches) == counts


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_wrappers_raise_on_device_without_kernel(cell):
    args, lengths, _ = _merged_args(cell, device="meta", requires_grad=True)
    layer = P.gru_merged_layer if cell == "gru" else P.lstm_merged_layer
    with pytest.raises(ValueError, match="no kernel"):
        layer(*args, lengths)
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
        layer(*args, lengths)
    x, _, _, _, wh2 = (a.detach() for a in args[:5])
    t, b, h = 10, 3, 16
    ys = torch.empty(t, b, h, device="meta")
    st = torch.empty(t, b, 2 * h, device="meta")
    if cell == "gru":
        res = torch.empty(t, b, 8 * h, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            P.gru_merged_bwd(x, res, st, ys, ys, args[1], args[2], wh2,
                             lengths)
    else:
        res = torch.empty(t, b, 10 * h, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            P.lstm_merged_bwd(x, res, st, st, ys, ys, args[1], args[2], wh2,
                              lengths)


@pytest.mark.parametrize("case", ["dtype", "res_shape", "lengths", "hidden",
                                  "wh2_rows"])
def test_merged_checks_raise(case):
    """What the kernels refuse, checked before a launch."""
    args, lengths, dys = _merged_args("gru")
    x, wif2, wib2, bi2, wh2, bh2 = args
    res = torch.zeros(10, 3, 128)
    if case == "dtype":
        x = x.double()
    elif case == "res_shape":
        res = res[..., :-1]
    elif case == "lengths":
        lengths = lengths.long()
    elif case == "hidden":  # H = 12: no kernel template
        wh2 = torch.zeros(24, 72)
    elif case == "wh2_rows":
        wh2 = torch.zeros(31, 96)
    with pytest.raises((TypeError, ValueError)):
        t_len, b, w_in, h = P._merged_dims("gru_merged_bwd", x, wh2)
        P._check_tensors("gru_merged_bwd", x.dtype, P._merged_expect(
            t_len, b, w_in, h, 3, "x", "res", "wif2", "wib2", "bi2", "wh2",
            "bh2", "lengths"), (x, res, wif2, wib2, bi2, wh2, bh2, lengths))
