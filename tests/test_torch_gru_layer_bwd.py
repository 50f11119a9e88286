"""The train form and the backward of the port's bidirectional GRU layer
(``pytorch_video_action_tpu_torch/ops/rnn_fused.py``) against autograd and
the JAX package.

On the CPU the wrappers run the plain versions: the train-form forward and
``gru_bidir_layer_bwd_ref``, tied by ``GRUBidirLayerFn``.  They are held
against float64 autograd through the plain forward, against ``jax.vjp`` of
``rnn_fused_pallas.gru_bidir_fused_split`` in Pallas interpret mode (one
call), and, for a whole stack with dropout, against ``jax.grad`` of the
JAX XLA path.  The CUDA kernels themselves are held against the plain
versions in ``test_torch_cuda_kernels.py``, which runs only with a card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_video_action_tpu.ops import hashmask as jhash
from pytorch_video_action_tpu.ops import rnn as R
from pytorch_video_action_tpu.ops import rnn_fused_pallas as F
from pytorch_video_action_tpu_torch.ops import rnn_fused as P
from pytorch_video_action_tpu_torch.ops.rnn import gru_apply, init_rnn

GRADS = ["dx", "dwif", "dwib", "dbif", "dbib", "dwhf", "dwhb", "dbhf", "dbhb"]


def _inputs(seed, t, b, h, w, lengths):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    shapes = [(w, 3 * h)] * 2 + [(3 * h,)] * 2 + [(h, 3 * h)] * 2 + [(3 * h,)] * 2
    ws = [rng.uniform(-k, k, s).astype(np.float32) for s in shapes]
    x = rng.normal(size=(t, b, w)).astype(np.float32)
    # dy is non-zero on padded frames too: the unmasked contract
    dys = [rng.normal(size=(t, b, h)).astype(np.float32) for _ in range(2)]
    return x, ws, np.asarray(lengths, np.int32), dys


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _bwd_args(x, ws, lengths, fwd, dys):
    wif, wib, _, _, whf, whb, _, _ = ws
    return (x, wif, wib, whf, whb, lengths, *fwd, *dys)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def test_train_form_ys_equal_eval_form_and_residuals_recompute():
    x, ws, lengths, _ = _inputs(0, t=20, b=4, h=16, w=12,
                                lengths=[20, 9, 1, 14])
    args = _torch([x, *ws], torch.float32) + [torch.from_numpy(lengths)]
    ysf, ysb = P.gru_bidir_layer_ref(*args)
    tf, tb, resf, resb = P.gru_bidir_layer_ref(*args, train=True)
    assert torch.equal(tf, ysf) and torch.equal(tb, ysb)
    # recompute r, z, n, hg_n from x, the weights and the previous state
    # read from ys, as the backward does; f32, products summed in another
    # order than the step loop, so 1e-6
    xt, wif, wib, bif, bib, whf, whb, bhf, bhb = args[:9]
    h = whf.shape[0]
    zero = torch.zeros_like(ysf[:1])
    for ys_prev, wi, bi, wh, bh, res in (
            (torch.cat([zero, ysf[:-1]]), wif, bif, whf, bhf, resf),
            (torch.cat([ysb[1:], zero]), wib, bib, whb, bhb, resb)):
        gx = xt @ wi + bi
        hg = ys_prev @ wh + bh
        r = torch.sigmoid(gx[..., :h] + hg[..., :h])
        z = torch.sigmoid(gx[..., h:2 * h] + hg[..., h:2 * h])
        n = torch.tanh(gx[..., 2 * h:] + r * hg[..., 2 * h:])
        want = torch.cat([r, z, n, hg[..., 2 * h:]], dim=-1)
        assert res.shape == want.shape and res.dtype == torch.float32
        assert (res - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("h,lengths", [(16, [11, 1, 6, 11, 3]),
                                       (32, [1, 11, 11, 7, 2])])
def test_plain_bwd_matches_float64_autograd(h, lengths):
    x, ws, lengths, dys = _inputs(h, t=11, b=5, h=h, w=7, lengths=lengths)
    args = _torch([x, *ws], torch.float64)
    for a in args:
        a.requires_grad_(True)
    lengths = torch.from_numpy(lengths)
    dys = _torch(dys, torch.float64)
    ys = P.gru_bidir_layer_ref(*args, lengths)
    want = torch.autograd.grad(ys, args, dys)
    with torch.no_grad():
        fwd = P.gru_bidir_layer_ref(*args, lengths, train=True)
        got = P.gru_bidir_layer_bwd_ref(
            *_bwd_args(args[0], args[1:], lengths, fwd, dys))
    # float64, the same sums in another order
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        assert _rel_err(g, w) <= 1e-12, name


def test_plain_bwd_matches_pallas_vjp_interpret():
    """One interpret-mode call (T=32, B=8, H=128, W=16, f32) pins the VJP
    of the Pallas kernels themselves."""
    x, ws, lengths, dys = _inputs(3, t=32, b=8, h=128, w=16,
                                  lengths=[32, 17, 1, 32, 5, 29, 12, 8])
    ln = jnp.asarray(lengths)
    (jf, jb), vjp = jax.vjp(
        lambda *a: F.gru_bidir_fused_split(*a, ln, True),
        jnp.asarray(x), *(jnp.asarray(w) for w in ws))
    want = vjp((jnp.asarray(dys[0]), jnp.asarray(dys[1])))
    xt, *wt = _torch([x, *ws], torch.float32)
    lt = torch.from_numpy(lengths)
    fwd = P.gru_bidir_layer_ref(xt, *wt, lt, train=True)
    np.testing.assert_allclose(fwd[0].numpy(), np.asarray(jf), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(fwd[1].numpy(), np.asarray(jb), atol=1e-5,
                               rtol=0)
    got = P.gru_bidir_layer_bwd_ref(
        *_bwd_args(xt, wt, lt, fwd, _torch(dys, torch.float32)))
    # f32: the same products summed in another order, over up to T*B = 256
    # frames, relative to the largest gradient element
    for name, g, w in zip(GRADS, got, want):
        assert g.shape == w.shape, name
        assert _rel_err(g.numpy(), w) <= 1e-5, (name, _rel_err(g.numpy(), w))


def _jax_layers(rng, w_in, h, n_layers):
    layers = []
    d = w_in
    k = 1.0 / np.sqrt(h)
    for _ in range(n_layers):
        layers.append({
            dn: {"wi": rng.uniform(-k, k, (d, 3 * h)).astype(np.float32),
                 "wh": rng.uniform(-k, k, (h, 3 * h)).astype(np.float32),
                 "bi": rng.uniform(-k, k, (3 * h,)).astype(np.float32),
                 "bh": rng.uniform(-k, k, (3 * h,)).astype(np.float32)}
            for dn in ("fwd", "bwd")})
        d = 2 * h
    return layers


def test_stack_grads_match_jax_xla_path():
    """Three layers with inter-layer dropout on and ragged lengths: the
    port's gru_apply (plain layer on the CPU, autograd through the stack
    glue) against jax.grad of the JAX XLA path, with the JAX dropout
    seeds handed over."""
    rng = np.random.default_rng(7)
    t, b, w_in, h, n_layers = 20, 4, 24, 16, 3
    layers = _jax_layers(rng, w_in, h, n_layers)
    x = rng.normal(size=(b, t, w_in)).astype(np.float32)
    lengths = np.array([20, 13, 1, 7], np.int32)
    g = rng.normal(size=(b, t, 2 * h)).astype(np.float32)
    key = jax.random.PRNGKey(11)

    def jloss(params, xx):
        out = R.gru_apply(params, xx, jnp.asarray(lengths), h,
                          bidirectional=True, dropout_rate=0.5, train=True,
                          rng=key)
        return jnp.sum(out * g)

    orig = R.USE_PALLAS
    R.USE_PALLAS = False
    try:
        jgrads, jdx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            jax.tree.map(jnp.asarray, layers), jnp.asarray(x))
    finally:
        R.USE_PALLAS = orig
    seeds, r = [], key
    for _ in range(n_layers - 1):
        r, sub = jax.random.split(r)
        seeds.append(int(jhash.rng_seed_u32(sub)))

    mods = init_rnn(w_in, h, n_layers)
    with torch.no_grad():
        for layer, jl in zip(mods, layers):
            for dn in ("fwd", "bwd"):
                for k, v in jl[dn].items():
                    getattr(layer[dn], k).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = gru_apply(mods, xt, torch.from_numpy(lengths), dropout_rate=0.5,
                    train=True, seeds=seeds)
    (out * torch.from_numpy(g)).sum().backward()
    # f32: the XLA path sums its products in another order and packs both
    # directions into one scan; relative to the largest element
    assert _rel_err(xt.grad.numpy(), jdx) <= 1e-5
    for layer, jl in zip(mods, jgrads):
        for dn in ("fwd", "bwd"):
            for k in ("wi", "wh", "bi", "bh"):
                got = getattr(layer[dn], k).grad
                assert got is not None, (dn, k)
                assert _rel_err(got.numpy(), jl[dn][k]) <= 1e-5, (dn, k)


def test_bf16_plain_bwd_close_to_f32():
    """The same inputs, already bf16 values, through the f32 and the bf16
    plain forward and backward.  bf16 rounds ys, the residuals, dhg and dxg
    to 8 bits (2**-8 relative) at every step, and the weight gradients sum
    T*B rounded products: 3e-2 of the largest element (measured here:
    4.6e-3)."""
    x, ws, lengths, dys = _inputs(5, t=24, b=6, h=32, w=20,
                                  lengths=[24, 1, 13, 24, 6, 19])
    lt = torch.from_numpy(lengths)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        xt, *wt = [a.to(dt) for a in _torch([x, *ws], torch.bfloat16)]
        dyt = [d.to(dt) for d in _torch(dys, torch.bfloat16)]
        fwd = P.gru_bidir_layer_ref(xt, *wt, lt, train=True)
        out[dt] = P.gru_bidir_layer_bwd_ref(*_bwd_args(xt, wt, lt, fwd, dyt))
    for name, g, w in zip(GRADS, out[torch.bfloat16], out[torch.float32]):
        assert g.dtype == torch.bfloat16, name
        assert _rel_err(g.float().numpy(), w.numpy()) <= 3e-2, name


def _layer_args(requires_grad, device="cpu"):
    x, ws, lengths, _ = _inputs(9, t=10, b=3, h=16, w=6, lengths=[10, 4, 1])
    args = [torch.from_numpy(a).to(device) for a in (x, *ws)]
    for a in args:
        a.requires_grad_(requires_grad)
    return args, torch.from_numpy(lengths).to(device)


def test_autograd_fn_gives_the_plain_bwd_on_cpu():
    args, lengths = _layer_args(True)
    ysf, ysb = P.gru_bidir_layer(*args, lengths)
    assert ysf.grad_fn is not None and ysb.grad_fn is not None
    dys = [torch.randn_like(ysf), torch.randn_like(ysb)]
    got = torch.autograd.grad((ysf, ysb), args, dys)
    with torch.no_grad():
        fwd = P.gru_bidir_layer_ref(*args, lengths, train=True)
        want = P.gru_bidir_layer_bwd_ref(
            *_bwd_args(args[0], args[1:], lengths, fwd, dys))
    for name, g, w in zip(GRADS, got, want):
        assert torch.equal(g, w), name


def test_eval_form_without_grad():
    args, lengths = _layer_args(True)
    with torch.no_grad():
        ysf, _ = P.gru_bidir_layer(*args, lengths)
    assert ysf.grad_fn is None
    plain, _ = _layer_args(False)
    ysf, _ = P.gru_bidir_layer(*plain, lengths)
    assert ysf.grad_fn is None


def test_wrappers_raise_on_device_without_kernel():
    args, lengths = _layer_args(True, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        P.gru_bidir_layer(*args, lengths)
    x, wif, wib, _, _, whf, whb, _, _ = [a.detach() for a in args]
    ys = torch.empty(10, 3, 16, device="meta")
    res = torch.empty(10, 3, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        P.gru_bidir_bwd(x, wif, wib, whf, whb, lengths, ys, ys, res, res, ys,
                        ys)


@pytest.mark.parametrize("case", ["dtype", "shape", "lengths", "contiguous",
                                  "hidden"])
def test_bwd_input_checks_raise(case):
    x, ws, lengths, dys = _inputs(4, t=6, b=2, h=16, w=3, lengths=[6, 2])
    if case == "hidden":
        x, ws, lengths, dys = _inputs(4, t=6, b=2, h=12, w=3, lengths=[6, 2])
    xt, *wt = _torch([x, *ws], torch.float32)
    lt = torch.from_numpy(lengths)
    fwd = list(P.gru_bidir_layer_ref(xt, *wt, lt, train=True))
    dyt = _torch(dys, torch.float32)
    if case == "dtype":
        dyt[0] = dyt[0].double()
    elif case == "shape":
        fwd[2] = fwd[2][..., :-1]
    elif case == "lengths":
        lt = lt.long()
    elif case == "contiguous":
        dyt[1] = dyt[1].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        P._check_bwd(*_bwd_args(xt, wt, lt, fwd, dyt))


# (T*B rows, W, H): bigru's layer 0 and later layers in training (B=8,
# T=1920) and at the bench shape (B=64, T=1024); a short batch
@pytest.mark.parametrize("rows,w,h", [(15360, 400, 128), (15360, 256, 128),
                                      (65536, 400, 128), (65536, 256, 128),
                                      (144, 400, 16)])
def test_wgrad_slices_fill_the_card_and_cover_k(rows, w, h):
    """The weight gradients' K slices (``wgrad_slice_chunks``) on an H100's
    132 SMs: whole 64-row chunks, every slice non-empty and at least 4
    chunks deep unless there is one; at the training and bench shapes
    enough slices that the blocks fill the card; and the count whose waves
    of blocks end soonest (fewest slices on a tie)."""
    sms, chunks = 132, -(-rows // 64)
    depth = P.wgrad_slice_chunks(rows, w, h, sms)
    slices = -(-chunks // depth)
    assert (slices - 1) * depth < chunks <= slices * depth
    assert slices == 1 or depth >= 4
    tiles = P.wgrad_tiles(w, h)
    assert tiles == 2 * (-(-w // 64) + -(-h // 64)) * -(-(-(-3 * h // 64)) // 2)
    if rows >= 15360:
        assert tiles * slices >= sms
    cost = -(-tiles * slices // sms) * depth
    for n in range(1, 17):
        d = -(-chunks // n)
        if n > 1 and d < 4:
            break
        assert cost <= -(-tiles * -(-chunks // d) // sms) * d


# Rows 2 (the GRU layer's, G = 3H), 4 (the LSTM layer's, G = 4H) and 6 (the
# merged GRU's: dwif, dwib [W, 3H] and dwh2's column halves [2H, 3H]) at
# W=400, H=128 on 132 SMs: (row, T, B) -> (tiles, slice depth, slices,
# f32 partials a slice).  Row 2's are what they were before rows 4 and 6
# joined it.
SLICE_PLANS = {
    ("2", 1920, 8): (54, 20, 12, 2 * (400 + 128) * 384),
    ("2", 1024, 64): (54, 86, 12, 2 * (400 + 128) * 384),
    ("4", 1920, 8): (72, 22, 11, 2 * (400 + 128) * 512),
    ("4", 1024, 64): (72, 94, 11, 2 * (400 + 128) * 512),
    ("6", 1920, 8): (66, 120, 2, 2 * 400 * 384 + 256 * 768),
    ("6", 1024, 64): (66, 512, 2, 2 * 400 * 384 + 256 * 768),
}
ROW_LAYOUT = {"2": {}, "4": {"n_gates": 4}, "6": {"merged": True}}


@pytest.mark.parametrize("row,t,b", sorted(SLICE_PLANS))
def test_wgrad_slices_for_every_gate_layout(row, t, b):
    """The tile count, K-slice depth, slice count and scratch size of each
    layout's weight gradients at the main path's shape (B=8, T=1920) and
    the bench shape (B=64, T=1024): the scratch holds each slice's four
    problems' partials, as the kernels lay them out."""
    kw = ROW_LAYOUT[row]
    tiles, depth, slices, per_slice = SLICE_PLANS[(row, t, b)]
    assert P.wgrad_tiles(400, 128, **kw) == tiles
    assert P.wgrad_slice_chunks(t * b, 400, 128, 132, **kw) == depth
    assert P.wgrad_scratch_shape(t, b, 400, 128, 132, **kw) == (
        depth, (slices, per_slice))
    chunks = -(-(t * b) // 64)
    assert (slices - 1) * depth < chunks <= slices * depth
    assert P.slice_chunks(t * b, tiles, 132) == depth
