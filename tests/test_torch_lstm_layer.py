"""The port's bidirectional LSTM layer (``pytorch_video_action_tpu_torch/
ops/rnn_fused.py``, LSTM section) against the JAX package's split fused
LSTM layer.

On the CPU the wrapper runs the plain PyTorch version; it is held against
``rnn_fused_pallas.lstm_bidir_fused_split`` in Pallas interpret mode (one
call: the unmasked outputs, including the forward chain through padding)
and against the XLA bidirectional path.  The CUDA kernel itself is held
against the plain version in ``test_torch_cuda_kernels.py``, which runs
only with a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_video_action_tpu.ops import rnn as R
from pytorch_video_action_tpu.ops import rnn_fused_pallas as F
from pytorch_video_action_tpu_torch.ops import rnn_fused as P

T, B, H, W = 64, 8, 128, 16
LENGTHS = [64, 50, 33, 1, 64, 17, 40, 8]  # T=64 -> 2 chunks in the TPU kernel


def _layers(seed, h=H, w=W):
    """One JAX layer ``{'fwd': p, 'bwd': p}`` of numpy arrays."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    shapes = {"wi": (w, 4 * h), "wh": (h, 4 * h), "bi": (4 * h,),
              "bh": (4 * h,)}
    return {d: {n: rng.uniform(-k, k, s).astype(np.float32)
                for n, s in shapes.items()} for d in ("fwd", "bwd")}


def _inputs(seed=0, t=T, b=B, h=H, w=W, lengths=LENGTHS):
    layer = _layers(seed, h, w)
    rng = np.random.default_rng(seed + 100)
    x = rng.normal(size=(t, b, w)).astype(np.float32)
    return x, layer, np.asarray(lengths, np.int32)


def _weights(layer):
    """The layer's operands in kernel order: wif, wib, the folded biases,
    whf, whb."""
    f, b = layer["fwd"], layer["bwd"]
    return [f["wi"], b["wi"], f["bi"] + f["bh"], b["bi"] + b["bh"], f["wh"],
            b["wh"]]


def _port(x, layer, lengths, dtype=torch.float32):
    ysf, ysb = P.lstm_bidir_layer(
        torch.from_numpy(x).to(dtype),
        *(torch.from_numpy(w).to(dtype) for w in _weights(layer)),
        torch.from_numpy(lengths))
    return ysf.float().numpy(), ysb.float().numpy()


def _xla(x, layer, lengths, dtype=jnp.float32):
    """JAX XLA bidirectional LSTM layer (Pallas off): [T, B, 2H], masked."""
    jl = {d: {n: jnp.asarray(v, dtype) for n, v in p.items()}
          for d, p in layer.items()}
    xb = jnp.asarray(np.swapaxes(x, 0, 1), dtype)
    ln = jnp.asarray(lengths)
    orig = R.USE_PALLAS
    R.USE_PALLAS = False
    try:
        out = R._run_bidir_fused("lstm", jl, xb, ln,
                                 R.length_mask(ln, x.shape[0]),
                                 layer["fwd"]["wh"].shape[0])
    finally:
        R.USE_PALLAS = orig
    return np.swapaxes(np.asarray(out, np.float32), 0, 1)


def _valid(lengths, t):
    return (np.arange(t)[:, None] < lengths[None, :])[:, :, None]


def test_plain_layer_matches_pallas_interpret():
    x, layer, lengths = _inputs()
    jf, jb = F.lstm_bidir_fused_split(
        jnp.asarray(x), *(jnp.asarray(w) for w in _weights(layer)),
        jnp.asarray(lengths), True)
    pf, pb = _port(x, layer, lengths)
    # unmasked: the forward chain through padding and ys_b == 0 there
    np.testing.assert_allclose(pf, np.asarray(jf), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pb, np.asarray(jb), atol=1e-5, rtol=0)
    assert np.all(pb[~_valid(lengths, T)[:, :, 0]] == 0.0)
    assert np.abs(pf[~_valid(lengths, T)[:, :, 0]]).max() > 0.0


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_layer_matches_xla_path(seed):
    lengths = np.random.default_rng(seed).integers(1, T + 1, B).astype(np.int32)
    x, layer, lengths = _inputs(seed, lengths=lengths)
    pf, pb = _port(x, layer, lengths)
    ref = _xla(x, layer, lengths)
    m = _valid(lengths, T)
    np.testing.assert_allclose(np.concatenate([pf, pb], -1) * m, ref,
                               atol=1e-5, rtol=0)


def test_plain_layer_bf16_close_to_xla_bf16():
    # bf16 rounds in other places in the two versions: the port keeps xg,
    # the cell state c and the gate math in f32 and rounds only h (before
    # the hidden product and in ys), the XLA path rounds xg, h and c to
    # bf16 at every step.  c is not bounded by 1: with W=400 inputs |c|
    # reaches 2.07 here, and its rounding error, 2**-8 relative, grows with
    # it and feeds h through tanh(c).  The drift measured here over 64
    # steps is 8.8e-3 in h (|h| < 1); the bound is 3e-2.
    x, layer, lengths = _inputs(3, w=400)
    pf, pb = _port(x, layer, lengths, torch.bfloat16)
    ref = _xla(x, layer, lengths, jnp.bfloat16)
    m = _valid(lengths, T)
    np.testing.assert_allclose(np.concatenate([pf, pb], -1) * m, ref,
                               atol=3e-2, rtol=0)


def test_train_form_ys_equal_eval_form_and_residuals_recompute():
    x, layer, lengths = _inputs(4, t=20, b=4, h=16, w=12,
                                lengths=[20, 9, 1, 14])
    args = [torch.from_numpy(a) for a in (x, *_weights(layer))]
    lt = torch.from_numpy(lengths)
    ysf, ysb = P.lstm_bidir_layer_ref(*args, lt)
    tf, tb, csf, csb, resf, resb = P.lstm_bidir_layer_ref(*args, lt,
                                                          train=True)
    assert torch.equal(tf, ysf) and torch.equal(tb, ysb)
    # recompute i, f, g, o, tanh c from x, the weights and the previous h
    # and c read from ys and cs, as the backward does; f32, products summed
    # in another order than the step loop, so 1e-6
    xt, wif, wib, bf, bb, whf, whb = args
    h = whf.shape[0]
    zero = torch.zeros_like(ysf[:1])
    valid = torch.from_numpy(_valid(lengths, 20))
    for hp, cp, c, wi, b, wh, res, frozen in (
            (torch.cat([zero, ysf[:-1]]), torch.cat([zero, csf[:-1]]), csf,
             wif, bf, whf, resf, None),
            (torch.cat([ysb[1:], zero]), torch.cat([csb[1:], zero]), csb,
             wib, bb, whb, resb, ~valid)):
        a = xt @ wi + b + hp @ wh
        i, f = torch.sigmoid(a[..., :h]), torch.sigmoid(a[..., h:2 * h])
        g, o = torch.tanh(a[..., 2 * h:3 * h]), torch.sigmoid(a[..., 3 * h:])
        cn = f * cp + i * g
        want = torch.cat([i, f, g, o, torch.tanh(cn)], dim=-1)
        assert res.shape == want.shape and res.dtype == torch.float32
        assert (res - want).abs().max().item() <= 1e-6
        # cs is the carried cell: the step's own on valid steps, the frozen
        # carry (0) on the backward chain's padded steps
        if frozen is not None:
            cn = torch.where(frozen, torch.zeros_like(cn), cn)
        assert c.dtype == torch.float32
        assert (c - cn).abs().max().item() <= 1e-6


def test_wrapper_takes_plain_version_on_cpu():
    x, layer, lengths = _inputs(5, t=12, b=3, h=8, w=5, lengths=[12, 7, 1])
    args = [torch.from_numpy(a) for a in (x, *_weights(layer), lengths)]
    before = (P.lstm_bidir_fwd.launches, P.lstm_bidir_fwd.train_launches)
    got = P.lstm_bidir_layer(*args)
    want = P.lstm_bidir_layer_ref(*args)
    # no kernel on the CPU
    assert (P.lstm_bidir_fwd.launches,
            P.lstm_bidir_fwd.train_launches) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_raises_on_device_without_kernel():
    x, layer, lengths = _inputs(6, t=4, b=2, h=8, w=3, lengths=[4, 2])
    args = [torch.from_numpy(a).to("meta")
            for a in (x, *_weights(layer), lengths)]
    with pytest.raises(ValueError, match="no kernel"):
        P.lstm_bidir_layer(*args)


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "shape", "lengths",
                                  "contiguous", "hidden", "gru_widths"])
def test_kernel_input_checks_raise(case):
    x, layer, lengths = _inputs(7, t=4, b=2, h=8, w=3, lengths=[4, 2])
    if case == "hidden":
        x, layer, lengths = _inputs(7, t=4, b=2, h=6, w=3, lengths=[4, 2])
    x, lengths = torch.from_numpy(x), torch.from_numpy(lengths)
    ws = [torch.from_numpy(w) for w in _weights(layer)]
    if case == "dtype":
        x, ws = x.double(), [w.double() for w in ws]
    elif case == "mixed_dtype":
        ws[0] = ws[0].to(torch.bfloat16)
    elif case == "shape":
        ws[4] = ws[4][:, :-1]
    elif case == "lengths":
        lengths = lengths.long()
    elif case == "contiguous":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "gru_widths":  # 3H gate columns are the GRU's
        ws = [w[..., :3 * 8] for w in ws]
    with pytest.raises((TypeError, ValueError)):
        P._check_lstm(x, tuple(ws), lengths)
