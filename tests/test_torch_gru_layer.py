"""The port's bidirectional GRU layer (``pytorch_video_action_tpu_torch/ops/
rnn_fused.py``) against the JAX package's split fused layer.

On the CPU the wrapper runs the plain PyTorch version; it is held against
``rnn_fused_pallas.gru_bidir_fused_split`` in Pallas interpret mode (the
unmasked outputs, including the forward chain through padding) and against
the XLA bidirectional path.  The CUDA kernel itself is held against the
plain version in ``test_torch_cuda_kernels.py``, which runs only with a card.
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


def _inputs(seed=0, t=T, b=B, h=H, w=W, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    shapes = [(w, 3 * h)] * 2 + [(3 * h,)] * 2 + [(h, 3 * h)] * 2 + [(3 * h,)] * 2
    ws = [rng.uniform(-k, k, s).astype(np.float32) for s in shapes]
    x = rng.normal(size=(t, b, w)).astype(np.float32)
    return x, ws, np.asarray(lengths, np.int32)


def _port(x, ws, lengths, dtype=torch.float32):
    ysf, ysb = P.gru_bidir_layer(
        torch.from_numpy(x).to(dtype),
        *(torch.from_numpy(w).to(dtype) for w in ws),
        torch.from_numpy(lengths))
    return ysf.float().numpy(), ysb.float().numpy()


def _xla(x, ws, lengths, dtype=jnp.float32):
    """JAX XLA bidirectional layer (Pallas off): [T, B, 2H], masked."""
    wif, wib, bif, bib, whf, whb, bhf, bhb = (jnp.asarray(w, dtype) for w in ws)
    layer = {"fwd": {"wi": wif, "wh": whf, "bi": bif, "bh": bhf},
             "bwd": {"wi": wib, "wh": whb, "bi": bib, "bh": bhb}}
    xb = jnp.asarray(np.swapaxes(x, 0, 1), dtype)
    ln = jnp.asarray(lengths)
    orig = R.USE_PALLAS
    R.USE_PALLAS = False
    try:
        out = R._run_bidir_fused("gru", layer, xb, ln,
                                 R.length_mask(ln, x.shape[0]), ws[4].shape[0])
    finally:
        R.USE_PALLAS = orig
    return np.swapaxes(np.asarray(out, np.float32), 0, 1)


def _valid(lengths, t):
    return (np.arange(t)[:, None] < lengths[None, :])[:, :, None]


def test_plain_layer_matches_pallas_interpret():
    x, ws, lengths = _inputs()
    jf, jb = F.gru_bidir_fused_split(
        jnp.asarray(x), *(jnp.asarray(w) for w in ws), jnp.asarray(lengths),
        True)
    pf, pb = _port(x, ws, lengths)
    # unmasked: the forward chain through padding and ys_b == 0 there
    np.testing.assert_allclose(pf, np.asarray(jf), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pb, np.asarray(jb), atol=1e-5, rtol=0)
    assert np.all(pb[~_valid(lengths, T)[:, :, 0]] == 0.0)


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_layer_matches_xla_path(seed):
    lengths = np.random.default_rng(seed).integers(1, T + 1, B).astype(np.int32)
    x, ws, lengths = _inputs(seed, lengths=lengths)
    pf, pb = _port(x, ws, lengths)
    ref = _xla(x, ws, lengths)
    m = _valid(lengths, T)
    np.testing.assert_allclose(np.concatenate([pf, pb], -1) * m, ref,
                               atol=1e-5, rtol=0)


def test_plain_layer_bf16_close_to_xla_bf16():
    # bf16 rounds in other places in the two versions: the port keeps xg and
    # the carry in f32, the XLA path rounds xg and the carry to bf16 at every
    # step.  h lies in (-1, 1), where one bf16 ulp is at most 2**-8, so a few
    # ulps of drift stay under 3e-2 (measured here: 5.9e-3).
    x, ws, lengths = _inputs(3)
    pf, pb = _port(x, ws, lengths, torch.bfloat16)
    ref = _xla(x, ws, lengths, jnp.bfloat16)
    m = _valid(lengths, T)
    np.testing.assert_allclose(np.concatenate([pf, pb], -1) * m, ref,
                               atol=3e-2, rtol=0)


def test_wrapper_takes_plain_version_on_cpu():
    x, ws, lengths = _inputs(4, t=12, b=3, h=8, w=5, lengths=[12, 7, 1])
    args = [torch.from_numpy(a) for a in (x, *ws, lengths)]
    before = (P.gru_bidir_fwd.launches, P.gru_bidir_fwd.train_launches)
    got = P.gru_bidir_layer(*args)
    want = P.gru_bidir_layer_ref(*args)
    # no kernel on the CPU
    assert (P.gru_bidir_fwd.launches, P.gru_bidir_fwd.train_launches) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_raises_on_device_without_kernel():
    x, ws, lengths = _inputs(5, t=4, b=2, h=8, w=3, lengths=[4, 2])
    args = [torch.from_numpy(a).to("meta") for a in (x, *ws, lengths)]
    with pytest.raises(ValueError, match="no kernel"):
        P.gru_bidir_layer(*args)


def _bad_inputs(case):
    x, ws, lengths = _inputs(6, t=4, b=2, h=8, w=3, lengths=[4, 2])
    x, ws, lengths = (torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                      torch.from_numpy(lengths))
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
    elif case == "hidden":
        x, ws, lengths = _inputs(6, t=4, b=2, h=6, w=3, lengths=[4, 2])
        x, ws, lengths = (torch.from_numpy(x),
                          [torch.from_numpy(w) for w in ws],
                          torch.from_numpy(lengths))
    return x, ws, lengths


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "shape", "lengths",
                                  "contiguous", "hidden"])
def test_kernel_input_checks_raise(case):
    x, ws, lengths = _bad_inputs(case)
    with pytest.raises((TypeError, ValueError)):
        P._check(x, tuple(ws), lengths)
