"""The port's LSTM scan (``pytorch_video_action_tpu_torch/ops/rnn_scan.py``)
and ``masked_reverse`` against the JAX package.

On the CPU the wrappers run their plain PyTorch versions.  Those are held
against the JAX package's XLA scan ``rnn._scan_packed`` (Pallas is off on
the CPU), forward and ``jax.grad``, and in one forward and one VJP call
against ``rnn_pallas.lstm_scan_pallas`` in interpret mode.  The CUDA
kernels themselves are held against the plain versions in
``test_torch_cuda_kernels.py``, which runs only with a card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_video_action_tpu.ops import masking as JM
from pytorch_video_action_tpu.ops import rnn as R
from pytorch_video_action_tpu.ops import rnn_pallas as RP
from pytorch_video_action_tpu_torch.ops import masking as PM
from pytorch_video_action_tpu_torch.ops import rnn_scan as S


def _inputs(seed, t, b, w, lengths=None):
    """``xg [T, B, 4W]``, ``wh [W, 4W]``, prefix-form lengths, a cotangent
    ``[T, B, W]``."""
    rng = np.random.default_rng(seed)
    xg = rng.normal(0, 0.5, size=(t, b, 4 * w)).astype(np.float32)
    wh = rng.uniform(-1, 1, size=(w, 4 * w)).astype(np.float32) / np.sqrt(w)
    if lengths is None:
        lengths = rng.integers(1, t + 1, b)
        lengths[0] = t
    cot = rng.normal(size=(t, b, w)).astype(np.float32)
    return xg, wh, np.asarray(lengths, np.int32), cot


def _mask(lengths, t):
    return (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)[
        :, :, None]


def _jax(xg, wh, mask, cot, dtype=jnp.float32):
    """The XLA scan's masked ys and the gradients of sum(ys * cot)."""
    w = wh.shape[0]
    bh = jnp.zeros((4 * w,), dtype)

    def f(a, b):
        ys = R._scan_packed("lstm", a, b, bh, jnp.asarray(mask, dtype), w)
        return jnp.sum(ys.astype(jnp.float32) * cot), ys

    (_, ys), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(xg, dtype), jnp.asarray(wh, dtype))
    return [np.asarray(v, np.float32) for v in (ys, *grads)]


def _port(xg, wh, mask, cot, dtype=torch.float32):
    a = torch.from_numpy(xg).to(dtype).requires_grad_()
    b = torch.from_numpy(wh).to(dtype).requires_grad_()
    ys = S.lstm_scan(a, b, torch.from_numpy(mask).to(dtype))
    (ys.float() * torch.from_numpy(cot)).sum().backward()
    return [v.detach().float().numpy() for v in (ys, a.grad, b.grad)]


def _close(got, want, tol):
    """Each of ys, dxg, dwh within ``tol`` of its largest element (at
    least 1)."""
    for g, w, name in zip(got, want, ("ys", "dxg", "dwh")):
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= tol * scale, name


@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("w,t,b", [(48, 24, 3), (100, 17, 2), (16, 40, 5)])
def test_scan_matches_xla_f32(monkeypatch, w, t, b, recompute):
    """Ragged lengths: the raw recurrence, masked, equals the XLA scan that
    freezes the carry, and so do both backwards (f32, sums in another
    order: 1e-5 of the largest element)."""
    monkeypatch.setattr(S, "RECOMPUTE_BWD", recompute)
    xg, wh, lengths, cot = _inputs(w + t, t, b, w)
    mask = _mask(lengths, t)
    _close(_port(xg, wh, mask, cot), _jax(xg, wh, mask, cot), 1e-5)


@pytest.mark.parametrize("recompute", [False, True])
def test_scan_bf16_close_to_xla_bf16(monkeypatch, recompute):
    """bf16 rounds at other places: the port carries c and the gate math in
    f32 and rounds h before the product, the XLA scan rounds every step's
    gates, h and c; 3e-2 of the largest element."""
    monkeypatch.setattr(S, "RECOMPUTE_BWD", recompute)
    xg, wh, lengths, cot = _inputs(7, 24, 3, 48)
    mask = _mask(lengths, 24)
    _close(_port(xg, wh, mask, cot, torch.bfloat16),
           _jax(xg, wh, mask, cot, jnp.bfloat16), 3e-2)


def test_plain_versions_match_pallas_interpret():
    """One forward and one VJP call of the TPU kernels in interpret mode
    (W=128, T=16, B=8, as the JAX package's own Pallas tests): the raw,
    unmasked outputs and both gradients."""
    t, b, w = 16, 8, 128
    xg, wh, _, cot = _inputs(3, t, b, w)
    ys, vjp = jax.vjp(lambda a, c: RP.lstm_scan_pallas(a, c, True),
                      jnp.asarray(xg), jnp.asarray(wh))
    dxg, dwh = vjp(jnp.asarray(cot))
    got = _port(xg, wh, np.ones((t, b, 1), np.float32), cot)
    _close(got, [np.asarray(v) for v in (ys, dxg, dwh)], 1e-5)


def test_saving_form_and_backwards_agree():
    """The saving forward's ys and cs are the eval form's; the residuals
    are the gates; the two backwards give the same gradients (f32), and
    LSTMScanFn's equal autograd through the plain forward in float64."""
    t, b, w = 12, 3, 20
    xg, wh, _, cot = _inputs(5, t, b, w)
    xt, wt = torch.from_numpy(xg), torch.from_numpy(wh)
    ys, cs = S.lstm_scan_fwd(xt, wt)
    ys2, cs2, res = S.lstm_scan_fwd_save(xt, wt)
    assert torch.equal(ys, ys2) and torch.equal(cs, cs2)
    assert res.shape == (t, b, 5 * w)
    assert torch.allclose(res[..., 4 * w:], torch.tanh(cs), atol=1e-6)
    hp, cp = S._shift(ys), S._shift(cs)
    dy = torch.from_numpy(cot)
    saved = S.lstm_scan_bwd_saved(res, hp, cp, dy, wt)
    recomputed = S.lstm_scan_bwd(xt, hp, cp, cs, dy, wt)
    for a, c in zip(saved, recomputed):
        assert torch.allclose(a, c, atol=1e-6, rtol=1e-5)

    x64 = xt.double().requires_grad_()
    w64 = wt.double().requires_grad_()
    ys64, _ = S.lstm_scan_ref(x64, w64)
    (ys64 * dy.double()).sum().backward()
    dxg, dwh = S.lstm_scan_bwd_saved(*S.lstm_scan_ref(
        xt.double(), wt.double(), save=True)[2:], S._shift(ys64.detach()),
        S._shift(S.lstm_scan_ref(xt.double(), wt.double())[1]), dy.double(),
        wt.double())
    assert torch.allclose(dxg, x64.grad, atol=1e-12)
    assert torch.allclose(dwh, w64.grad, atol=1e-12)


def test_wrappers_refuse_other_devices():
    xg = torch.zeros(2, 1, 8, device="meta")
    wh = torch.zeros(2, 8, device="meta")
    for fn in (S.lstm_scan_fwd, S.lstm_scan_fwd_save):
        with pytest.raises(ValueError, match="no kernel"):
            fn(xg, wh)


@pytest.mark.parametrize("w,n", [(16, 1), (48, 4), (64, 4), (100, 8),
                                 (256, 16), (512, 16), (4096, 16)])
def test_cluster_size(w, n):
    assert S.cluster_size(w) == n


# ``fits`` of chain_geometry for a card of 132 SMs: every SM usable by
# clusters of any size, or GPCs that hold fewer (15 of 8 blocks, 7 of 16)
def _all_sms(nc):
    return 132 // nc


def _gpcs(nc):
    return {4: 30, 8: 15, 16: 7}.get(nc, 132 // nc)


def _check_fwd_geometry(geo, b, w, size, inputs=1):
    """What every launch of a chain kernel must hold: its blocks cover W,
    each owning a unit, and its rounds a block's units; a unit's 4s
    threads fit one warp and a block's the kernel's 256; the slices cover
    W, registers before shared memory (none with rounds); the shared memory
    (the input's buffers, ``inputs`` vectors of W a row, unless in
    device memory: gx, one row in rounds) fits the budget."""
    reg = S.FWD_REG_VALS
    u = -(-w // geo.nc)
    ut = -(-u // geo.rounds)
    assert geo.nc in (1, 2, 4, 8, 16) and (geo.nc - 1) * u < w
    assert geo.rounds >= 1 and (geo.rounds - 1) * ut < u
    assert geo.s in (1, 2, 4, 8) and 32 % (4 * geo.s) == 0
    assert 4 * ut * geo.s <= geo.threads <= S.FWD_THREADS
    assert geo.threads % 32 == 0
    assert geo.s * geo.depth >= w and geo.depth % 8 == 0
    assert geo.ls % (16 // size) == 0
    assert min(geo.depth, reg) + geo.ls <= geo.depth
    own = (geo.threads * geo.ls * size if geo.rounds == 1
           else 4 * geo.rounds * geo.rows * geo.threads)
    buffers = 0 if geo.gx else (8 * geo.rows * inputs * geo.s
                                * (max(geo.depth, reg) + 4))
    assert geo.smem == buffers + 16 + own
    assert not geo.gx or (geo.rounds > 1 and geo.rows == 1)
    assert geo.smem <= S.FWD_SMEM
    if geo.rounds > 1:
        assert geo.ls == 0 and geo.rows in (1, 2, 4)
    else:
        assert geo.rows in (1, 2, 3, 4, 6, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_fwd_geometry_covers_w_and_fits_the_card(dtype):
    """The forward's geometry at every width up to 1024 (one unit a
    thread): ``_check_fwd_geometry``; at B <= 8 and W <= 256 the chains,
    one row each, take at most the card's 132 SMs.  Widths the design
    names: one block at W=64, eight at W=256.  Rows a chain follow the
    clusters the card runs at once."""
    size = 4 if dtype == torch.float32 else 2
    for w in range(1, 1025):
        for b in (1, 3, 8, 11, 64, 141):
            geo = S.chain_geometry(b, w, dtype, 132, _all_sms)
            _check_fwd_geometry(geo, b, w, size)
            assert geo.rounds == 1
            assert -(-b // geo.rows) * geo.nc <= 132 or geo.rows == 8
            if w <= 256 and b <= 8:
                assert geo.rows == 1 and b * geo.nc <= 132
    assert S.chain_geometry(3, 64, dtype, 132, _all_sms).nc == 1
    assert S.chain_geometry(8, 256, dtype, 132, _all_sms).nc == 8
    # 15 clusters of 8 blocks at once: B=64 takes 6 rows a chain (11
    # chains), not 4 (16 chains, one of them after the rest)
    bench = lambda fits: S.chain_geometry(  # noqa: E731
        64, 256, torch.float32, 132, fits)
    assert bench(_all_sms).rows == 4 and bench(_gpcs).rows == 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_fwd_geometry_takes_wide_widths_in_rounds(dtype):
    """Past 64 units a block (W > 1024) each thread takes its units in
    rounds on 16-block chains: vanilla_lstm's --lstm_hidden1 2048 and the
    bidirectional LSTM's scan route at --lstm_hidden1 4096 (W = 2048) run;
    h's buffers cut the rows a chain where they would pass the shared
    memory; a width whose one row does not fit is refused."""
    size = 4 if dtype == torch.float32 else 2
    for w in (1025, 1100, 1500, 2047, 2048, 3000, 4096, 8192, 16384):
        for b in (1, 3, 8, 64):
            geo = S.chain_geometry(b, w, dtype, 132, _gpcs)
            _check_fwd_geometry(geo, b, w, size)
            units = -(-w // 16)
            assert geo.nc == 16 and geo.rounds == -(-units // 64)
    assert S.chain_geometry(3, 2048, dtype, 132, _gpcs).rows == 1
    assert S.chain_geometry(8, 2048, dtype, 132, _gpcs).rows == 2
    assert S.chain_geometry(64, 2048, dtype, 132, _gpcs).rows == 4
    # at 8192 four rows' h would pass the shared memory: two
    assert S.chain_geometry(64, 8192, dtype, 132, _gpcs).rows == 2
    with pytest.raises(ValueError, match="no launch takes W=30000"):
        S.chain_geometry(3, 30000, dtype, 132, _gpcs)


def test_lstm_fwd_geometry_asks_fits_only_of_the_counts_it_weighs():
    """A card that runs no 16-block cluster: W=64 and W=256 take their
    launch without asking about 16 blocks at all (a query that would raise
    is never made); wider widths take 8-block chains (W=512 f32 with its
    tail through L2, W=1024 and 2048 in rounds); a card that runs no
    cluster at all is refused."""
    asked = []

    def no16(nc):
        asked.append(nc)
        if nc == 16:
            raise RuntimeError("no cluster of 16 blocks")
        return _gpcs(nc)

    for w, b in ((64, 3), (64, 64), (256, 8), (256, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            geo = S.chain_geometry(b, w, dtype, 132, no16)
            assert geo == S.chain_geometry(b, w, dtype, 132, _gpcs)
    assert 16 not in asked and set(asked) == {1, 8}

    def none16(nc):
        return 0 if nc == 16 else _gpcs(nc)

    for w, rounds in ((512, 1), (1024, 2), (2048, 4)):
        for b in (3, 8, 64):
            geo = S.chain_geometry(b, w, torch.float32, 132, none16)
            _check_fwd_geometry(geo, b, w, 4)
            assert (geo.nc, geo.rounds) == (8, rounds)
    geo = S.chain_geometry(8, 512, torch.float32, 132, none16)
    assert geo.depth > S.FWD_REG_VALS + geo.ls  # the tail through L2
    with pytest.raises(ValueError, match="no launch"):
        S.chain_geometry(3, 64, torch.float32, 132, lambda nc: -1)


@pytest.mark.parametrize("shape", [(3, 7), (3, 7, 5), (2, 6, 2, 3)])
def test_masked_reverse_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    lengths = np.array([shape[1], 1, 4][:shape[0]], np.int32)
    want = np.asarray(JM.masked_reverse(jnp.asarray(x), jnp.asarray(lengths)))
    got = PM.masked_reverse(torch.from_numpy(x), torch.from_numpy(lengths))
    assert np.array_equal(got.numpy(), want)
    twice = PM.masked_reverse(got, torch.from_numpy(lengths)).numpy()
    valid = np.arange(shape[1])[None, :] < lengths[:, None]
    assert np.array_equal(twice[valid], x[valid])


@pytest.mark.parametrize("fits", [_all_sms, _gpcs])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwd_geometry_covers_w_and_fits_the_card(dtype, fits):
    """The saved-gates backward's chain (row 15) at every width up to 4096:
    ``_check_fwd_geometry`` with its input of 4W gradients a row; at least
    the forward's blocks (a thread keeps as many weights, a row's where the
    forward keeps a column's, but the larger input leaves less shared
    memory for them), the same where registers alone hold them; one unit a
    thread up to W=1024, rounds past it."""
    size = 4 if dtype == torch.float32 else 2
    for w in range(1, 4097):
        for b in (1, 8, 64):
            geo = S.chain_geometry(b, w, dtype, 132, fits, inputs=4)
            _check_fwd_geometry(geo, b, w, size, inputs=4)
            fwd = S.chain_geometry(b, w, dtype, 132, fits)
            assert geo.nc >= fwd.nc
            if fwd.depth <= S.FWD_REG_VALS:
                assert (geo.nc, geo.s) == (fwd.nc, fwd.s)
            assert (geo.rounds > 1) == (w > 1024)
    geo = S.chain_geometry(8, 256, dtype, 132, _gpcs, inputs=4)
    assert geo[:3] == (8, 2, 1)
    assert S.chain_geometry(64, 256, dtype, 132, _gpcs, inputs=4).rows == 6


@pytest.mark.parametrize("w", [1025, 2048, 4096, 6000, 6969, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwd_geometry_takes_wide_widths_in_rounds(dtype, w):
    """Past 64 units a block each thread of the backward takes its units in
    rounds on 16-block chains, every weight through L2, rows cut where the
    4W gradients' buffers would pass the shared memory (at 6000 one); past
    W = 6968, where one row's buffers pass it, the gradients cross the
    cluster in device memory (gx, one row), which only the kernel that
    has that form is offered."""
    for b in (1, 3, 8, 64):
        geo = S.chain_geometry(b, w, dtype, 132, _gpcs, inputs=4, gx=True)
        _check_fwd_geometry(geo, b, w, 4 if dtype == torch.float32 else 2,
                            inputs=4)
        assert geo.nc == 16 and geo.rounds == -(-(-(-w // 16)) // 64)
        assert geo.ls == 0 and geo.gx == (w > 6968)
        assert geo.gx == 0 or (geo.rows == 1 and geo.smem < 32 * 1024)
    assert S.chain_geometry(64, 6000, dtype, 132, _gpcs, inputs=4).rows == 1
    assert S.chain_geometry(3, 6968, dtype, 132, _gpcs, inputs=4).rows == 1
    if w > 6968:
        with pytest.raises(ValueError, match=f"no launch takes W={w}"):
            S.chain_geometry(3, w, dtype, 132, _gpcs, inputs=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwds_take_every_width_the_forward_takes(dtype):
    """Every W the forwards' widest launch (row 13's, 25592 on a 132-SM
    card) allows, the saved-gates backward (row 15, with its gx form) and
    the recompute backward (row 16, scan_common.cuh's forms) take too, at
    serving, training and bench batches; the recompute form's gradients
    move to device memory where one row's pass the shared memory."""
    widest = S.widest_chain(dtype, 132, _gpcs)
    widths = sorted({*range(1, 1025, 7), *range(1025, widest, 97),
                     *range(widest - 4, widest + 1), 5984, 5985, 6968, 6969})
    for w in widths:
        for b in (1, 8, 64):
            S.chain_geometry(b, w, dtype, 132, _gpcs, inputs=4, gx=True)
            form = S.scan_form("lstm_scan_bwd", b, w)
            assert form.rows == 1 or form.form == "full"
    assert S.scan_form("lstm_scan_bwd", 8, 5984).form == "one"
    assert S.scan_form("lstm_scan_bwd", 8, 6000).form == "gx"
    assert S.scan_form("lstm_scan_bwd", 8, 256) == (16, 8, "full")


def _steps_tool():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / \
        "torch_lstm_scan_steps.py"
    spec = importlib.util.spec_from_file_location("torch_lstm_scan_steps",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel", ["13", "9", "15", "1", "4", "3", "5",
                                    "11", "7"])
def test_step_tool_edits_hold_their_sources_lines(kernel):
    """Every edit of ``tools/torch_lstm_scan_steps.py`` (rows 13, 9, 15, 1,
    4, 3, 5, 11 and 7) finds its lines once in its kernel's source, so a
    changed kernel fails here rather than on the card; each build changes
    the source."""
    import importlib

    from pytorch_video_action_tpu_torch.ops import cuda_lib

    tool = _steps_tool()
    kern = tool.KERNELS[kernel]
    text = (cuda_lib.CSRC / f"{kern.source}.cu").read_text()
    module = importlib.import_module(
        f"pytorch_video_action_tpu_torch.ops.{kern.module}")
    assert hasattr(module, kern.wrapper)
    assert {"no product", "no gates", "no exchange", "skeleton"} <= set(
        kern.edits)
    for name, edits in kern.edits.items():
        for old, _ in edits:
            assert text.count(old) == 1, (name, old)
        assert tool.edited_source(text, kernel, name) != text


@pytest.mark.parametrize("gates", [4, 3])
@pytest.mark.parametrize("t,b,w", [(1920, 8, 256), (1920, 8, 512),
                                   (1024, 64, 256), (1920, 8, 1024),
                                   (1920, 8, 4096), (64, 3, 4096), (40, 8, 64)])
def test_dwh_slices_cover_k_in_the_tiles_slices(t, b, w, gates):
    """dwh's K slices (``dwh_slices``: the LSTM scan's with 4 gates, row
    15, the GRU scan's with 3, row 11) cover T*B in whole 64-row chunks:
    one slice where its 64 x 128 tiles of [W, gates*W] fill the card's 132
    SMs, else the depth ``rnn_fused.slice_chunks`` gives the tiles.  The
    kernel, not the slice depth, bounds the chunks its tensor cores sum (it
    restarts them every 8 chunks), so a slice may be the whole of K."""
    from pytorch_video_action_tpu_torch.ops.rnn_fused import slice_chunks

    depth, slices = S.dwh_slices(t, b, w, 132, gates)
    chunks = -(-(t * b) // 64)
    assert slices == -(-chunks // depth) and (slices - 1) * depth < chunks
    tiles = -(-w // 64) * -(-(gates * w) // 128)
    if tiles >= 132:
        assert slices == 1 and w >= 512
    else:
        assert depth == slice_chunks(t * b, tiles, 132)
    if (t, b, w) == (1920, 8, 256):
        assert (depth, slices) == ((60, 4) if gates == 4 else (22, 11))
