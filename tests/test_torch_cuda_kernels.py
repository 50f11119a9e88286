"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports neither JAX nor the JAX package, so on a machine with a card
and no JAX it runs on its own, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

The GRU layer's kernels come first, then the LSTM layer's, then the
flash-attention kernels, then MS-TCN's conv kernels, then the LSTM scan's,
then the GRU scan's, then the merged-body layers' (``PVA_RNN_SPLIT=0``),
then the GRU layer's fused-boundary form (``PVA_RNN_FUSED_BOUNDARY=1``) and
the flash kernels' head-major form (``PVA_FLASH_BTHD=1``).

Tolerances: f32 1e-4 (the same products summed in another order), bf16
3e-2 (the kernel and the plain version round h to bf16 before each hidden
product, so an ulp of difference can carry through the chain; h lies in
(-1, 1), where one bf16 ulp is at most 2**-8).  Gradients are sums over
T*B frames, so their error is taken relative to the largest plain value
(at least 1), with the same two tolerances: in bf16 the kernel and the
plain version round dhg to bf16 at the same points, and an ulp of
difference in the f32 carry before a rounding moves one element by one
bf16 ulp (2**-8 relative).
"""

import numpy as np
import pytest
import torch

from pytorch_video_action_tpu_torch.models.gru import BiGRU, BiGRUConfig
from pytorch_video_action_tpu_torch.ops import rnn_fused as P

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, t, b, w, h=128):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    shapes = [(w, 3 * h)] * 2 + [(3 * h,)] * 2 + [(h, 3 * h)] * 2 + [(3 * h,)] * 2
    ws = [rng.uniform(-k, k, s).astype(np.float32) for s in shapes]
    x = rng.normal(size=(t, b, w)).astype(np.float32)
    lengths = rng.integers(1, t + 1, b).astype(np.int32)
    lengths[0] = t
    lengths[-1] = 1
    return x, ws, lengths


# one block per (row, direction): B=5 fills part of the SMs, B=67 and B=600
# need more blocks than an H100's 132 SMs hold at once; H picks the template
@pytest.mark.parametrize("b,h", [(5, 128), (67, 128), (600, 128), (3, 16),
                                 (3, 32), (3, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda_device, dtype, b, h):
    x, ws, lengths = _inputs(b, t=48, b=b, w=400, h=h)
    args = [torch.from_numpy(a).to(cuda_device, dtype) for a in (x, *ws)]
    args.append(torch.from_numpy(lengths).to(cuda_device))
    before = P.gru_bidir_fwd.launches
    ysf, ysb = P.gru_bidir_layer(*args)
    torch.cuda.synchronize()
    assert P.gru_bidir_fwd.launches == before + 1
    rf, rb = P.gru_bidir_layer_ref(*args)
    assert ysf.dtype == dtype and ysf.shape == (48, b, h)
    assert (ysf.float() - rf.float()).abs().max().item() <= TOL[dtype]
    assert (ysb.float() - rb.float()).abs().max().item() <= TOL[dtype]
    pad = torch.arange(48, device=cuda_device)[:, None] >= args[-1][None, :]
    assert (ysb[pad] == 0).all()


@pytest.mark.parametrize("case", ["float64", "noncontiguous", "lengths_int64",
                                  "hidden_96"])
def test_kernel_refuses_what_it_does_not_take(cuda_device, case):
    x, ws, lengths = _inputs(1, t=8, b=3, w=16, h=96 if case == "hidden_96" else 128)
    args = [torch.from_numpy(a).to(cuda_device) for a in (x, *ws, lengths)]
    if case == "float64":
        args = [a.double() for a in args[:-1]] + args[-1:]
    elif case == "noncontiguous":
        args[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "lengths_int64":
        args[-1] = args[-1].long()
    before = P.gru_bidir_fwd.launches
    with pytest.raises((TypeError, ValueError)):
        P.gru_bidir_layer(*args)
    assert P.gru_bidir_fwd.launches == before


# Row 1's eval and train forms at every H the kernel takes, at the serving
# batch (3), the training batch (8) and past one wave of blocks (67: 134
# blocks of 3H threads, more than an H100's 132 SMs hold at H=128), ragged
# lengths: each against its plain version and a rerun (bit for bit), the
# backward chain's ys 0 on padding, the train form's ys the eval form's.
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("b", [3, 8, 67])
@pytest.mark.parametrize("h", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_forms_match_plain_and_rerun(cuda_device, dtype, h, b, train):
    x, ws, lengths = _inputs(h + b, t=48, b=b, w=400, h=h)
    args = [torch.from_numpy(a).to(cuda_device, dtype) for a in (x, *ws)]
    args.append(torch.from_numpy(lengths).to(cuda_device))
    counter = "train_launches" if train else "launches"
    before = getattr(P.gru_bidir_fwd, counter)
    got = P.gru_bidir_fwd(*args, train=train)
    again = P.gru_bidir_fwd(*args, train=train)
    torch.cuda.synchronize()
    assert getattr(P.gru_bidir_fwd, counter) == before + 2
    want = P.gru_bidir_layer_ref(*args, train=train)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() <= TOL[dtype]
        assert torch.equal(g, a)
    pad = torch.arange(48, device=cuda_device)[:, None] >= args[-1][None, :]
    assert (got[1][pad] == 0).all()
    if train:
        eval_ys = P.gru_bidir_fwd(*args)
        assert torch.equal(got[0], eval_ys[0])
        assert torch.equal(got[1], eval_ys[1])


def test_bigru_on_card_matches_cpu(cuda_device):
    model = BiGRU(BiGRUConfig(n_class=48),
                  generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 70, 400)).astype(np.float32))
    lengths = torch.tensor([70, 33, 1], dtype=torch.int32)
    with torch.no_grad():
        want = model(x, lengths)
        gpu = model.to(cuda_device)
        before = P.gru_bidir_fwd.launches
        got = gpu(x.to(cuda_device), lengths.to(cuda_device)).cpu()
    assert P.gru_bidir_fwd.launches == before + 4
    assert (got - want).abs().max().item() <= 1e-4


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1.0)).item()


def _train_case(cuda_device, dtype, b, h, seed=0, t=48, w=400):
    x, ws, lengths = _inputs(seed, t=t, b=b, w=w, h=h)
    args = [torch.from_numpy(a).to(cuda_device, dtype) for a in (x, *ws)]
    args.append(torch.from_numpy(lengths).to(cuda_device))
    dys = [torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=(t, b, h)).astype(np.float32)).to(cuda_device, dtype)
        for _ in range(2)]
    return args, dys


def _bwd_args(args, fwd, dys):
    x, wif, wib, _, _, whf, whb, _, _, lengths = args
    return (x, wif, wib, whf, whb, lengths, *fwd, *dys)


@pytest.mark.parametrize("b,h", [(5, 128), (67, 128), (3, 16), (3, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_form_matches_plain(cuda_device, dtype, b, h):
    args, _ = _train_case(cuda_device, dtype, b, h)
    before = P.gru_bidir_fwd.train_launches
    got = P.gru_bidir_fwd(*args, train=True)
    torch.cuda.synchronize()
    assert P.gru_bidir_fwd.train_launches == before + 1
    want = P.gru_bidir_layer_ref(*args, train=True)
    eval_ys = P.gru_bidir_fwd(*args)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert (g.float() - w.float()).abs().max().item() <= TOL[dtype]
    # the train form's ys are the eval form's, bit for bit
    assert torch.equal(got[0], eval_ys[0]) and torch.equal(got[1], eval_ys[1])


# B=5 one wave of chain blocks, B=67 and B=600 more than one; H picks the
# template
@pytest.mark.parametrize("b,h", [(5, 128), (67, 128), (600, 128), (3, 16),
                                 (3, 32), (3, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_matches_plain(cuda_device, dtype, b, h):
    args, dys = _train_case(cuda_device, dtype, b, h, seed=b + h)
    fwd = P.gru_bidir_fwd(*args, train=True)
    bargs = _bwd_args(args, fwd, dys)
    before = P.gru_bidir_bwd.launches
    got = P.gru_bidir_bwd(*bargs)
    torch.cuda.synchronize()
    assert P.gru_bidir_bwd.launches == before + 1
    want = P.gru_bidir_layer_bwd_ref(*bargs)
    names = ["dx", "dwif", "dwib", "dbif", "dbib", "dwhf", "dwhb", "dbhf",
             "dbhb"]
    for name, g, w in zip(names, got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert _rel_err(g, w) <= TOL[dtype], (name, _rel_err(g, w))


def test_bwd_kernel_is_deterministic(cuda_device):
    args, dys = _train_case(cuda_device, torch.float32, 67, 128, seed=3)
    bargs = _bwd_args(args, P.gru_bidir_fwd(*args, train=True), dys)
    first = P.gru_bidir_bwd(*bargs)
    second = P.gru_bidir_bwd(*bargs)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bwd_kernel_refuses_what_it_does_not_take(cuda_device):
    args, dys = _train_case(cuda_device, torch.float32, 3, 128)
    bargs = list(_bwd_args(args, P.gru_bidir_fwd(*args, train=True), dys))
    bargs[-1] = bargs[-1].transpose(0, 1).contiguous().transpose(0, 1)
    before = P.gru_bidir_bwd.launches
    with pytest.raises(ValueError, match="contiguous"):
        P.gru_bidir_bwd(*bargs)
    assert P.gru_bidir_bwd.launches == before


# The backward's products on the tensor cores (csrc/rnn_wgmma.cuh) split
# K = T*B into slices of 64-row chunks (rnn_fused.wgrad_slice_chunks: 2 to
# 12 slices here on an H100) whose partials are added in order.  (B, T, W,
# H): T*B not a multiple of the slice's rows, and but for two not of 64,
# every width the layer takes, a fully padded row wherever B > 1.
WGMMA_CASES = [(8, 300, 400, 128), (1, 777, 400, 128), (64, 37, 256, 64),
               (8, 301, 100, 32), (64, 45, 256, 16)]


def _wgmma_case(cuda_device, dtype, b, t, w, h, seed):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    to = lambda a: torch.from_numpy(a).to(cuda_device, dtype)  # noqa: E731
    shapes = ([(w, 3 * h)] * 2 + [(3 * h,)] * 2 + [(h, 3 * h)] * 2
              + [(3 * h,)] * 2)
    ws = [to(rng.uniform(-k, k, s).astype(np.float32)) for s in shapes]
    x = to(rng.normal(size=(t, b, w)).astype(np.float32))
    dys = [to(rng.normal(size=(t, b, h)).astype(np.float32))
           for _ in range(2)]
    lengths = rng.integers(1, t + 1, b).astype(np.int32)
    lengths[0] = t
    if b > 1:
        lengths[1] = 0
    return x, ws, torch.from_numpy(lengths).to(cuda_device), dys


# Rows 4 (the LSTM layer's backward, G = 4H) and 6 (the merged GRU's: dwh2
# over hp2 unshifted, dx_f and dx_b apart) on the same products, row 6's
# accumulators restarted every 8 chunks: H 16-128 at B=3 and B=8, and
# bench.py's shape with every frame valid, where their K slices are
# deepest (94 and 512 chunks).
LAYER_WGMMA_CASES = [(3, 300, 400, 128), (8, 301, 400, 128),
                     (3, 150, 256, 64), (8, 77, 100, 32), (3, 200, 256, 16),
                     (64, 1024, 400, 128)]
PRODUCT_CASES = ([("gru", *c) for c in WGMMA_CASES]
                 + [(layer, *c) for layer in ("lstm", "merged")
                    for c in LAYER_WGMMA_CASES])
MERGED_GRADS = ["dxf", "dxb", "dwif", "dwib", "dbi2", "dwh2", "dbh2"]


def _product_case(cuda_device, dtype, layer, b, t, w, h):
    """``(backward, its plain version, gradient names, arguments)`` of row
    2, 4 or 6 from the train form's outputs; at T=1024 every frame valid."""
    if layer == "gru":
        x, ws, lengths, dys = _wgmma_case(cuda_device, dtype, b, t, w, h,
                                          seed=t)
        fwd = P.gru_bidir_fwd(x, *ws, lengths, train=True)
        return (P.gru_bidir_bwd, P.gru_bidir_layer_bwd_ref,
                ["dx", "dwif", "dwib", "dbif", "dbib", "dwhf", "dwhb",
                 "dbhf", "dbhb"],
                (x, ws[0], ws[1], ws[4], ws[5], lengths, *fwd, *dys))
    full = torch.full((b,), t, dtype=torch.int32, device=cuda_device)
    if layer == "lstm":
        args, dys = _lstm_case(cuda_device, dtype, b, h, seed=t, t=t, w=w)
        if t == 1024:
            args[-1] = full
        fwd = P.lstm_bidir_fwd(*args, train=True)
        return (P.lstm_bidir_bwd, P.lstm_bidir_layer_bwd_ref, LSTM_GRADS,
                _lstm_bwd_args(args, fwd, dys))
    _, merged, dys = _merged_case(cuda_device, dtype, "gru", b, h, seed=t,
                                  t=t, w=w)
    if t == 1024:
        merged = (*merged[:-1], full)
    fwd = P.gru_merged_fwd(*merged, train=True)
    return (P.gru_merged_bwd, P.gru_merged_layer_bwd_ref, MERGED_GRADS,
            _merged_bwd_args("gru", merged, fwd, dys))


@pytest.mark.parametrize("case", PRODUCT_CASES,
                         ids=[f"{c[0]}-B{c[1]}-T{c[2]}-W{c[3]}-H{c[4]}"
                              for c in PRODUCT_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_products_on_tensor_cores_match_plain(cuda_device, dtype, case):
    """Rows 2, 4 and 6 against their plain versions and a rerun bit for
    bit."""
    bwd, ref, names, bargs = _product_case(cuda_device, dtype, *case)
    got = bwd(*bargs)
    again = bwd(*bargs)
    torch.cuda.synchronize()
    want = ref(*bargs)
    assert len(got) == len(want) == len(names)
    for name, g, w, a in zip(names, got, want, again):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert _rel_err(g, w) <= TOL[dtype], (name, _rel_err(g, w))
        assert torch.equal(g, a), name


@pytest.mark.parametrize("case", WGMMA_CASES,
                         ids=[f"B{c[0]}-T{c[1]}-W{c[2]}-H{c[3]}"
                              for c in WGMMA_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bnd_bwd_products_on_tensor_cores_match_plain(cuda_device, dtype,
                                                      case):
    """Row 2 alt (boundary dropout at keep 0.7, halves of W/2 columns)
    against its plain version and a rerun bit for bit, and against row 2
    on the glue-built input with the glue's VJP of dx bit for bit."""
    b, t, w, h = case
    x, ws, lengths, dys = _wgmma_case(cuda_device, dtype, *case, seed=t + 1)
    xa, xb = x[..., :w // 2].contiguous(), x[..., w // 2:].contiguous()
    seed, keep = 77, 0.7
    fwd = P.gru_bidir_bnd_fwd(xa, xb, *ws, lengths, seed, keep, train=True)
    bargs = (xa, xb, ws[0], ws[1], ws[4], ws[5], lengths, *fwd, *dys, seed,
             keep)
    got = P.gru_bidir_bnd_bwd(*bargs)
    again = P.gru_bidir_bnd_bwd(*bargs)
    torch.cuda.synchronize()
    mask_tb = P.time_mask(lengths, t, dtype)
    xg = P.boundary_input(xa, xb, mask_tb, seed, keep)
    dx, *grads = P.gru_bidir_bwd(xg, ws[0], ws[1], ws[4], ws[5], lengths,
                                 *fwd, *dys)
    glue = (*P.boundary_vjp(dx, mask_tb, seed, keep), *grads)
    for name, g, want, a, gl in zip(BND_GRADS, got,
                                    P.gru_bidir_bnd_layer_bwd_ref(*bargs),
                                    again, glue):
        assert g.dtype == dtype and g.shape == want.shape, name
        assert _rel_err(g, want) <= TOL[dtype], (name, _rel_err(g, want))
        assert torch.equal(g, a) and torch.equal(g, gl), name


def test_bigru_train_step_on_card_matches_cpu(cuda_device):
    """One f32 train step from the same parameters, batch and dropout seeds
    on the card and on the CPU.  The loss agrees to 1e-5 and each gradient
    to 1e-3 of its tensor's largest element: f32 sums in other orders,
    carried through four layers and their chains."""
    from pytorch_video_action_tpu_torch.train.loop import Trainer

    state = BiGRU(BiGRUConfig(n_class=48),
                  generator=torch.Generator().manual_seed(1)).state_dict()
    rng = np.random.default_rng(1)
    b, t = 3, 70
    lengths = np.array([70, 33, 1], np.int32)
    x = rng.normal(size=(b, t, 400)).astype(np.float32)
    targets = rng.integers(0, 48, (b, t))
    targets[np.arange(t)[None, :] >= lengths[:, None]] = -1
    batch = (x, lengths, targets.reshape(-1), None)
    out = {}
    for device in ("cpu", cuda_device):
        model = BiGRU(BiGRUConfig(n_class=48))
        model.load_state_dict(state)
        trainer = Trainer(model, 48, seed=0, device=device)
        ts = trainer.init_state()
        before = (P.gru_bidir_fwd.train_launches, P.gru_bidir_bwd.launches)
        loss = trainer.train_step(ts, batch, seeds=[1, 2, 3, 4]).item()
        after = (P.gru_bidir_fwd.train_launches, P.gru_bidir_bwd.launches)
        grads = {k: p.grad.detach().cpu()
                 for k, p in ts.model.named_parameters()}
        out[str(device)] = (loss, grads, (after[0] - before[0],
                                          after[1] - before[1]))
    cpu, gpu = out["cpu"], out["cuda"]
    assert cpu[2] == (0, 0) and gpu[2] == (4, 4)
    assert abs(gpu[0] - cpu[0]) <= 1e-5
    for k, want in cpu[1].items():
        err = (gpu[1][k] - want).abs().max() / want.abs().max()
        assert err.item() <= 1e-3, k


# ------------------------------------------------------------------- LSTM
#
# The same tolerances.  The train form's cell states cs are f32 in both
# versions and, unlike h and the residuals, not bounded by 1, so their
# error is taken relative to their largest value (at least 1).

LSTM_CASES = [(5, 128), (67, 128), (600, 128), (3, 16), (3, 32), (3, 64)]
LSTM_GRADS = ["dx", "dwif", "dwib", "dbf", "dbb", "dwhf", "dwhb"]


def _lstm_case(cuda_device, dtype, b, h, seed=0, t=48, w=400, full=False):
    """Seeded layer arguments and output gradients; ragged lengths (the
    first row T, the last 1), or with ``full`` every frame valid."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    shapes = [(w, 4 * h)] * 2 + [(4 * h,)] * 2 + [(h, 4 * h)] * 2
    ws = [rng.uniform(-k, k, s).astype(np.float32) for s in shapes]
    x = rng.normal(size=(t, b, w)).astype(np.float32)
    lengths = rng.integers(1, t + 1, b).astype(np.int32)
    lengths[0], lengths[-1] = t, 1
    if full:
        lengths[:] = t
    args = [torch.from_numpy(a).to(cuda_device, dtype) for a in (x, *ws)]
    args.append(torch.from_numpy(lengths).to(cuda_device))
    dys = [torch.from_numpy(rng.normal(size=(t, b, h)).astype(np.float32))
           .to(cuda_device, dtype) for _ in range(2)]
    return args, dys


def _lstm_bwd_args(args, fwd, dys):
    x, wif, wib, _, _, whf, whb, lengths = args
    return (x, wif, wib, whf, whb, lengths, *fwd, *dys)


# Row 3's forms at the cases above (T=48, ragged lengths) and at the bench
# shape with every frame valid (B=64, T=1024: 128 clusters of two blocks,
# two waves on an H100); each rerun bit for bit.
LSTM_FWD_CASES = [(b, h, 48) for b, h in LSTM_CASES] + [(64, 128, 1024)]


@pytest.mark.parametrize("b,h,t", LSTM_FWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_kernel_matches_plain(cuda_device, dtype, b, h, t):
    args, _ = _lstm_case(cuda_device, dtype, b, h, seed=b, t=t,
                         full=t > 48)
    before = P.lstm_bidir_fwd.launches
    ysf, ysb = P.lstm_bidir_layer(*args)
    again = P.lstm_bidir_layer(*args)
    torch.cuda.synchronize()
    assert P.lstm_bidir_fwd.launches == before + 2
    rf, rb = P.lstm_bidir_layer_ref(*args)
    assert ysf.dtype == dtype and ysf.shape == (t, b, h)
    assert (ysf.float() - rf.float()).abs().max().item() <= TOL[dtype]
    assert (ysb.float() - rb.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(ysf, again[0]) and torch.equal(ysb, again[1])
    pad = torch.arange(t, device=cuda_device)[:, None] >= args[-1][None, :]
    assert (ysb[pad] == 0).all()


@pytest.mark.parametrize("b,h,t", LSTM_FWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_train_form_matches_plain(cuda_device, dtype, b, h, t):
    args, _ = _lstm_case(cuda_device, dtype, b, h, seed=b + 1, t=t,
                         full=t > 48)
    before = P.lstm_bidir_fwd.train_launches
    got = P.lstm_bidir_fwd(*args, train=True)
    again = P.lstm_bidir_fwd(*args, train=True)
    torch.cuda.synchronize()
    assert P.lstm_bidir_fwd.train_launches == before + 2
    want = P.lstm_bidir_layer_ref(*args, train=True)
    eval_ys = P.lstm_bidir_fwd(*args)
    for i, (g, w) in enumerate(zip(got, want)):
        cell_state = i in (2, 3)
        assert g.dtype == (torch.float32 if cell_state else dtype)
        assert _rel_err(g, w) <= TOL[dtype], i
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    # the train form's ys are the eval form's, bit for bit
    assert torch.equal(got[0], eval_ys[0]) and torch.equal(got[1], eval_ys[1])


@pytest.mark.parametrize("b,h", LSTM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwd_kernel_matches_plain(cuda_device, dtype, b, h):
    args, dys = _lstm_case(cuda_device, dtype, b, h, seed=b + h)
    bargs = _lstm_bwd_args(args, P.lstm_bidir_fwd(*args, train=True), dys)
    before = P.lstm_bidir_bwd.launches
    got = P.lstm_bidir_bwd(*bargs)
    torch.cuda.synchronize()
    assert P.lstm_bidir_bwd.launches == before + 1
    want = P.lstm_bidir_layer_bwd_ref(*bargs)
    for name, g, w in zip(LSTM_GRADS, got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert _rel_err(g, w) <= TOL[dtype], (name, _rel_err(g, w))


def test_lstm_bwd_kernel_is_deterministic(cuda_device):
    args, dys = _lstm_case(cuda_device, torch.float32, 67, 128, seed=3)
    bargs = _lstm_bwd_args(args, P.lstm_bidir_fwd(*args, train=True), dys)
    first = P.lstm_bidir_bwd(*bargs)
    second = P.lstm_bidir_bwd(*bargs)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["float64", "noncontiguous", "lengths_int64",
                                  "hidden_96", "cs_bf16"])
def test_lstm_kernels_refuse_what_they_do_not_take(cuda_device, case):
    args, dys = _lstm_case(cuda_device, torch.float32, 3,
                           96 if case == "hidden_96" else 128, t=8, w=16)
    if case == "float64":
        args = [a.double() for a in args[:-1]] + args[-1:]
    elif case == "noncontiguous":
        args[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "lengths_int64":
        args[-1] = args[-1].long()
    if case == "cs_bf16":
        bargs = list(_lstm_bwd_args(args, P.lstm_bidir_fwd(*args, train=True),
                                    dys))
        bargs[8] = bargs[8].to(torch.bfloat16)
        before = P.lstm_bidir_bwd.launches
        with pytest.raises(TypeError):
            P.lstm_bidir_bwd(*bargs)
        assert P.lstm_bidir_bwd.launches == before
        return
    before = P.lstm_bidir_fwd.launches
    with pytest.raises((TypeError, ValueError)):
        P.lstm_bidir_layer(*args)
    assert P.lstm_bidir_fwd.launches == before


def test_bilstm_train_step_on_card_matches_cpu(cuda_device):
    """One f32 bilstm train step from the same parameters, batch and
    dropout seeds on the card and on the CPU: the loss to 1e-5, each
    gradient to 1e-3 of its tensor's largest element (f32 sums in other
    orders, through two layers and their chains)."""
    from pytorch_video_action_tpu_torch.models.lstm import (BiLSTM,
                                                            BiLSTMConfig)
    from pytorch_video_action_tpu_torch.train.loop import Trainer

    state = BiLSTM(BiLSTMConfig(n_class=48),
                   generator=torch.Generator().manual_seed(1)).state_dict()
    rng = np.random.default_rng(2)
    b, t = 3, 70
    lengths = np.array([70, 33, 1], np.int32)
    x = rng.normal(size=(b, t, 400)).astype(np.float32)
    targets = rng.integers(0, 48, (b, t))
    targets[np.arange(t)[None, :] >= lengths[:, None]] = -1
    batch = (x, lengths, targets.reshape(-1), None)
    out = {}
    for device in ("cpu", cuda_device):
        model = BiLSTM(BiLSTMConfig(n_class=48))
        model.load_state_dict(state)
        trainer = Trainer(model, 48, seed=0, device=device)
        ts = trainer.init_state()
        before = (P.lstm_bidir_fwd.train_launches, P.lstm_bidir_bwd.launches)
        loss = trainer.train_step(ts, batch, seeds=[1, 2, 3]).item()
        after = (P.lstm_bidir_fwd.train_launches, P.lstm_bidir_bwd.launches)
        grads = {k: p.grad.detach().cpu()
                 for k, p in ts.model.named_parameters()}
        out[str(device)] = (loss, grads, (after[0] - before[0],
                                          after[1] - before[1]))
    cpu, gpu = out["cpu"], out["cuda"]
    assert cpu[2] == (0, 0) and gpu[2] == (2, 2)
    assert abs(gpu[0] - cpu[0]) <= 1e-5
    for k, want in cpu[1].items():
        err = (gpu[1][k] - want).abs().max() / want.abs().max()
        assert err.item() <= 1e-3, k


# ---------------------------------------------------------------- flash
#
# The flash kernels against ops/flash.py's plain versions: f32 1e-4 (the
# same products summed in another order), bf16 3e-2 (both round the dropped
# p, and in the backward ds, to bf16 at the same points; an ulp of
# difference in an f32 exp before a rounding moves one element by one bf16
# ulp).  lse and the gradients are compared relative to their largest
# plain element (at least 1).

from pytorch_video_action_tpu_torch.ops import flash as F  # noqa: E402

# (B, H, T, lengths): one zero-length video, T not a multiple of the
# 64-row tile, and one T long enough for several tiles of each kind
FLASH_CASES = [(3, 4, 200, [200, 77, 0]), (2, 4, 1100, [1100, 613])]


def _flash_case(cuda_device, dtype, b, h, t, lengths, seed=0, d=100):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.normal(size=(b, h, t, d)).astype(np.float32)
                     for _ in range(4))
    q /= np.sqrt(d)
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    to = lambda a: torch.from_numpy(a).to(cuda_device, dtype)  # noqa: E731
    return (to(q), to(k), to(v), torch.from_numpy(mask).to(cuda_device),
            to(dout))


# attn's head width, and those of --attn_head 16 and 8, whose rows (50
# and 100 bytes in bf16, 100 and 200 in f32) take the kernels' narrower
# load paths
FLASH_DS = [100, 25, 50]


@pytest.mark.parametrize("d", FLASH_DS)
@pytest.mark.parametrize("case", FLASH_CASES, ids=["T200", "T1100"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_matches_plain(cuda_device, dtype, rate, case, d):
    q, k, v, mask, _ = _flash_case(cuda_device, dtype, *case, d=d)
    before = F.flash_fwd.launches
    out, lse = F.flash_fwd(q, k, v, mask, rate, 1234)
    torch.cuda.synchronize()
    assert F.flash_fwd.launches == before + 1
    want, want_lse, _ = F.flash_fwd_ref(q, k, v, mask, rate, 1234)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert _rel_err(lse, want_lse) <= TOL[torch.float32]
    # the zero-length video: zero output and zero lse
    dead = ~mask.any(dim=-1)
    assert (out[dead] == 0).all() and (lse[dead] == 0).all()


@pytest.mark.parametrize("d", FLASH_DS)
@pytest.mark.parametrize("case", FLASH_CASES, ids=["T200", "T1100"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_matches_plain(cuda_device, dtype, rate, fused, case, d):
    q, k, v, mask, dout = _flash_case(cuda_device, dtype, *case, seed=1,
                                      d=d)
    out, lse = F.flash_fwd(q, k, v, mask, rate, 99)
    counts = lambda: (F.flash_bwd_fused.launches,  # noqa: E731
                      F.flash_bwd_dkdv.launches, F.flash_bwd_dq.launches)
    before = counts()
    got = F.flash_bwd(q, k, v, mask, rate, 99, out, lse, dout, fused=fused)
    torch.cuda.synchronize()
    step = (1, 0, 0) if fused else (0, 1, 1)
    assert counts() == tuple(a + s for a, s in zip(before, step))
    want = F.flash_bwd_ref(q, k, v, mask, rate, 99, out, lse, dout)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert _rel_err(g, w) <= TOL[dtype], (name, _rel_err(g, w))


@pytest.mark.parametrize("sms", [132, 24, 4])
def test_flash_bwd_forms_agree_and_rerun_bit_identical(cuda_device, sms,
                                                      monkeypatch):
    """The fused form over 16, 3 and 1 KV chunks (B*H = 8 on 132, 24 and 4
    SMs), against the split; each form twice, bit for bit."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {
                            "multi_processor_count": sms})())
    q, k, v, mask, dout = _flash_case(cuda_device, torch.float32, 2, 4, 1100,
                                      [1100, 613], seed=2)
    out, lse = F.flash_fwd(q, k, v, mask, 0.3, 7)
    runs = {f: [F.flash_bwd(q, k, v, mask, 0.3, 7, out, lse, dout, fused=f)
                for _ in range(2)] for f in (True, False)}
    for f in (True, False):
        for a, b in zip(*runs[f]):
            assert torch.equal(a, b), f
    for a, b in zip(runs[True][0], runs[False][0]):
        assert _rel_err(a, b) <= TOL[torch.float32]


@pytest.mark.parametrize("t", [2176, 3584])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fused_bwd_long_video_in_one_chunk(cuda_device, dtype, t,
                                                 monkeypatch):
    """The fused backward in one KV chunk a (b, h) (B*H = 4 on 4 SMs, as
    B*H >= 67 gives on 132) at padded T where lse, delta and the key mask
    no longer fit in shared memory beside an f32 ring of 4 stages: against
    its plain version, and in f32 against the split."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {
                            "multi_processor_count": 4})())
    q, k, v, mask, dout = _flash_case(cuda_device, dtype, 2, 2, t,
                                      [t, t - 300], seed=9)
    assert F.fused_chunks(4, t, 4) == 1
    out, lse = F.flash_fwd(q, k, v, mask, 0.3, 5)
    got = F.flash_bwd(q, k, v, mask, 0.3, 5, out, lse, dout, fused=True)
    want = F.flash_bwd_ref(q, k, v, mask, 0.3, 5, out, lse, dout)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g, w) <= TOL[dtype], (name, _rel_err(g, w))
    if dtype == torch.float32:
        split = F.flash_bwd(q, k, v, mask, 0.3, 5, out, lse, dout,
                            fused=False)
        for name, g, w in zip(("dq", "dk", "dv"), got, split):
            assert _rel_err(g, w) <= TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_wide_head_long_keys(cuda_device, dtype):
    """The forward at d = 480 (8 chunks of q beside the ring) with
    T_kv = 20480, where the key mask no longer fits in shared memory beside
    an f32 ring of 2 stages, against its plain version."""
    rng = np.random.default_rng(10)
    d, t, t_kv = 480, 128, 20480
    q = rng.normal(size=(1, 2, t, d)).astype(np.float32) / np.sqrt(d)
    k, v = (rng.normal(size=(1, 2, t_kv, d)).astype(np.float32)
            for _ in range(2))
    mask = np.arange(t_kv)[None, :] < 20000
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype) for a in (q, k, v))
    mask = torch.from_numpy(mask).to(cuda_device)
    out, lse = F.flash_fwd(q, k, v, mask, 0.3, 3)
    want, want_lse, _ = F.flash_fwd_ref(q, k, v, mask, 0.3, 3)
    assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert _rel_err(lse, want_lse) <= TOL[torch.float32]


def _split_bwd(*args):
    """The split backward's two kernels: ``(dq, dk, dv)``."""
    return (F.flash_bwd_dq(*args), *F.flash_bwd_dkdv(*args))


@pytest.mark.parametrize("form", ["fused", "split"])
@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_skips_key_tiles_with_no_valid_key_exactly(cuda_device, dtype,
                                                         sms, monkeypatch,
                                                         form):
    """Key tiles 8-9 of T_kv = 640 masked in both videos, tiles 0-2 in the
    second: against the same calls on T_kv = 512 (those two tiles cut off),
    out, lse, dk and dv bit for bit, dq (whose fused chunks follow T_kv)
    to the f32 tolerance, the split's dq (it walks the key tiles in order)
    bit for bit.  Dropout 0, as the keep bit's index holds T_kv.  On 8
    SMs the fused backward has 2 chunks a (b, h): the second video's first
    chunk starts on masked tiles, and every video's second chunk ends on
    them; on 132, one chunk a tile, three of them fully masked.  The
    split's dk/dv blocks take two key tiles each: tiles 8-9 are one block
    with none valid, and tiles 2-3 of the second video pair a masked tile
    with a valid one."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {
                            "multi_processor_count": sms})())
    q, k, v, mask, dout = _flash_case(cuda_device, dtype, 2, 2, 640,
                                      [512, 512], seed=6)
    mask[1, :192] = False
    cut = [a[:, :, :512].contiguous() for a in (k, v)]
    out, lse = F.flash_fwd(q, k, v, mask)
    out_c, lse_c = F.flash_fwd(q, *cut, mask[:, :512].contiguous())
    assert torch.equal(out, out_c) and torch.equal(lse, lse_c)
    delta = (dout.float() * out.float()).sum(dim=-1)
    bwd = F.flash_bwd_fused if form == "fused" else _split_bwd
    dq, dk, dv = bwd(q, k, v, mask, 0.0, None, lse, delta, dout)
    dq_c, dk_c, dv_c = bwd(q, *cut, mask[:, :512].contiguous(), 0.0, None,
                           lse, delta, dout)
    assert torch.equal(dk[:, :, :512], dk_c) and torch.equal(dv[:, :, :512],
                                                             dv_c)
    assert (dk[:, :, 512:] == 0).all() and (dv[:, :, 512:] == 0).all()
    assert dq.dtype == torch.float32  # the f32 sums, before any rounding
    assert _rel_err(dq, dq_c) <= TOL[torch.float32]
    if form == "split":
        assert torch.equal(dq, dq_c)
    want = F._bwd_ref(q, k, v, mask, 0.0, None, lse, delta, dout)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert _rel_err(g, w) <= TOL[dtype], name


# The split backward's own edges: key counts that are not a multiple of
# its dk/dv kernel's two-consumer block of 128 keys (1000, 1088), T !=
# T_kv, and the head widths of each of its forms (d <= 128: two consumers
# a block; 200: one, the dq kernel's slab 256 columns; 400: two slabs, its
# A operands streamed through the ring in f32).  bf16 rows of d = 100 are
# 200 bytes: no TMA, the 8-byte cp.async path.
SPLIT_CASES = [(700, 1000, [1000, 613]), (1088, 1088, [1088, 1000])]


@pytest.mark.parametrize("d", [64, 100, 128, 200, 400])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=["T700_Tkv1000", "T1088"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_split_bwd_matches_plain(cuda_device, dtype, rate, case, d):
    """The split's two kernels against the plain version, and a rerun of
    each bit for bit."""
    t, t_kv, lengths = case
    rng = np.random.default_rng(12)
    q, dout = (rng.normal(size=(2, 2, t, d)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.normal(size=(2, 2, t_kv, d)).astype(np.float32)
            for _ in range(2))
    q /= np.sqrt(d)
    mask = np.arange(t_kv)[None, :] < np.asarray(lengths)[:, None]
    q, k, v, dout = (torch.from_numpy(a).to(cuda_device, dtype)
                     for a in (q, k, v, dout))
    mask = torch.from_numpy(mask).to(cuda_device)
    out, lse = F.flash_fwd(q, k, v, mask, rate, 21)
    delta = (dout.float() * out.float()).sum(dim=-1)
    args = (q, k, v, mask, rate, 21, lse, delta, dout)
    got = _split_bwd(*args)
    again = _split_bwd(*args)
    want = F._bwd_ref(*args)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert _rel_err(g, w) <= TOL[dtype], (name, _rel_err(g, w))
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", ["float64", "noncontiguous", "mask_uint8",
                                  "head_513"])
def test_flash_kernels_refuse_what_they_do_not_take(cuda_device, case):
    d = 513 if case == "head_513" else 100
    q, k, v, mask, dout = _flash_case(cuda_device, torch.float32, 1, 2, 70,
                                      [70], d=d)
    if case == "float64":
        q, k, v = q.double(), k.double(), v.double()
    elif case == "noncontiguous":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "mask_uint8":
        mask = mask.to(torch.uint8)
    before = F.flash_fwd.launches
    with pytest.raises((TypeError, ValueError)):
        F.flash_fwd(q, k, v, mask)
    assert F.flash_fwd.launches == before


# attn with 2 heads (d = 200) and 1 head (d = 400): the kernels walk d in
# slabs of 128 columns
WIDE_CASES = [(2, 2, 1100, [1100, 613], 200), (1, 1, 1100, [1100], 400)]


@pytest.mark.parametrize("case", WIDE_CASES, ids=["d200", "d400"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wide_heads_match_plain(cuda_device, dtype, case):
    """The forward and both backwards at d > 128, with dropout."""
    b, h, t, lengths, d = case
    q, k, v, mask, dout = _flash_case(cuda_device, dtype, b, h, t, lengths,
                                      seed=3, d=d)
    out, lse = F.flash_fwd(q, k, v, mask, 0.3, 11)
    want, want_lse, _ = F.flash_fwd_ref(q, k, v, mask, 0.3, 11)
    assert out.shape == want.shape
    assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert _rel_err(lse, want_lse) <= TOL[torch.float32]
    want_g = F.flash_bwd_ref(q, k, v, mask, 0.3, 11, out, lse, dout)
    for fused in (True, False):
        got = F.flash_bwd(q, k, v, mask, 0.3, 11, out, lse, dout, fused=fused)
        for name, g, w in zip(("dq", "dk", "dv"), got, want_g):
            assert _rel_err(g, w) <= TOL[dtype], (fused, name, _rel_err(g, w))


def test_attn_train_step_on_card_matches_cpu(cuda_device, monkeypatch):
    """One f32 attn train step with dropout on the card and on the CPU, on
    the flash path (``BLOCKWISE_MIN_T`` lowered to 64) and the dense one:
    the loss to 1e-5, each gradient to 1e-3 of its largest element."""
    from pytorch_video_action_tpu_torch.models import attention as A
    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.train.loop import Trainer

    state = build_model("attn", 48, generator=torch.Generator().manual_seed(
        1)).state_dict()
    rng = np.random.default_rng(1)
    b, t = 3, 150
    lengths = np.array([150, 61, 1], np.int32)
    x = rng.normal(size=(b, t, 400)).astype(np.float32)
    targets = rng.integers(0, 48, (b, t))
    targets[np.arange(t)[None, :] >= lengths[:, None]] = -1
    batch = (x, lengths, targets.reshape(-1), None)
    for min_t in (64, 1024):
        monkeypatch.setattr(A, "BLOCKWISE_MIN_T", min_t)
        out = {}
        for device in ("cpu", cuda_device):
            model = build_model("attn", 48)
            model.load_state_dict(state)
            trainer = Trainer(model, 48, seed=0, device=device)
            ts = trainer.init_state()
            before = (F.flash_fwd.launches, F.flash_bwd_fused.launches
                      + F.flash_bwd_dkdv.launches)
            loss = trainer.train_step(ts, batch, seeds=[5]).item()
            after = (F.flash_fwd.launches, F.flash_bwd_fused.launches
                     + F.flash_bwd_dkdv.launches)
            grads = {k: p.grad.detach().cpu()
                     for k, p in ts.model.named_parameters()}
            out[str(device)] = (loss, grads, (after[0] - before[0],
                                              after[1] - before[1]))
        cpu, gpu = out["cpu"], out["cuda"]
        assert cpu[2] == (0, 0)
        assert gpu[2] == ((1, 1) if min_t == 64 else (0, 0))
        assert abs(gpu[0] - cpu[0]) <= 1e-5, min_t
        for k, want in cpu[1].items():
            err = (gpu[1][k] - want).abs().max() / want.abs().max()
            assert err.item() <= 1e-3, (min_t, k)


# ----------------------------------------------------------------- MS-TCN
#
# The conv kernels take the plain versions' arithmetic: f32 products of f32
# (or exactly converted bf16) operands, f32 tail, one rounding to the
# input dtype.  Forwards: f32 1e-4, bf16 3e-2 of the largest plain value
# (at least 1; a stage of 20 residual layers grows the values past 1).
# Gradients relative to their largest plain element, the same tolerances.

from pytorch_video_action_tpu_torch.ops import conv as CV  # noqa: E402

# (B, T, lengths): T not a multiple of the 64-frame tile and several tiles,
# then the main paths' shapes (serving B=3, T=1280; training B=8, T=1920)
CONV_CASES = [(3, 200, [200, 77, 1]), (3, 1280, [1280, 900, 513]),
              (8, 1920, [1920, 1800, 1500, 1200, 900, 700, 600, 513])]


def _conv_case(cuda_device, dtype, b, t, lengths, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.normal(size=s) * 0.1).astype(np.float32)).to(cuda_device, dtype)
    ws = [mk(3, 64, 64), mk(64), mk(1, 64, 64), mk(64)]
    x = torch.from_numpy(rng.normal(size=(b, t, 64)).astype(np.float32)).to(
        cuda_device, dtype)  # padded rows hold values, as conv_in leaves them
    mask = (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]).to(
        cuda_device, torch.float32)
    dy = torch.from_numpy(rng.normal(size=(b, t, 64)).astype(np.float32)).to(
        cuda_device, dtype)
    return ws, x, mask, dy


def _dilations(t):
    return [1, 5, t - 1, t, 2 ** 19]


@pytest.mark.parametrize("case", CONV_CASES, ids=["T200", "T1280", "T1920"])
@pytest.mark.parametrize("form", ["eval", "global", "per_video"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_layer_fwd_matches_plain(cuda_device, dtype, form, case):
    ws, x, mask, _ = _conv_case(cuda_device, dtype, *case)
    b = case[0]
    keep = 1.0 if form == "eval" else 0.5
    kw = ({"seed": 77} if form == "global" else
          {"seeds": list(range(1000, 1000 + b))} if form == "per_video"
          else {})
    for d in _dilations(case[1]):
        before = CV.dilated_residual_layer.launches
        got = CV.dilated_residual_layer(*ws, x, mask, d, keep, **kw)
        torch.cuda.synchronize()
        assert CV.dilated_residual_layer.launches == before + 1
        want = CV.layer_ref(*ws, x, mask, d, keep, **kw)
        assert got.dtype == dtype
        assert _rel_err(got, want) <= TOL[dtype], (d, _rel_err(got, want))


@pytest.mark.parametrize("case", CONV_CASES, ids=["T200", "T1280", "T1920"])
@pytest.mark.parametrize("keep", [1.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_layer_bwd_matches_plain_and_reruns(cuda_device, dtype, keep,
                                                 case):
    ws, x, mask, dy = _conv_case(cuda_device, dtype, *case, seed=1)
    for d in _dilations(case[1]):
        args = (ws[0], ws[1], ws[2], x, mask, dy, d, keep, 55)
        before = CV.dilated_residual_layer_bwd.launches
        got = CV.dilated_residual_layer_bwd(*args)
        again = CV.dilated_residual_layer_bwd(*args)
        torch.cuda.synchronize()
        assert CV.dilated_residual_layer_bwd.launches == before + 2
        want = CV.layer_bwd_ref(*args)
        for name, g, a, w in zip(("dx", "dw_d", "db_d", "dw_p", "db_p"), got,
                                 again, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert torch.equal(g, a), (d, name)
            assert _rel_err(g, w) <= TOL[dtype], (d, name, _rel_err(g, w))


@pytest.mark.parametrize("case", CONV_CASES, ids=["T200", "T1280", "T1920"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_layer_bwd_per_video_matches_plain_and_reruns(cuda_device,
                                                           dtype, case):
    """The backward with the per-video stream (ms_tcn's ``use_pallas``):
    one seed a video, the forward's keep bits."""
    ws, x, mask, dy = _conv_case(cuda_device, dtype, *case, seed=2)
    seeds = list(range(3000, 3000 + case[0]))
    for d in _dilations(case[1]):
        args = (ws[0], ws[1], ws[2], x, mask, dy, d, 0.5)
        got = CV.dilated_residual_layer_bwd(*args, seeds=seeds)
        again = CV.dilated_residual_layer_bwd(*args, seeds=seeds)
        torch.cuda.synchronize()
        want = CV.layer_bwd_ref(*args, seeds=seeds)
        for name, g, a, w in zip(("dx", "dw_d", "db_d", "dw_p", "db_p"), got,
                                 again, want):
            assert torch.equal(g, a), (d, name)
            assert _rel_err(g, w) <= TOL[dtype], (d, name, _rel_err(g, w))


@pytest.mark.parametrize("case", CONV_CASES[:2], ids=["T200", "T1280"])
@pytest.mark.parametrize("keep", [1.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_stage_matches_plain(cuda_device, dtype, keep, case):
    """20 layers (dilations 1 .. 2^19): at T=200 twelve collapse to d = T;
    the carry stays f32 in both versions."""
    rng = np.random.default_rng(2)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.normal(size=s) * 0.05).astype(np.float32)).to(cuda_device, dtype)
    stack = [mk(20, 3, 64, 64), mk(20, 64), mk(20, 64, 64), mk(20, 64)]
    _, x, mask, _ = _conv_case(cuda_device, dtype, *case, seed=3)
    seeds = (rng.integers(0, 2 ** 32, (case[0], 20), dtype=np.uint32)
             if keep < 1 else None)
    before = CV.fused_stage.launches
    got = CV.fused_stage(*stack, x, mask, keep, seeds)
    torch.cuda.synchronize()
    assert CV.fused_stage.launches == before + 1
    want = CV.stage_ref(*stack, x, mask, keep, seeds)
    assert got.dtype == dtype
    assert _rel_err(got, want) <= TOL[dtype], _rel_err(got, want)


@pytest.mark.parametrize("case", ["float64", "noncontiguous", "channels_32",
                                  "per_video_seed_count"])
def test_conv_kernels_refuse_what_they_do_not_take(cuda_device, case):
    ws, x, mask, _ = _conv_case(cuda_device, torch.float32, 2, 70, [70, 9])
    kw = {}
    if case == "float64":
        ws, x = [w.double() for w in ws], x.double()
    elif case == "noncontiguous":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "channels_32":
        x = x[..., :32].contiguous()
    else:
        kw = {"keep": 0.5, "seeds": [1, 2, 3]}
    before = CV.dilated_residual_layer.launches
    with pytest.raises((TypeError, ValueError)):
        CV.dilated_residual_layer(*ws, x, mask, 3, **kw)
    assert CV.dilated_residual_layer.launches == before


def _mstcn_batch(seed, b=3, t=150, lengths=(150, 61, 1)):
    rng = np.random.default_rng(seed)
    lengths = np.array(lengths, np.int32)
    x = rng.normal(size=(b, t, 400)).astype(np.float32)
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    targets = rng.integers(0, 48, (b, t))
    targets[np.arange(t)[None, :] >= lengths[:, None]] = -1
    return x, lengths, targets.reshape(-1), None


def test_mstcn_forward_on_card_matches_cpu(cuda_device):
    """The full-width eval forward: one stage launch a stage, logits to
    1e-4 of their largest value."""
    from pytorch_video_action_tpu_torch.models import build_model

    model = build_model("mstcn", 48, defaults=True,
                        generator=torch.Generator().manual_seed(0))
    x, lengths, _, _ = _mstcn_batch(0)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lengths)
    with torch.no_grad():
        want = model(xt, lt)
        gpu = model.to(cuda_device)
        before = CV.fused_stage.launches
        got = gpu(xt.to(cuda_device), lt.to(cuda_device)).cpu()
    assert CV.fused_stage.launches == before + 4
    assert _rel_err(got, want) <= 1e-4


def test_mstcn_train_step_on_card_matches_cpu(cuda_device):
    """One f32 ms_tcn train step with dropout from the same parameters,
    batch and seeds on the card and on the CPU: 80 layer forwards and 80
    layer backwards on the card; the loss to 1e-5, each gradient to 1e-3
    of its tensor's largest element."""
    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.train.loop import Trainer

    state = build_model("ms_tcn", 48, generator=torch.Generator().manual_seed(
        1)).state_dict()
    batch = _mstcn_batch(1)
    out = {}
    for device in ("cpu", cuda_device):
        model = build_model("ms_tcn", 48)
        model.load_state_dict(state)
        trainer = Trainer(model, 48, seed=0, device=device)
        ts = trainer.init_state()
        counts = lambda: (CV.dilated_residual_layer.launches,  # noqa: E731
                          CV.dilated_residual_layer_bwd.launches)
        before = counts()
        loss = trainer.train_step(ts, batch, seeds=list(range(80))).item()
        after = counts()
        grads = {k: p.grad.detach().cpu()
                 for k, p in ts.model.named_parameters()}
        out[str(device)] = (loss, grads, (after[0] - before[0],
                                          after[1] - before[1]))
    cpu, gpu = out["cpu"], out["cuda"]
    assert cpu[2] == (0, 0) and gpu[2] == (80, 80)
    assert abs(gpu[0] - cpu[0]) <= 1e-5
    for k, want in cpu[1].items():
        err = (gpu[1][k] - want).abs().max() / want.abs().max()
        assert err.item() <= 1e-3, k


# -------------------------------------------------------------- LSTM scan
#
# The scan kernels (ops/rnn_scan.py) against their plain versions: f32
# 1e-4, bf16 3e-2 (both round h, and the gate gradients, to bf16 at the
# same points), outputs and gradients relative to their largest plain
# element (at least 1).  The widths: vanilla_lstm serving (64) and training
# (256), the bidirectional stack's scan route at H=48 and 256, an odd width
# (100) and one whose weight slices pass a block's shared memory (512).

from pytorch_video_action_tpu_torch.ops import rnn_scan as RS  # noqa: E402

SCAN_CASES = [(48, 3, 40), (64, 3, 40), (100, 5, 33), (256, 8, 40),
              (512, 8, 24), (64, 11, 20)]


def _scan_case(cuda_device, dtype, w, b, t, seed=0):
    rng = np.random.default_rng(seed + w)
    to = lambda a: torch.from_numpy(a).to(cuda_device, dtype)  # noqa: E731
    xg = rng.normal(0, 0.5, size=(t, b, 4 * w)).astype(np.float32)
    wh = rng.uniform(-1, 1, size=(w, 4 * w)).astype(np.float32) / np.sqrt(w)
    dy = rng.normal(size=(t, b, w)).astype(np.float32)
    return to(xg), to(wh), to(dy)


@pytest.mark.parametrize("w,b,t", SCAN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_scan_fwd_matches_plain(cuda_device, dtype, w, b, t):
    xg, wh, _ = _scan_case(cuda_device, dtype, w, b, t)
    counts = lambda: (RS.lstm_scan_fwd.launches,  # noqa: E731
                      RS.lstm_scan_fwd_save.launches)
    before = counts()
    ys, cs = RS.lstm_scan_fwd(xg, wh)
    ys2, cs2, res = RS.lstm_scan_fwd_save(xg, wh)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1)
    assert torch.equal(ys, ys2) and torch.equal(cs, cs2)
    wys, wcs, wres = RS.lstm_scan_ref(xg, wh, save=True)
    for got, want in ((ys, wys), (cs, wcs), (res, wres)):
        assert got.dtype == dtype and got.shape == want.shape
        assert _rel_err(got, want) <= TOL[dtype]


# The forward's geometry (rnn_scan.chain_geometry) at its edges: one
# row; more rows than one chain carries, the last chain part full (on an
# H100, 15 clusters of 8 blocks at once: B=40 at W=256 3 rows a chain,
# B=70 6, B=100 8; B=141 at W=64 2); the bench's B=64; each width where
# the blocks or the tiers change (65 two
# blocks, 129 eight, 257 shared memory after the registers; f32: 385
# sixteen, 513 depth past shared memory read through L2; bf16: 513 sixteen,
# 713 L2); W=1024, most of its depth through L2; and past it, each thread
# taking its units in rounds (1025 two rounds of 33 units, 2048 two of 64
# at 1 and 9 rows, 4 rows a chain, 4096 four).
SCAN_GEOMETRY_CASES = [(64, 1, 40), (256, 1, 40), (256, 40, 16),
                       (256, 70, 16), (256, 100, 8),
                       (64, 141, 16), (256, 64, 64), (65, 3, 24),
                       (128, 3, 24), (129, 5, 24), (257, 3, 24),
                       (384, 3, 16), (385, 3, 16), (513, 3, 16), (712, 3, 12),
                       (713, 3, 12), (1024, 3, 8), (1025, 3, 8),
                       (2048, 1, 8), (2048, 9, 6), (4096, 2, 4)]


@pytest.mark.parametrize("w,b,t", SCAN_GEOMETRY_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_scan_fwd_geometry_edges(cuda_device, dtype, w, b, t):
    """Eval and saving forms equal bit for bit, a rerun of each too, and
    the plain version within TOL, at each edge of the geometry."""
    xg, wh, _ = _scan_case(cuda_device, dtype, w, b, t)
    ys, cs = RS.lstm_scan_fwd(xg, wh)
    ys2, cs2, res = RS.lstm_scan_fwd_save(xg, wh)
    again = RS.lstm_scan_fwd(xg, wh)
    again_save = RS.lstm_scan_fwd_save(xg, wh)
    torch.cuda.synchronize()
    assert torch.equal(ys, ys2) and torch.equal(cs, cs2)
    for got, rerun in zip((ys, cs, ys2, cs2, res), (*again, *again_save)):
        assert torch.equal(got, rerun)
    wys, wcs, wres = RS.lstm_scan_ref(xg, wh, save=True)
    for got, want in ((ys, wys), (cs, wcs), (res, wres)):
        assert got.dtype == dtype and got.shape == want.shape
        assert _rel_err(got, want) <= TOL[dtype]


# A card that runs no 16-block cluster, or no cluster at all (the
# occupancy query answered 0): the forward takes 8-block chains (W=512
# with its tail through L2, W=1024 in rounds) or one block a chain, each
# thread's units in rounds (W=256 four, W=1024 sixteen).
@pytest.mark.parametrize("w,b,t", [(256, 3, 24), (512, 8, 16),
                                   (1024, 5, 8)])
@pytest.mark.parametrize("most", [8, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_scan_fwd_on_fewer_cluster_sizes(cuda_device, monkeypatch, dtype,
                                              most, w, b, t):
    real = RS._cluster_fits(cuda_device)
    monkeypatch.setattr(RS, "_cluster_fits",
                        lambda device: lambda nc: real(nc) if nc <= most
                        else 0)
    geo = RS.chain_geometry(b, w, dtype, RS._sms(cuda_device),
                            RS._cluster_fits(cuda_device))
    assert geo.nc <= most
    test_lstm_scan_fwd_geometry_edges(cuda_device, dtype, w, b, t)


@pytest.mark.parametrize("w,b,t", SCAN_CASES)
@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_scan_bwd_matches_plain_and_reruns(cuda_device, dtype, recompute,
                                                w, b, t):
    xg, wh, dy = _scan_case(cuda_device, dtype, w, b, t, seed=1)
    ys, cs, res = RS.lstm_scan_ref(xg, wh, save=True)
    hp, cp = RS._shift(ys), RS._shift(cs)
    if recompute:
        fn, ref, args = (RS.lstm_scan_bwd, RS.lstm_scan_bwd_ref,
                         (xg, hp, cp, cs, dy, wh))
    else:
        fn, ref, args = (RS.lstm_scan_bwd_saved, RS.lstm_scan_bwd_saved_ref,
                         (res, hp, cp, dy, wh))
    before = fn.launches
    got = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    for name, g, a, want in zip(("dxg", "dwh"), got, again, ref(*args)):
        assert g.dtype == dtype and g.shape == want.shape, name
        err = _rel_err(g, want)
        print(f"lstm_scan_bwd recompute={recompute} {dtype} W={w} B={b} "
              f"T={t} {name}: {err:.4g} of the largest element")
        assert err <= TOL[dtype], (name, err)
        assert torch.equal(g, a), name


# Fault 8: both backwards at widths the forward takes and vanilla_lstm
# trains at (--lstm_hidden1 past 870), where a chain's double-buffered gate
# gradients once passed a block's shared memory ([2][8][4W] f32); past
# 6968 (row 15) and 5984 (row 16) even one row's pass it, and the
# gradients cross the cluster in device memory.
@pytest.mark.parametrize("w", [1024, 2048, 4096, 6969, 8192])
@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_scan_bwd_at_wide_widths(cuda_device, dtype, recompute, w):
    test_lstm_scan_bwd_matches_plain_and_reruns(cuda_device, dtype, recompute,
                                                w, 3, 64)


# dwh in one K slice of T*B = 65536 rows (1024 chunks) at the bench shape:
# the tensor cores' f32 sums of so many chunks lose precision past the
# gate (1.06e-4 of the largest element at 240), so the kernel restarts
# them every 8 chunks and adds the runs on the CUDA cores.
@pytest.mark.parametrize("w", [512, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_scan_bwd_dwh_in_one_deep_slice(cuda_device, dtype, w):
    assert RS.dwh_slices(1024, 64, w, RS._sms(cuda_device)) == (1024, 1)
    test_lstm_scan_bwd_matches_plain_and_reruns(cuda_device, dtype, False,
                                                w, 64, 1024)


@pytest.mark.parametrize("case", ["float64", "noncontiguous", "wh_bf16"])
def test_lstm_scan_kernels_refuse_what_they_do_not_take(cuda_device, case):
    xg, wh, _ = _scan_case(cuda_device, torch.float32, 64, 3, 8)
    if case == "float64":
        xg, wh = xg.double(), wh.double()
    elif case == "noncontiguous":
        xg = xg.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        wh = wh.to(torch.bfloat16)
    before = RS.lstm_scan_fwd.launches
    with pytest.raises((TypeError, ValueError)):
        RS.lstm_scan_fwd(xg, wh)
    assert RS.lstm_scan_fwd.launches == before


def _train_step_card_vs_cpu(cuda_device, name, flags, counters, want_counts,
                            seeds, b=3, t=70, lengths=(70, 33, 1)):
    """One f32 train step from the same parameters, batch and seeds on the
    card and on the CPU: the launches on the card, the loss to 1e-5, each
    gradient to 1e-3 of its tensor's largest element."""
    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.train.loop import Trainer

    state = build_model(name, 48, **flags,
                        generator=torch.Generator().manual_seed(1)).state_dict()
    rng = np.random.default_rng(2)
    lengths = np.asarray(lengths, np.int32)
    x = rng.normal(size=(b, t, 400)).astype(np.float32)
    targets = rng.integers(0, 48, (b, t))
    targets[np.arange(t)[None, :] >= lengths[:, None]] = -1
    batch = (x, lengths, targets.reshape(-1), None)
    out = {}
    for device in ("cpu", cuda_device):
        model = build_model(name, 48, **flags)
        model.load_state_dict(state)
        trainer = Trainer(model, 48, seed=0, device=device)
        ts = trainer.init_state()
        before = [c.launches for c in counters]
        loss = trainer.train_step(ts, batch, seeds=seeds).item()
        steps = tuple(c.launches - n for c, n in zip(counters, before))
        grads = {k: p.grad.detach().cpu()
                 for k, p in ts.model.named_parameters()}
        out[str(device)] = (loss, grads, steps)
    cpu, gpu = out["cpu"], out["cuda"]
    assert cpu[2] == (0,) * len(counters) and gpu[2] == want_counts
    assert abs(gpu[0] - cpu[0]) <= 1e-5
    for k, want in cpu[1].items():
        err = (gpu[1][k] - want).abs().max() / want.abs().max()
        assert err.item() <= 1e-3, k


@pytest.mark.parametrize("recompute", [False, True])
def test_vanilla_lstm_train_step_on_card_matches_cpu(cuda_device, monkeypatch,
                                                     recompute):
    """vanilla_lstm at the train CLI's defaults (H=256, 2 layers, dropout
    0.5): a saving forward and a backward a layer, or with the recompute
    backward an eval-form forward and a recompute backward."""
    monkeypatch.setattr(RS, "RECOMPUTE_BWD", recompute)
    counters = (RS.lstm_scan_fwd, RS.lstm_scan_fwd_save,
                RS.lstm_scan_bwd_saved, RS.lstm_scan_bwd)
    want = (2, 0, 0, 2) if recompute else (0, 2, 2, 0)
    _train_step_card_vs_cpu(cuda_device, "vanilla_lstm", {}, counters, want,
                            [7])


def test_bilstm_at_lstm_hidden1_512_trains_on_card(cuda_device):
    """bilstm at ``--lstm_hidden1 512`` (H=256, not a width of the fused
    layer kernel) takes the scan, both directions, both layers."""
    _train_step_card_vs_cpu(cuda_device, "bilstm", {"lstm_hidden1": 512},
                            (RS.lstm_scan_fwd_save, RS.lstm_scan_bwd_saved),
                            (4, 4), [1, 2, 3])


# The GRU scan kernels (ops/rnn_scan.py) against their plain versions, with
# the LSTM scan's tolerances.  The widths: the bidirectional GRU stack's
# scan route at BiGRU hidden_dim_1 192 and 512 (H=96 and 256) and attn at
# hidden_dim 192 (H=96), an odd width (100), one whose weight slices pass
# a block's shared memory (512), 768 (the widest the kernels once took)
# and, fault 9, past it: 772, 1024 and 2048 (the forwards in rounds past
# 1024; the backwards' chains of fewer rows); and W=256 at B=67, more
# chains than one wave of scan_common.cuh's 16-block clusters takes (row
# 12), six rows a chain on row 11's.

GRU_SCAN_CASES = [(96, 3, 40), (100, 5, 33), (256, 8, 40), (512, 8, 24),
                  (768, 3, 12), (20, 11, 20), (772, 3, 64), (1024, 3, 64),
                  (2048, 3, 64), (256, 67, 24)]


def _gru_scan_case(cuda_device, dtype, w, b, t, seed=0):
    rng = np.random.default_rng(seed + w)
    to = lambda a: torch.from_numpy(a).to(cuda_device, dtype)  # noqa: E731
    k = 1.0 / np.sqrt(w)
    xg = rng.normal(0, 0.5, size=(t, b, 3 * w)).astype(np.float32)
    wh = rng.uniform(-k, k, size=(w, 3 * w)).astype(np.float32)
    bh = rng.uniform(-k, k, size=(3 * w,)).astype(np.float32)
    dy = rng.normal(size=(t, b, w)).astype(np.float32)
    return to(xg), to(wh), to(bh), to(dy)


@pytest.mark.parametrize("w,b,t", GRU_SCAN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_scan_fwd_matches_plain(cuda_device, dtype, w, b, t):
    xg, wh, bh, _ = _gru_scan_case(cuda_device, dtype, w, b, t)
    counts = lambda: (RS.gru_scan_fwd.launches,  # noqa: E731
                      RS.gru_scan_fwd_save.launches)
    before = counts()
    ys = RS.gru_scan_fwd(xg, wh, bh)
    ys2, res = RS.gru_scan_fwd_save(xg, wh, bh)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1)
    # both forms run one kernel (the saving form adds the residuals'
    # stores): each is held against the plain version, and their ys
    # against each other bit for bit
    wys, wres = RS.gru_scan_ref(xg, wh, bh, save=True)
    for got, want in ((ys, wys), (ys2, wys), (res, wres)):
        assert got.dtype == dtype and got.shape == want.shape
        assert _rel_err(got, want) <= TOL[dtype]
    assert torch.equal(ys, ys2)


@pytest.mark.parametrize("w,b,t", GRU_SCAN_CASES)
@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_scan_bwd_matches_plain_and_reruns(cuda_device, dtype, recompute,
                                               w, b, t):
    xg, wh, bh, dy = _gru_scan_case(cuda_device, dtype, w, b, t, seed=1)
    ys, res = RS.gru_scan_ref(xg, wh, bh, save=True)
    hp = RS._shift(ys)
    if recompute:
        fn, ref, args = (RS.gru_scan_bwd, RS.gru_scan_bwd_ref,
                         (xg, hp, dy, wh, bh))
    else:
        fn, ref, args = (RS.gru_scan_bwd_saved, RS.gru_scan_bwd_saved_ref,
                         (res, hp, dy, wh))
    before = fn.launches
    got = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    for name, g, a, want in zip(("dxg", "dwh", "dbh"), got, again,
                                ref(*args)):
        assert g.dtype == dtype and g.shape == want.shape, name
        assert _rel_err(g, want) <= TOL[dtype], (name, _rel_err(g, want))
        assert torch.equal(g, a), name


# Rows 11 and 12 where even one row's double-buffered gradients pass the
# shared memory (the "gx" forms: they cross the cluster in device memory;
# row 11's chain past W = 8824, in rounds below it).
@pytest.mark.parametrize("w", [8192, 12000])
@pytest.mark.parametrize("recompute", [False, True])
def test_gru_scan_bwd_gradients_in_device_memory(cuda_device, recompute, w):
    if recompute:
        assert RS.scan_form("gru_scan_bwd", 2, w).form == "gx"
    else:
        geo = RS.scan_launch("gru_scan_bwd_saved", 2, w, torch.float32,
                             cuda_device)
        assert geo.rounds > 1 and geo.gx == (w > 8824)
    test_gru_scan_bwd_matches_plain_and_reruns(cuda_device, torch.float32,
                                               recompute, w, 2, 8)


# Rows 9 and 15 on the register-resident chain (csrc/scan_chain.cuh)
# against their plain versions and a rerun (bit for bit), at widths where
# the geometry changes (64: one block; 96, 100: two, odd depths; 256: 8
# blocks, registers; 512: shared memory; 768: L2; 1024, 2048: the
# backward's L2 and rounds) and batches of 1, 3, 8 and 64 rows (B=64:
# rows shared by a chain).
CHAIN_CASES = {
    "gru_scan_fwd": [(64, 1, 24), (96, 3, 40), (100, 64, 16), (256, 8, 40),
                     (256, 64, 16), (512, 3, 16), (768, 8, 12),
                     (768, 1, 8)],
    "lstm_scan_bwd_saved": [(64, 1, 24), (100, 3, 33), (96, 8, 20),
                            (256, 8, 40), (256, 64, 16), (512, 8, 16),
                            (1024, 3, 16), (2048, 1, 8), (2048, 64, 4)]}


@pytest.mark.parametrize("row,w,b,t", [(r, *c) for r, cs in
                                       CHAIN_CASES.items() for c in cs])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_kernels_match_plain_and_rerun(cuda_device, dtype, row, w, b,
                                             t):
    if row == "gru_scan_fwd":
        xg, wh, bh, _ = _gru_scan_case(cuda_device, dtype, w, b, t)
        fn, ref, args = RS.gru_scan_fwd, RS.gru_scan_ref, (xg, wh, bh)
    else:
        xg, wh, dy = _scan_case(cuda_device, dtype, w, b, t, seed=2)
        ys, cs, res = RS.lstm_scan_ref(xg, wh, save=True)
        fn, ref = RS.lstm_scan_bwd_saved, RS.lstm_scan_bwd_saved_ref
        args = (res, RS._shift(ys), RS._shift(cs), dy, wh)
    before = fn.launches
    got, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    want = ref(*args)
    if row == "gru_scan_fwd":
        got, again, want = (got,), (again,), (want,)
    for g, a, w_ in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w_.shape
        assert _rel_err(g, w_) <= TOL[dtype], _rel_err(g, w_)
        assert torch.equal(g, a)


@pytest.mark.parametrize("case", ["float64", "noncontiguous", "bh_bf16",
                                  "too_wide"])
def test_gru_scan_kernels_refuse_what_they_do_not_take(cuda_device, case):
    widest = RS.widest_chain(torch.float32, RS._sms(cuda_device),
                             RS._cluster_fits(cuda_device))
    if case == "too_wide":  # one past the forward's widest launch
        w = widest + 1
        f32 = dict(dtype=torch.float32, device=cuda_device)
        xg = torch.empty((8, 3, 3 * w), **f32)
        wh, bh = torch.empty((w, 3 * w), **f32), torch.empty((3 * w,), **f32)
    else:
        xg, wh, bh, _ = _gru_scan_case(cuda_device, torch.float32, 64, 3, 8)
    if case == "float64":
        xg, wh, bh = xg.double(), wh.double(), bh.double()
    elif case == "noncontiguous":
        xg = xg.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "bh_bf16":
        bh = bh.to(torch.bfloat16)
    before = RS.gru_scan_fwd.launches
    with pytest.raises((TypeError, ValueError),
                       match=(f"gru_scan_fwd: W={widest + 1} .*at most "
                              f"{widest}" if case == "too_wide" else None)):
        RS.gru_scan_fwd(xg, wh, bh)
    assert RS.gru_scan_fwd.launches == before


@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("hidden", [192, 512])
def test_bigru_at_widths_the_fused_layer_refuses_trains_on_card(
        cuda_device, monkeypatch, hidden, recompute):
    """BiGRU at hidden_dim_1 192 and 512 (H=96 and 256, not widths of the
    fused layer kernel) runs forward and backward on the card through the
    GRU scan, both directions of its 4 layers, and matches the CPU."""
    monkeypatch.setattr(RS, "RECOMPUTE_BWD", recompute)
    counters = (RS.gru_scan_fwd, RS.gru_scan_fwd_save, RS.gru_scan_bwd_saved,
                RS.gru_scan_bwd)
    want = (8, 0, 0, 8) if recompute else (0, 8, 8, 0)
    _train_step_card_vs_cpu(cuda_device, "bigru",
                            {"cfg_overrides": {"hidden_dim_1": hidden}},
                            counters, want, [1, 2, 3, 4])


def test_attn_at_hidden_dim_192_trains_on_card(cuda_device):
    """attn at hidden_dim 192: its one GRU layer (H=96) on the scan."""
    _train_step_card_vs_cpu(cuda_device, "attn",
                            {"cfg_overrides": {"hidden_dim": 192}},
                            (RS.gru_scan_fwd_save, RS.gru_scan_bwd_saved),
                            (2, 2), [5])


def test_mstcn_per_video_train_step_on_card_matches_cpu(cuda_device):
    """ms_tcn with ``use_pallas`` (the per-video dropout stream, one seed a
    video a layer): 80 layer forwards and backwards on the card."""
    _train_step_card_vs_cpu(
        cuda_device, "ms_tcn", {"use_pallas": True},
        (CV.dilated_residual_layer, CV.dilated_residual_layer_bwd), (80, 80),
        [[7 * i + j for j in range(3)] for i in range(80)])


# The merged-body layers (rows 5-8, the PVA_RNN_SPLIT=0 route) against their
# plain versions, with the split layer's tolerances, and against the split
# kernels (rows 1-4) on the same weights.  The LSTM's cell states cs (in
# the input dtype here) are taken relative to their largest value.

from pytorch_video_action_tpu_torch.ops import rnn as R  # noqa: E402

MERGED_CASES = [(5, 128), (67, 128), (3, 32)]


def _merged_case(cuda_device, dtype, cell, b, h, seed=0, t=48, w=400):
    """Per-direction weights, their gate-grouped packing, x, lengths and
    output gradients: ``(split_args, merged_args, dys)``, the layer
    arguments of rows 1/3 and of rows 5/7 on the same weights."""
    g = 4 if cell == "lstm" else 3
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    to = lambda a: torch.from_numpy(a).to(cuda_device, dtype)  # noqa: E731
    wif, wib = (to(rng.uniform(-k, k, (w, g * h)).astype(np.float32))
                for _ in range(2))
    whf, whb = (to(rng.uniform(-k, k, (h, g * h)).astype(np.float32))
                for _ in range(2))
    bif, bib, bhf, bhb = (to(rng.uniform(-k, k, (g * h,)).astype(np.float32))
                          for _ in range(4))
    x = to(rng.normal(size=(t, b, w)).astype(np.float32))
    lengths = rng.integers(1, t + 1, b).astype(np.int32)
    lengths[0], lengths[-1] = t, 1
    lengths = torch.from_numpy(lengths).to(cuda_device)
    dys = [to(rng.normal(size=(t, b, h)).astype(np.float32))
           for _ in range(2)]
    wh2 = R._pack_gate_grouped([whf, whb], h, g)
    if cell == "lstm":
        bf, bb = bif + bhf, bib + bhb
        split = (x, wif, wib, bf, bb, whf, whb, lengths)
        merged = (x, wif, wib, R._pack_gate_grouped_vec([bf, bb], h, g), wh2,
                  lengths)
    else:
        split = (x, wif, wib, bif, bib, whf, whb, bhf, bhb, lengths)
        merged = (x, wif, wib, R._pack_gate_grouped_vec([bif, bib], h, g),
                  wh2, R._pack_gate_grouped_vec([bhf, bhb], h, g), lengths)
    return split, merged, dys


def _merged_fns(cell):
    if cell == "lstm":
        return (P.lstm_merged_fwd, P.lstm_merged_layer_ref,
                P.lstm_merged_bwd, P.lstm_merged_layer_bwd_ref)
    return (P.gru_merged_fwd, P.gru_merged_layer_ref, P.gru_merged_bwd,
            P.gru_merged_layer_bwd_ref)


def _merged_bwd_args(cell, merged, fwd, dys):
    """The merged backward's arguments: hp2 (and cp2) built from the train
    form's outputs, as the autograd Functions build them."""
    x, wif2, wib2, _, wh2, *_ = merged
    lengths = merged[-1]
    ys_k = torch.cat([fwd[0], fwd[1].flip(0)], dim=-1)
    hp2 = torch.cat([torch.zeros_like(ys_k[:1]), ys_k[:-1]])
    if cell == "lstm":
        cs = fwd[2]
        cp2 = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
        return (x, fwd[3], hp2, cp2, *dys, wif2, wib2, wh2, lengths)
    return (x, fwd[2], hp2, *dys, wif2, wib2, wh2, lengths)


# the forwards also at H=16 (the GRU's 3H threads leave the last warp part
# empty) and H=64, so rows 5 and 7 run at every H the kernels take
@pytest.mark.parametrize("b,h", MERGED_CASES + [(3, 16), (3, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_merged_fwd_matches_plain(cuda_device, cell, dtype, b, h):
    _, merged, _ = _merged_case(cuda_device, dtype, cell, b, h, seed=b + h)
    fwd, ref, _, _ = _merged_fns(cell)
    before = (fwd.launches, fwd.train_launches)
    ysf, ysb = fwd(*merged)
    got = fwd(*merged, train=True)
    again = fwd(*merged, train=True)
    torch.cuda.synchronize()
    assert (fwd.launches, fwd.train_launches) == (before[0] + 1,
                                                  before[1] + 2)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    for g, w in zip((ysf, ysb), ref(*merged)):
        assert g.dtype == dtype and g.shape == (48, b, h)
        assert (g.float() - w.float()).abs().max().item() <= TOL[dtype]
    for i, (g, w) in enumerate(zip(got, ref(*merged, train=True))):
        assert g.dtype == dtype and g.shape == w.shape, i
        assert _rel_err(g, w) <= TOL[dtype], (i, _rel_err(g, w))
    # the train form's ys are the eval form's, bit for bit; ys_b is 0 on
    # the padding, where the backward half was frozen at its initial 0
    assert torch.equal(got[0], ysf) and torch.equal(got[1], ysb)
    pad = torch.arange(48, device=cuda_device)[:, None] >= merged[-1][None, :]
    assert (ysb[pad] == 0).all()


@pytest.mark.parametrize("b,h", MERGED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_merged_bwd_matches_plain_and_reruns(cuda_device, cell, dtype, b, h):
    _, merged, dys = _merged_case(cuda_device, dtype, cell, b, h, seed=b)
    fwd, _, bwd, bwd_ref = _merged_fns(cell)
    bargs = _merged_bwd_args(cell, merged, fwd(*merged, train=True), dys)
    before = bwd.launches
    got = bwd(*bargs)
    again = bwd(*bargs)
    torch.cuda.synchronize()
    assert bwd.launches == before + 2
    want = bwd_ref(*bargs)
    assert len(got) == len(want) == (6 if cell == "lstm" else 7)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == dtype and g.shape == w.shape, i
        assert _rel_err(g, w) <= TOL[dtype], (i, _rel_err(g, w))
    for a, c in zip(got, again):
        assert torch.equal(a, c)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_merged_kernels_equal_split_kernels(cuda_device, cell):
    """Rows 5-8 against rows 1-4 on the same weights, f32: ys, dx (the sum
    of the merged dx_f and dx_b), dwif, dwib and the diagonal blocks of
    dwh2, dbi2 (and the GRU's dbh2) against the per-direction gradients.
    Rows 5 and 7 run rows 1's and 3's recurrences, and xg + bi2 on their
    chains is the sum rows 1's and 3's projections form (both fold bi + bh
    the same way for the LSTM), so both cells' ys are the split layer's
    bit for bit."""
    h = 128
    split, merged, dys = _merged_case(cuda_device, torch.float32, cell, 8, h,
                                      seed=11)
    g = 4 if cell == "lstm" else 3
    fwd, _, bwd, _ = _merged_fns(cell)
    sfwd = P.lstm_bidir_fwd if cell == "lstm" else P.gru_bidir_fwd
    sbwd = P.lstm_bidir_bwd if cell == "lstm" else P.gru_bidir_bwd
    mf = fwd(*merged, train=True)
    sf = sfwd(*split, train=True)
    for a, c in zip(mf[:2], sf[:2]):
        assert torch.equal(a, c)
    mg = bwd(*_merged_bwd_args(cell, merged, mf, dys))
    x, wif, wib = split[:3]
    whf, whb = split[5:7]
    sg = sbwd(x, wif, wib, whf, whb, split[-1], *sf, *dys)
    dwh2 = mg[5]
    got = {"dx": mg[0] + mg[1], "dwif": mg[2], "dwib": mg[3],
           "dbf": P._dense(mg[4], h, g, 0), "dbb": P._dense(mg[4], h, g, 1),
           "dwhf": P._dense(dwh2[:h], h, g, 0),
           "dwhb": P._dense(dwh2[h:], h, g, 1)}
    want = {"dx": sg[0], "dwif": sg[1], "dwib": sg[2], "dbf": sg[3],
            "dbb": sg[4], "dwhf": sg[5], "dwhb": sg[6]}
    if cell == "gru":
        got.update(dbhf=P._dense(mg[6], h, g, 0),
                   dbhb=P._dense(mg[6], h, g, 1))
        want.update(dbhf=sg[7], dbhb=sg[8])
    for k, w in want.items():
        assert _rel_err(got[k], w) <= 1e-4, (k, _rel_err(got[k], w))


@pytest.mark.parametrize("case", ["float64", "noncontiguous", "lengths_int64",
                                  "hidden_96", "res_shape"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_merged_kernels_refuse_what_they_do_not_take(cuda_device, cell,
                                                     case):
    h = 96 if case == "hidden_96" else 128
    _, merged, dys = _merged_case(cuda_device, torch.float32, cell, 3, h,
                                  t=8, w=16)
    fwd, _, bwd, _ = _merged_fns(cell)
    merged = list(merged)
    if case == "res_shape":
        bargs = list(_merged_bwd_args(cell, merged, fwd(*merged, train=True),
                                      dys))
        bargs[1] = bargs[1][..., :-1].contiguous()
        before = bwd.launches
        with pytest.raises(ValueError):
            bwd(*bargs)
        assert bwd.launches == before
        return
    if case == "float64":
        merged = [a.double() for a in merged[:-1]] + merged[-1:]
    elif case == "noncontiguous":
        merged[0] = merged[0].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "lengths_int64":
        merged[-1] = merged[-1].long()
    before = (fwd.launches, fwd.train_launches)
    with pytest.raises((TypeError, ValueError)):
        fwd(*merged)
    with pytest.raises((TypeError, ValueError)):
        fwd(*merged, train=True)
    assert (fwd.launches, fwd.train_launches) == before


class _TrainForm:
    """A forward wrapper's train-form count, read as ``launches``."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.train_launches


@pytest.mark.parametrize("name", ["bigru", "bilstm"])
def test_merged_route_train_step_on_card_matches_cpu(cuda_device,
                                                     monkeypatch, name):
    """BiGRU (4 layers) and BiLSTM (2 layers) under ``PVA_RNN_SPLIT=0``: a
    merged train-form forward and backward a layer on the card, none of
    rows 1-4, and the step matches the CPU's."""
    monkeypatch.setattr(P, "SPLIT", False)
    cell = "lstm" if name == "bilstm" else "gru"
    fwd, _, bwd, _ = _merged_fns(cell)
    sfwd = P.lstm_bidir_fwd if cell == "lstm" else P.gru_bidir_fwd
    sbwd = P.lstm_bidir_bwd if cell == "lstm" else P.gru_bidir_bwd
    layers = 2 if cell == "lstm" else 4
    _train_step_card_vs_cpu(
        cuda_device, name, {}, (_TrainForm(fwd), bwd, _TrainForm(sfwd),
                                sbwd, sfwd),
        (layers, layers, 0, 0, 0),
        [1, 2, 3] if cell == "lstm" else [1, 2, 3, 4])


# --------------------------------------------------- GRU, fused boundary
#
# The fused-boundary forms (rows 1 alt and 2 alt) build the layer input in
# the products' tile loads with the glue's rounding steps, so they equal
# rows 1-2 on the glue-built input bit for bit, and their plain versions
# within the layer's tolerances.  keep None: no dropout (eval).


def _bnd_case(cuda_device, dtype, b, h=128, t=48, seed=0):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    shapes = ([(2 * h, 3 * h)] * 2 + [(3 * h,)] * 2 + [(h, 3 * h)] * 2
              + [(3 * h,)] * 2)
    to = lambda a: torch.from_numpy(a).to(cuda_device, dtype)  # noqa: E731
    ws = [to(rng.uniform(-k, k, s).astype(np.float32)) for s in shapes]
    xa, xb, dyf, dyb = (to(rng.normal(size=(t, b, h)).astype(np.float32))
                        for _ in range(4))
    lengths = rng.integers(1, t + 1, b).astype(np.int32)
    lengths[0], lengths[-1] = t, 1
    return xa, xb, ws, torch.from_numpy(lengths).to(cuda_device), (dyf, dyb)


BND_GRADS = ["dxa", "dxb", "dwif", "dwib", "dbif", "dbib", "dwhf", "dwhb",
             "dbhf", "dbhb"]


@pytest.mark.parametrize("keep", [None, 0.5, 0.7])
@pytest.mark.parametrize("b,h", [(5, 128), (67, 128), (3, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bnd_kernels_match_plain(cuda_device, dtype, b, h, keep):
    """Eval and train forms and the backward against their plain versions;
    the backward twice, bit for bit."""
    xa, xb, ws, lengths, dys = _bnd_case(cuda_device, dtype, b, h)
    seed = None if keep is None else 321
    keep = keep or 1.0
    counts = lambda: (P.gru_bidir_bnd_fwd.launches,  # noqa: E731
                      P.gru_bidir_bnd_fwd.train_launches,
                      P.gru_bidir_bnd_bwd.launches)
    before = counts()
    ys = P.gru_bidir_bnd_fwd(xa, xb, *ws, lengths, seed, keep)
    fwd = P.gru_bidir_bnd_fwd(xa, xb, *ws, lengths, seed, keep, train=True)
    wif, wib, _, _, whf, whb, _, _ = ws
    bargs = (xa, xb, wif, wib, whf, whb, lengths, *fwd, *dys, seed, keep)
    got = P.gru_bidir_bnd_bwd(*bargs)
    again = P.gru_bidir_bnd_bwd(*bargs)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 2)
    want = P.gru_bidir_bnd_layer_ref(xa, xb, *ws, lengths, seed, keep,
                                     train=True)
    for g, w in zip(fwd, want):
        assert (g.float() - w.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(ys[0], fwd[0]) and torch.equal(ys[1], fwd[1])
    for name, g, w, a in zip(BND_GRADS, got,
                             P.gru_bidir_bnd_layer_bwd_ref(*bargs), again):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert _rel_err(g, w) <= TOL[dtype], (name, _rel_err(g, w))
        assert torch.equal(g, a), name


@pytest.mark.parametrize("keep", [None, 0.5, 0.7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bnd_kernels_equal_rows_1_2_on_the_glue_input(cuda_device, dtype,
                                                      keep):
    """Row 1 alt's ys and residuals equal row 1's on the glue-built
    boundary, and row 2 alt's gradients row 2's with the glue's VJP of dx,
    bit for bit."""
    xa, xb, ws, lengths, dys = _bnd_case(cuda_device, dtype, 8, t=96, seed=4)
    seed = None if keep is None else 99
    keep = keep or 1.0
    mask_tb = P.time_mask(lengths, xa.shape[0], dtype)
    x = P.boundary_input(xa, xb, mask_tb, seed, keep)
    fwd = P.gru_bidir_bnd_fwd(xa, xb, *ws, lengths, seed, keep, train=True)
    ref = P.gru_bidir_fwd(x, *ws, lengths, train=True)
    for g, w in zip(fwd, ref):
        assert torch.equal(g, w)
    wif, wib, _, _, whf, whb, _, _ = ws
    got = P.gru_bidir_bnd_bwd(xa, xb, wif, wib, whf, whb, lengths, *fwd,
                              *dys, seed, keep)
    dx, *grads = P.gru_bidir_bwd(x, wif, wib, whf, whb, lengths, *ref, *dys)
    want = (*P.boundary_vjp(dx, mask_tb, seed, keep), *grads)
    for name, g, w in zip(BND_GRADS, got, want):
        assert torch.equal(g, w), name


def _bigru_batch():
    rng = np.random.default_rng(1)
    b, t = 3, 70
    lengths = np.array([70, 33, 1], np.int32)
    x = rng.normal(size=(b, t, 400)).astype(np.float32)
    targets = rng.integers(0, 48, (b, t))
    targets[np.arange(t)[None, :] >= lengths[:, None]] = -1
    return (x, lengths, targets.reshape(-1), None)


def test_bigru_train_step_under_the_boundary_flag(cuda_device, monkeypatch):
    """One f32 bigru train step under ``FUSED_BOUNDARY`` on the card: one
    row-1 train form and one row 2 (layer 0), three row-1-alt train forms
    and three row 2 alt; the gradients against the CPU's to 1e-3 and,
    dropout 0.5, against the card's glue route bit for bit."""
    from pytorch_video_action_tpu_torch.train.loop import Trainer

    state = BiGRU(BiGRUConfig(n_class=48),
                  generator=torch.Generator().manual_seed(1)).state_dict()
    batch = _bigru_batch()
    counters = (P.gru_bidir_fwd, P.gru_bidir_bwd, P.gru_bidir_bnd_fwd,
                P.gru_bidir_bnd_bwd)

    def step(device, flag):
        monkeypatch.setattr(P, "FUSED_BOUNDARY", flag)
        model = BiGRU(BiGRUConfig(n_class=48))
        model.load_state_dict(state)
        trainer = Trainer(model, 48, seed=0, device=device)
        ts = trainer.init_state()
        before = [getattr(c, "train_launches", c.launches) for c in counters]
        loss = trainer.train_step(ts, batch, seeds=[1, 2, 3, 4]).item()
        torch.cuda.synchronize()
        after = [getattr(c, "train_launches", c.launches) for c in counters]
        grads = {k: p.grad.detach().cpu()
                 for k, p in ts.model.named_parameters()}
        return loss, grads, [a - b for a, b in zip(after, before)]

    gpu, cpu, glue = (step(cuda_device, True), step("cpu", True),
                      step(cuda_device, False))
    assert gpu[2] == [1, 1, 3, 3] and cpu[2] == [0, 0, 0, 0]
    assert glue[2] == [4, 4, 0, 0]
    assert abs(gpu[0] - cpu[0]) <= 1e-5 and gpu[0] == glue[0]
    for k, want in cpu[1].items():
        err = (gpu[1][k] - want).abs().max() / want.abs().max()
        assert err.item() <= 1e-3, k
        assert torch.equal(gpu[1][k], glue[1][k]), k


# ------------------------------------------------- flash, head-major bthd
#
# The head-major forms (rows 17 alt and 18 alt) differ from rows 17-18 only
# in addressing, so they equal them on transposed operands bit for bit,
# and their plain versions within the flash tolerances.  attn folds its
# head width 100 into 128.


def _bthd_case(cuda_device, dtype, b, h, t, lengths, seed=0, d=128):
    q, k, v, mask, dout = _flash_case(cuda_device, dtype, b, h, t, lengths,
                                      seed=seed, d=d)
    return tuple(F._flat(a).contiguous() for a in (q, k, v)) + (
        mask, F._flat(dout).contiguous())


@pytest.mark.parametrize("case", FLASH_CASES, ids=["T200", "T1100"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bthd_matches_plain_and_the_bhtd_kernels(cuda_device, dtype,
                                                       rate, case):
    """The forward and both backwards (the fused form in place, the split
    on transposes) against the plain versions, and against rows 17-20 on
    ``[B, H, T, d]`` transposes bit for bit."""
    b, h, t, lengths = case
    q, k, v, mask, dout = _bthd_case(cuda_device, dtype, *case, seed=5)
    before = (F.flash_fwd_bthd.launches, F.flash_bwd_fused_bthd.launches)
    out, lse = F.flash_fwd_bthd(q, k, v, mask, h, rate, 1234)
    torch.cuda.synchronize()
    want, want_lse = F.flash_fwd_bthd_ref(q, k, v, mask, h, rate, 1234)
    assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert _rel_err(lse, want_lse) <= TOL[torch.float32]
    heads = [F._heads(a, h).contiguous() for a in (q, k, v, dout)]
    out4, lse4 = F.flash_fwd(*heads[:3], mask, rate, 1234)
    assert torch.equal(out, F._flat(out4))
    assert torch.equal(lse, lse4.reshape(b * h, t))
    want_g = F.flash_bwd_bthd_ref(q, k, v, mask, h, rate, 1234, out, lse,
                                  dout)
    for fused in (True, False):
        got = F.flash_bwd_bthd(q, k, v, mask, h, rate, 1234, out, lse, dout,
                               fused=fused)
        ref4 = F.flash_bwd(*heads[:3], mask, rate, 1234, out4, lse4,
                           heads[3], fused=fused)
        for name, g, w, r in zip("qkv", got, want_g, ref4):
            assert g.shape == (b, t, h * 128) and g.dtype == dtype, name
            assert _rel_err(g, w) <= TOL[dtype], (fused, name)
            assert torch.equal(g, F._flat(r)), (fused, name)
    assert (F.flash_fwd_bthd.launches,
            F.flash_bwd_fused_bthd.launches) == (before[0] + 1,
                                                 before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bthd_wide_head_matches_plain_and_the_bhtd_kernels(
        cuda_device, dtype):
    """The head-major forms at d = 200 (attn at --attn_head 2, one output
    pass of the forward, two slabs of the backward) against their plain
    versions, and against rows 17-18 on transposes bit for bit."""
    b, h, t, lengths = 2, 2, 300, [300, 171]
    q, k, v, mask, dout = _bthd_case(cuda_device, dtype, b, h, t, lengths,
                                     seed=8, d=200)
    out, lse = F.flash_fwd_bthd(q, k, v, mask, h, 0.3, 21)
    want, want_lse = F.flash_fwd_bthd_ref(q, k, v, mask, h, 0.3, 21)
    assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert _rel_err(lse, want_lse) <= TOL[torch.float32]
    heads = [F._heads(a, h).contiguous() for a in (q, k, v, dout)]
    out4, lse4 = F.flash_fwd(*heads[:3], mask, 0.3, 21)
    assert torch.equal(out, F._flat(out4))
    assert torch.equal(lse, lse4.reshape(b * h, t))
    got = F.flash_bwd_bthd(q, k, v, mask, h, 0.3, 21, out, lse, dout,
                           fused=True)
    want_g = F.flash_bwd_bthd_ref(q, k, v, mask, h, 0.3, 21, out, lse, dout)
    ref4 = F.flash_bwd(*heads[:3], mask, 0.3, 21, out4, lse4, heads[3],
                       fused=True)
    for name, g, w, r in zip("qkv", got, want_g, ref4):
        assert _rel_err(g, w) <= TOL[dtype], name
        assert torch.equal(g, F._flat(r)), name


def test_attn_train_step_under_bthd(cuda_device, monkeypatch):
    """One f32 attn train step under ``PVA_FLASH_BTHD=1`` (flash path at
    ``BLOCKWISE_MIN_T`` 64): one row 17 alt and one row 18 alt, rows 17-18
    at 0; the loss to 1e-5 and each gradient to 1e-3 of the CPU's."""
    from pytorch_video_action_tpu_torch.models import attention as A
    from pytorch_video_action_tpu_torch.models import build_model
    from pytorch_video_action_tpu_torch.train.loop import Trainer

    monkeypatch.setattr(A, "BLOCKWISE_MIN_T", 64)
    monkeypatch.setenv("PVA_FLASH_BTHD", "1")
    state = build_model("attn", 48, generator=torch.Generator().manual_seed(
        1)).state_dict()
    rng = np.random.default_rng(1)
    b, t = 3, 150
    lengths = np.array([150, 61, 1], np.int32)
    x = rng.normal(size=(b, t, 400)).astype(np.float32)
    targets = rng.integers(0, 48, (b, t))
    targets[np.arange(t)[None, :] >= lengths[:, None]] = -1
    batch = (x, lengths, targets.reshape(-1), None)
    names = ("flash_fwd_bthd", "flash_bwd_fused_bthd", "flash_fwd",
             "flash_bwd_fused")
    out = {}
    for device in ("cpu", cuda_device):
        model = build_model("attn", 48)
        model.load_state_dict(state)
        trainer = Trainer(model, 48, seed=0, device=device)
        ts = trainer.init_state()
        before = [getattr(F, n).launches for n in names]
        loss = trainer.train_step(ts, batch, seeds=[5]).item()
        after = [getattr(F, n).launches for n in names]
        out[str(device)] = (loss, {k: p.grad.detach().cpu() for k, p in
                                   ts.model.named_parameters()},
                            [a - b_ for a, b_ in zip(after, before)])
    cpu, gpu = out["cpu"], out["cuda"]
    assert cpu[2] == [0, 0, 0, 0] and gpu[2] == [1, 1, 0, 0]
    assert abs(gpu[0] - cpu[0]) <= 1e-5
    for k, want in cpu[1].items():
        err = (gpu[1][k] - want).abs().max() / want.abs().max()
        assert err.item() <= 1e-3, k
