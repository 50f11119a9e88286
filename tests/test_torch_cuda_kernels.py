"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports neither JAX nor the JAX package, so on a machine with a card
and no JAX it runs on its own, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

Tolerances: f32 1e-4 (the same products summed in another order), bf16
3e-2 (the kernel and the plain version round h to bf16 before each hidden
product, so an ulp of difference can carry through the chain; h lies in
(-1, 1), where one bf16 ulp is at most 2**-8).
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
    before = P.gru_bidir_layer.launches
    ysf, ysb = P.gru_bidir_layer(*args)
    torch.cuda.synchronize()
    assert P.gru_bidir_layer.launches == before + 1
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
    before = P.gru_bidir_layer.launches
    with pytest.raises((TypeError, ValueError)):
        P.gru_bidir_layer(*args)
    assert P.gru_bidir_layer.launches == before


def test_bigru_on_card_matches_cpu(cuda_device):
    model = BiGRU(BiGRUConfig(n_class=48),
                  generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 70, 400)).astype(np.float32))
    lengths = torch.tensor([70, 33, 1], dtype=torch.int32)
    with torch.no_grad():
        want = model(x, lengths)
        gpu = model.to(cuda_device)
        before = P.gru_bidir_layer.launches
        got = gpu(x.to(cuda_device), lengths.to(cuda_device)).cpu()
    assert P.gru_bidir_layer.launches == before + 4
    assert (got - want).abs().max().item() <= 1e-4
