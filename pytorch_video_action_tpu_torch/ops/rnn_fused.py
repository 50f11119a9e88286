"""One bidirectional GRU layer forward: the hand-written Hopper kernel
(``csrc/gru_bidir_fwd.cu``) and its plain PyTorch version.

Counterpart of ``pytorch_video_action_tpu/ops/rnn_fused_pallas.py``
``gru_bidir_fused_split`` in its inference form (``_fwd_kernel_split`` with
``train=False``).  Same argument order and layouts: ``x [T, B, W]``
time-major, per-direction ``wi [W, 3H]``, ``wh [H, 3H]``, ``bi``/``bh
[3H]``, ``lengths [B]``; returns ``(ys_f, ys_b)``, each ``[T, B, H]`` in
original time order and unmasked.

Masking contract: the forward chain runs through padding and is not
frozen, so ``ys_f`` at ``t >= len`` holds the continued chain.  The
backward chain walks ``t = T-1 .. 0`` from ``h = 0`` and keeps its carry
while ``t >= len``, so ``ys_b`` is 0 on padding and starts at ``t = len-1``.

Numerics: matmuls take the input dtype (f32 or bf16) and accumulate in
f32; the carry and the gate math are f32; ``h`` is rounded to the weight
dtype before the hidden product; ``ys`` is stored in the input dtype.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HIDDEN = (16, 32, 64, 128)  # the kernel's register-resident widths


def gru_bidir_layer_ref(x, wif, wib, bif, bib, whf, whb, bhf, bhb, lengths):
    """Plain PyTorch version: a loop over T with the kernel's masking contract
    and dtype handling.  Products of the input dtype are exact in f32, so
    casting the operands to f32 gives f32 accumulation."""
    t_len, b, _ = x.shape
    h = whf.shape[0]
    dt = x.dtype
    f32 = torch.float32
    xf = x.to(f32)
    wi = torch.stack([wif, wib]).to(f32)  # [2, W, 3H]
    bi = torch.stack([bif, bib]).to(f32)[:, None, None, :]
    xg = torch.matmul(xf.unsqueeze(0), wi.unsqueeze(1)) + bi  # [2, T, B, 3H]
    wh = torch.stack([whf, whb]).to(f32)  # [2, H, 3H]
    bh = torch.stack([bhf, bhb]).to(f32)[:, None, :]
    lengths = lengths.to(x.device, torch.int64)
    hs = torch.zeros(2, b, h, dtype=f32, device=x.device)
    ys = torch.empty(2, t_len, b, h, dtype=dt, device=x.device)
    for s in range(t_len):
        tb = t_len - 1 - s
        gx = torch.stack([xg[0, s], xg[1, tb]])  # [2, B, 3H]
        hg = torch.bmm(hs.to(dt).to(f32), wh) + bh
        r = torch.sigmoid(gx[..., :h] + hg[..., :h])
        z = torch.sigmoid(gx[..., h:2 * h] + hg[..., h:2 * h])
        n = torch.tanh(gx[..., 2 * h:] + r * hg[..., 2 * h:])
        hn = (1.0 - z) * n + z * hs
        valid_b = (tb < lengths)[:, None]
        hs = torch.stack([hn[0], torch.where(valid_b, hn[1], hs[1])])
        ys[0, s] = hs[0].to(dt)
        ys[1, tb] = hs[1].to(dt)
    return ys[0], ys[1]


def _check(x, weights, lengths):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"gru_bidir_layer: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if x.dim() != 3:
        raise ValueError(f"gru_bidir_layer: x must be [T, B, W], got "
                         f"{tuple(x.shape)}")
    t_len, b, w_in = x.shape
    wif, wib, bif, bib, whf, whb, bhf, bhb = weights
    h = whf.shape[0]
    expect = {"wif": (w_in, 3 * h), "wib": (w_in, 3 * h), "bif": (3 * h,),
              "bib": (3 * h,), "whf": (h, 3 * h), "whb": (h, 3 * h),
              "bhf": (3 * h,), "bhb": (3 * h,)}
    for (name, shape), w in zip(expect.items(), weights):
        if tuple(w.shape) != shape:
            raise ValueError(f"gru_bidir_layer: {name} has shape "
                             f"{tuple(w.shape)}, expected {shape}")
        if w.dtype != x.dtype:
            raise TypeError(f"gru_bidir_layer: {name} is {w.dtype}, x is "
                            f"{x.dtype}")
    if h not in _HIDDEN:
        raise ValueError(f"gru_bidir_layer: H={h} not supported by the kernel "
                         f"(one of {_HIDDEN})")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError("gru_bidir_layer: lengths must be int32 [B]")
    for w in (x, *weights, lengths):
        if w.device != x.device:
            raise ValueError("gru_bidir_layer: all tensors must be on "
                             f"{x.device}")
        if not w.is_contiguous():
            raise ValueError("gru_bidir_layer: tensors must be contiguous")
    return t_len, b, w_in, h


def _library():
    from . import cuda_lib

    lib = cuda_lib.load("gru_bidir_fwd")
    fn = lib.gru_bidir_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 13
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.gru_bidir_error_string.restype = ctypes.c_char_p
        lib.gru_bidir_error_string.argtypes = [ctypes.c_int]
    return lib


def gru_bidir_layer(x, wif, wib, bif, bib, whf, whb, bhf, bhb, lengths):
    """One bidirectional GRU layer.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises.  ``gru_bidir_layer.launches``
    counts kernel launches."""
    weights = (wif, wib, bif, bib, whf, whb, bhf, bhb)
    if x.device.type == "cpu":
        return gru_bidir_layer_ref(x, *weights, lengths)
    if x.device.type != "cuda":
        raise ValueError(f"gru_bidir_layer: no kernel for device {x.device}")
    t_len, b, w_in, h = _check(x, weights, lengths)
    lib = _library()
    ysf = torch.empty((t_len, b, h), dtype=x.dtype, device=x.device)
    ysb = torch.empty_like(ysf)
    xg = torch.empty((2, t_len * b, 3 * h), dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gru_bidir_fwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(),
            *(w.data_ptr() for w in weights), lengths.data_ptr(),
            ysf.data_ptr(), ysb.data_ptr(), xg.data_ptr(),
            t_len, b, w_in, h, stream)
    if err != 0:
        msg = lib.gru_bidir_error_string(err).decode()
        raise RuntimeError(f"gru_bidir_fwd launch failed: {msg} ({err})")
    gru_bidir_layer.launches += 1
    return ysf, ysb


gru_bidir_layer.launches = 0
