"""MS-TCN's temporal convolutions: the dilated residual layer and the whole
stage, the hand-written Hopper kernels (``csrc/conv_layer_fwd.cu``,
``csrc/conv_layer_bwd.cu``, ``csrc/conv_stage_fwd.cu``), their plain
PyTorch versions, and the ``torch.autograd.Function`` that ties the
layer's forward to its backward.

Counterpart of ``pytorch_video_action_tpu/ops/conv.py`` (``init_conv1d``,
the 1x1 conv, ``dilated_residual_layer`` on its default tap path) together
with the call surface of ``ops/conv_pallas.py`` (``_kernel``, the layer;
``_stage_kernel``, the stage; ``_layer_bwd_kernel``, the layer's VJP).
Layouts are the JAX ones: weights ``w [K, Cin, Cout]``, ``b [Cout]``,
activations ``[B, T, C]``, the frame mask ``[B, T]`` or ``[B, T, 1]``.

The layer (reference ``networks.py:336-347``)::

    g   = x[t-d] @ w_d[0] + x[t] @ w_d[1] + x[t+d] @ w_d[2] + b_d
    out = relu(g) @ w_p[0] + b_p
    out = dropout(out)
    y   = (x + out) * mask

with 'same' zero padding: only rows outside ``[0, T)`` read as 0; padded
frames inside ``T`` are read as they are (they hold ``conv_in``'s bias).
``d >= T`` leaves the center tap alone.

Dropout is the fmix32 hash stream (``ops/hashmask.py``): ``keep =
fmix32(idx ^ fmix32(seed + GOLDEN)) < threshold(keep)``, kept values scaled
by ``1/keep``.  Two indexings, as in the JAX package:

* the *global* stream, one seed a layer, ``idx = b*T*C + t*C + c`` (uint32
  wrap): what the default XLA path draws (``conv.py:413-427``) and the
  fused backward regenerates; the model trains with it;
* the *per-video* stream, ``seeds[b]``, ``idx = t*C + c``: the TPU layer
  kernel's own form (``conv_pallas.py:105``) and the stage's, with seeds
  ``[B, L]``.

Numerics: products take f32 operands (a bf16 input converts exactly) and
accumulate in f32; relu, the 1x1 product, dropout, the residual and the
mask are f32; the layer rounds its output once to the input dtype.  The
stage carries the residual in f32 across its layers and rounds once at
the end (``conv_pallas.py:250,284``), so under bf16 it differs from a
chain of layers, which rounds after each.  The backward works in f32 from
the input-dtype tensors and returns ``dx`` in the input dtype and the
gradients in the weights' dtype.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as nnf

from . import hashmask

C = 64  # the feature maps the kernels take (MSTCNConfig.num_f_maps)
ROWS = 64  # frames per kernel tile

# ------------------------------------------------------------- parameters


class Conv1d(nn.Module):
    """A K-tap conv's parameters in the JAX layout: ``w [K, Cin, Cout]``,
    ``b [Cout]``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(kernel, in_ch, out_ch))
        self.b = nn.Parameter(torch.empty(out_ch))
        k = 1.0 / math.sqrt(in_ch * kernel)
        with torch.no_grad():
            self.w.uniform_(-k, k, generator=generator)
            self.b.uniform_(-k, k, generator=generator)


def init_conv1d(in_ch: int, out_ch: int, kernel: int,
                generator: torch.Generator | None = None) -> Conv1d:
    """``U(-1/sqrt(Cin*K), 1/sqrt(Cin*K))`` for ``w`` and ``b``, like
    ``torch.nn.Conv1d``'s defaults (``conv.py:69-76``)."""
    return Conv1d(in_ch, out_ch, kernel, generator)


def conv1x1(p, x: torch.Tensor) -> torch.Tensor:
    """A K=1 conv: ``x @ w[0] + b`` (``conv.py:272-273``)."""
    return torch.matmul(x, p.w[0]) + p.b


# --------------------------------------------------------- plain versions


def _acc(dtype):
    """Accumulation dtype: f32 for f32 and bf16 inputs (float64 stays)."""
    return torch.promote_types(dtype, torch.float32)


def _shift_right(a, d):
    """``out[:, t] = a[:, t - d]``, zero before the start."""
    return nnf.pad(a[:, :a.shape[1] - d], (0, 0, d, 0))


def _shift_left(a, d):
    """``out[:, t] = a[:, t + d]``, zero past the end."""
    return nnf.pad(a[:, d:], (0, 0, 0, d))


def _taps(w_d, b_d, x, d):
    """The 3-tap 'same' dilated conv; the center tap alone for ``d >= T``
    (``conv.py:93-99``)."""
    if d >= x.shape[1]:
        return torch.matmul(x, w_d[1]) + b_d
    return (torch.matmul(_shift_right(x, d), w_d[0]) + torch.matmul(x, w_d[1])
            + torch.matmul(_shift_left(x, d), w_d[2]) + b_d)


def _mask3(mask, b, t, dtype):
    return mask.reshape(b, t, 1).to(dtype)


def keep_bits(shape, keep: float, seed=None, seeds=None, device=None):
    """The layer's ``[B, T, C]`` keep-mask: the global stream of ``seed``,
    or the per-video stream of ``seeds[b]``."""
    b, t, c = shape
    thresh = hashmask.threshold(keep)
    if seeds is not None:
        return torch.stack([hashmask.keep_mask(int(s), (t, c), thresh,
                                               device=device)
                            for s in _seed_list(seeds)])
    if seed is None:
        raise ValueError("conv: dropout needs a seed or per-video seeds")
    return hashmask.keep_mask(seed, shape, thresh, device=device)


def _seed_list(seeds) -> list[int]:
    if isinstance(seeds, torch.Tensor):
        seeds = seeds.cpu().numpy()
    return [int(s) & 0xFFFFFFFF for s in np.asarray(seeds).reshape(-1)]


def layer_ref(w_d, b_d, w_p, b_p, x, mask, dilation: int, keep: float = 1.0,
              seed=None, seeds=None):
    """Plain version of the layer (``conv.py::dilated_residual_layer`` on
    its tap path, with ``seed``; ``conv_pallas.hash_dropout_reference``
    with per-video ``seeds [B]``).  ``keep < 1`` needs one of the two."""
    b, t, _ = x.shape
    acc = _acc(x.dtype)
    xa = x.to(acc)
    out = torch.relu(_taps(w_d.to(acc), b_d.to(acc), xa, dilation))
    out = torch.matmul(out, w_p[0].to(acc)) + b_p.to(acc)
    if keep < 1.0:
        km = keep_bits(out.shape, keep, seed, seeds, x.device)
        out = torch.where(km, out * (1.0 / keep), torch.zeros((), dtype=acc,
                                                              device=x.device))
    return ((xa + out) * _mask3(mask, b, t, acc)).to(x.dtype)


def layer_bwd_ref(w_d, b_d, w_p, x, mask, dy, dilation: int,
                  keep: float = 1.0, seed=None, seeds=None):
    """Plain version of the layer's VJP with the global stream of ``seed``
    (``conv_pallas.py::_layer_bwd_call``) or the per-video stream of
    ``seeds [B]`` (the VJP of ``conv_pallas.py::_fused``): recomputes ``g``
    from ``x`` and returns ``(dx, dw_d [3, C, C], db_d, dw_p [1, C, C],
    db_p)``."""
    b, t, _ = x.shape
    acc = _acc(x.dtype)
    xa, wd, wp = x.to(acc), w_d.to(acc), w_p[0].to(acc)
    g = _taps(wd, b_d.to(acc), xa, dilation)
    h = torch.relu(g)
    dym = dy.to(acc) * _mask3(mask, b, t, acc)
    dout = dym
    if keep < 1.0:
        km = keep_bits(dym.shape, keep, seed, seeds, x.device)
        dout = torch.where(km, dym * (1.0 / keep),
                           torch.zeros((), dtype=acc, device=x.device))
    dw_p = torch.einsum("btc,bte->ce", h, dout)
    db_p = dout.sum(dim=(0, 1))
    dg = torch.where(g > 0, torch.matmul(dout, wp.t()),
                     torch.zeros((), dtype=acc, device=x.device))
    db_d = dg.sum(dim=(0, 1))
    dx = dym + torch.matmul(dg, wd[1].t())
    dw1 = torch.einsum("btc,bte->ce", xa, dg)
    if dilation < t:
        dw0 = torch.einsum("btc,bte->ce", _shift_right(xa, dilation), dg)
        dw2 = torch.einsum("btc,bte->ce", _shift_left(xa, dilation), dg)
        dx = (dx + torch.matmul(_shift_left(dg, dilation), wd[0].t())
              + torch.matmul(_shift_right(dg, dilation), wd[2].t()))
    else:
        dw0 = dw2 = torch.zeros_like(dw1)
    return (dx.to(x.dtype), torch.stack([dw0, dw1, dw2]).to(w_d.dtype),
            db_d.to(b_d.dtype), dw_p[None].to(w_p.dtype), db_p.to(w_p.dtype))


def stage_dilations(n_layers: int, t: int) -> list[int]:
    """Layer i's dilation ``min(2**i, T)`` (``conv_pallas.py:385``)."""
    return [min(2 ** i, t) for i in range(n_layers)]


def stage_ref(w_d, b_d, w_p, b_p, x, mask, keep: float = 1.0, seeds=None):
    """Plain version of the stage (``conv_pallas.py::_stage_xla``): all
    ``L`` layers, ``w_d [L, 3, C, C]``, ``b_d [L, C]``, ``w_p [L, C, C]``,
    ``b_p [L, C]``, per-video dropout seeds ``[B, L]`` when ``keep < 1``;
    the residual carried in f32, rounded once at the end."""
    h = x.to(_acc(x.dtype))
    seeds = None if seeds is None else np.asarray(_seed_list(seeds)).reshape(
        x.shape[0], -1)
    for i, d in enumerate(stage_dilations(w_d.shape[0], x.shape[1])):
        h = layer_ref(w_d[i], b_d[i], w_p[i][None], b_p[i], h, mask, d, keep,
                      seeds=None if seeds is None else seeds[:, i])
    return h.to(x.dtype)


# ----------------------------------------------------------------- kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_ARGTYPES = {
    # dtype; x, mask, w_d, b_d, w_p, b_p, seeds, y; B, T, d; key, thresh;
    # scale; mode; stream
    "conv_layer_fwd": [_I] + [_P] * 8 + [_I] * 3 + [_U] * 2
                      + [ctypes.c_float, _I, _P],
    # dtype; x, mask, dy, w_d, b_d, w_p, seeds, dg, part, dx, grads;
    # blocks; B, T, d; key, thresh; scale; dropout; stream
    "conv_layer_bwd": [_I] + [_P] * 11 + [_I] * 4 + [_U] * 2
                      + [ctypes.c_float, _I, _P],
    # dtype; x, mask, w_d, b_d, w_p, b_p, seeds, buf, y; B, T, L; thresh;
    # scale; dropout; stream
    "conv_stage_fwd": [_I] + [_P] * 9 + [_I] * 3 + [_U]
                      + [ctypes.c_float, _I, _P],
}
# the partials a backward block writes: dw0, dw1, dw2, dw_p, db_d, db_p
GRAD_FLOATS = 4 * C * C + 2 * C


def _kernel(name):
    """``(entry point, error-string function)`` of ``name``'s library."""
    from . import cuda_lib

    lib = cuda_lib.load(name)
    fn = getattr(lib, name)
    err = getattr(lib, f"{name}_error_string")
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = _ARGTYPES[name]
        err.restype = ctypes.c_char_p
        err.argtypes = [_I]
    return fn, err


def _launch(name, x, *args):
    fn, err_string = _kernel(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{err_string(err).decode()} ({err})")


def _no_kernel(where, x):
    return ValueError(f"{where}: no kernel for device {x.device}")


def _check(where, x, tensors):
    """What the kernels take; raises on anything else.  ``tensors`` holds
    ``(name, tensor, shape)`` of the inputs in ``x``'s dtype."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{where}: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if x.dim() != 3 or x.shape[2] != C:
        raise ValueError(f"{where}: x must be [B, T, {C}], got "
                         f"{tuple(x.shape)}")
    b, t, _ = x.shape
    if b < 1 or t < 1:
        raise ValueError(f"{where}: empty input")
    for name, a, shape in [("x", x, x.shape), *tensors]:
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{where}: {name} has shape {tuple(a.shape)}, "
                             f"expected {tuple(shape)}")
        if a.dtype != x.dtype:
            raise TypeError(f"{where}: {name} is {a.dtype}, expected "
                            f"{x.dtype}")
        if a.device != x.device:
            raise ValueError(f"{where}: all tensors must be on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{where}: tensors must be contiguous")
    return b, t


def _mask_f32(where, mask, b, t, device):
    """The frame mask as the kernels read it: contiguous f32 ``[B, T]``."""
    if mask.numel() != b * t or mask.device != device:
        raise ValueError(f"{where}: mask must be [B, T] or [B, T, 1] on "
                         f"{device}")
    return mask.reshape(b, t).to(torch.float32).contiguous()


def _seed_tensor(seeds, n, device):
    """uint32 seeds as the int32 bit patterns the kernels read."""
    vals = _seed_list(seeds)
    if len(vals) != n:
        raise ValueError(f"conv: expected {n} per-video seeds, got {len(vals)}")
    return torch.from_numpy(np.asarray(vals, np.uint32).view(np.int32)).to(
        device)


def _layer_weights(w_d, b_d, w_p, b_p=None):
    out = [("w_d", w_d, (3, C, C)), ("b_d", b_d, (C,)),
           ("w_p", w_p, (1, C, C))]
    return out if b_p is None else out + [("b_p", b_p, (C,))]


def dilated_residual_layer(w_d, b_d, w_p, b_p, x, mask, dilation: int,
                           keep: float = 1.0, seed=None, seeds=None):
    """The layer kernel's wrapper (TPU ``conv_pallas.py:86 _kernel``): eval
    form (``keep`` 1), global stream (``seed``) or per-video stream
    (``seeds [B]``).  A CPU tensor takes :func:`layer_ref`; a CUDA tensor
    launches the kernel or raises.  ``launches`` counts launches."""
    if x.device.type == "cpu":
        return layer_ref(w_d, b_d, w_p, b_p, x, mask, dilation, keep, seed,
                         seeds)
    if x.device.type != "cuda":
        raise _no_kernel("dilated_residual_layer", x)
    b, t = _check("dilated_residual_layer", x,
                  _layer_weights(w_d, b_d, w_p, b_p))
    maskf = _mask_f32("dilated_residual_layer", mask, b, t, x.device)
    mode, key, thresh, scale, seed_t = 0, 0, 0, 1.0, None
    if keep < 1.0:
        thresh, scale = hashmask.threshold(keep), 1.0 / keep
        if seeds is not None:
            mode, seed_t = 2, _seed_tensor(seeds, b, x.device)
        elif seed is not None:
            mode, key = 1, hashmask.stream_key(seed)
        else:
            raise ValueError("dilated_residual_layer: dropout needs a seed "
                             "or per-video seeds")
    y = torch.empty_like(x)
    _launch("conv_layer_fwd", x, _DTYPE_CODE[x.dtype], x.data_ptr(),
            maskf.data_ptr(), w_d.data_ptr(), b_d.data_ptr(), w_p.data_ptr(),
            b_p.data_ptr(), 0 if seed_t is None else seed_t.data_ptr(),
            y.data_ptr(), b, t, min(int(dilation), t), key, thresh, scale,
            mode)
    dilated_residual_layer.launches += 1
    return y


dilated_residual_layer.launches = 0


def bwd_blocks(b: int, t: int, sms: int) -> int:
    """Blocks of the backward's first kernel: one a tile, at most one an SM
    (each walks its tiles ``j, j + blocks, ...`` and writes one set of
    weight-gradient partials)."""
    return max(1, min(b * math.ceil(t / ROWS), sms))


def dilated_residual_layer_bwd(w_d, b_d, w_p, x, mask, dy, dilation: int,
                               keep: float = 1.0, seed=None, seeds=None):
    """The layer VJP kernel's wrapper (TPU ``conv_pallas.py:415
    _layer_bwd_kernel``), global stream (``seed``) or per-video stream
    (``seeds [B]``): ``(dx, dw_d, db_d, dw_p, db_p)``.  A CPU tensor takes
    :func:`layer_bwd_ref`; a CUDA tensor launches the kernels (``dg`` and
    per-block partials, their fixed-order sum, then ``dx``) or raises.
    ``launches`` counts launches."""
    if x.device.type == "cpu":
        return layer_bwd_ref(w_d, b_d, w_p, x, mask, dy, dilation, keep, seed,
                             seeds)
    if x.device.type != "cuda":
        raise _no_kernel("dilated_residual_layer_bwd", x)
    b, t = _check("dilated_residual_layer_bwd", x,
                  [("dy", dy, x.shape), *_layer_weights(w_d, b_d, w_p)])
    maskf = _mask_f32("dilated_residual_layer_bwd", mask, b, t, x.device)
    key, thresh, scale, on, seed_t = 0, 0, 1.0, 0, None
    if keep < 1.0:
        thresh, scale = hashmask.threshold(keep), 1.0 / keep
        if seeds is not None:
            on, seed_t = 2, _seed_tensor(seeds, b, x.device)
        elif seed is not None:
            on, key = 1, hashmask.stream_key(seed)
        else:
            raise ValueError("dilated_residual_layer_bwd: dropout needs a "
                             "seed or per-video seeds")
    blocks = bwd_blocks(b, t, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    f32 = dict(dtype=torch.float32, device=x.device)
    dg = torch.empty((b, t, C), **f32)
    part = torch.empty((blocks, GRAD_FLOATS), **f32)
    grads = torch.empty((GRAD_FLOATS,), **f32)
    dx = torch.empty_like(x)
    _launch("conv_layer_bwd", x, _DTYPE_CODE[x.dtype], x.data_ptr(),
            maskf.data_ptr(), dy.data_ptr(), w_d.data_ptr(), b_d.data_ptr(),
            w_p.data_ptr(), 0 if seed_t is None else seed_t.data_ptr(),
            dg.data_ptr(), part.data_ptr(), dx.data_ptr(),
            grads.data_ptr(), blocks, b, t, min(int(dilation), t), key,
            thresh, scale, on)
    dilated_residual_layer_bwd.launches += 1
    n = C * C
    return (dx, grads[:3 * n].view(3, C, C).to(w_d.dtype),
            grads[4 * n:4 * n + C].to(b_d.dtype),
            grads[3 * n:4 * n].view(1, C, C).to(w_p.dtype),
            grads[4 * n + C:].to(w_p.dtype))


dilated_residual_layer_bwd.launches = 0


def fused_stage(w_d, b_d, w_p, b_p, x, mask, keep: float = 1.0, seeds=None):
    """The stage kernel's wrapper (TPU ``conv_pallas.py:248 _stage_kernel``):
    all ``L`` layers of one stage in one cooperative launch, stacked weights
    as :func:`stage_ref` takes them, per-video seeds ``[B, L]`` when ``keep
    < 1``.  A CPU tensor takes :func:`stage_ref`; a CUDA tensor launches
    the kernel or raises (there is no size cap and no per-layer fallback).
    ``launches`` counts launches."""
    if x.device.type == "cpu":
        return stage_ref(w_d, b_d, w_p, b_p, x, mask, keep, seeds)
    if x.device.type != "cuda":
        raise _no_kernel("fused_stage", x)
    n_layers = w_d.shape[0]
    b, t = _check("fused_stage", x, [
        ("w_d", w_d, (n_layers, 3, C, C)), ("b_d", b_d, (n_layers, C)),
        ("w_p", w_p, (n_layers, C, C)), ("b_p", b_p, (n_layers, C))])
    if n_layers < 1:
        raise ValueError("fused_stage: no layers")
    maskf = _mask_f32("fused_stage", mask, b, t, x.device)
    thresh, scale, on, seed_t = 0, 1.0, 0, None
    if keep < 1.0:
        if seeds is None:
            raise ValueError("fused_stage: dropout needs per-video seeds "
                             "[B, L]")
        thresh, scale, on = hashmask.threshold(keep), 1.0 / keep, 1
        seed_t = _seed_tensor(seeds, b * n_layers, x.device)
    buf = torch.empty((2 if n_layers > 1 else 1, b, t, C),
                      dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    _launch("conv_stage_fwd", x, _DTYPE_CODE[x.dtype], x.data_ptr(),
            maskf.data_ptr(), w_d.data_ptr(), b_d.data_ptr(), w_p.data_ptr(),
            b_p.data_ptr(), 0 if seed_t is None else seed_t.data_ptr(),
            buf.data_ptr(), y.data_ptr(), b, t, n_layers, thresh, scale, on)
    fused_stage.launches += 1
    return y


fused_stage.launches = 0


class DilatedResidualFn(torch.autograd.Function):
    """The layer's train form, backward through
    :func:`dilated_residual_layer_bwd`: with the global stream of ``seed``
    the counterpart of ``conv.py::_layer_train_fused``'s ``custom_vjp``,
    with the per-video stream of ``seeds [B]`` that of
    ``conv_pallas.py::_fused``'s (the JAX package's ``use_pallas``).  Saves
    ``x``, the weights and the mask; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, w_d, b_d, w_p, b_p, x, mask, dilation, keep, seed,
                seeds=None):
        y = dilated_residual_layer(w_d, b_d, w_p, b_p, x, mask, dilation,
                                   keep, seed, seeds)
        ctx.save_for_backward(w_d, b_d, w_p, x, mask)
        ctx.dilation, ctx.keep, ctx.seed, ctx.seeds = (dilation, keep, seed,
                                                       seeds)
        return y

    @staticmethod
    def backward(ctx, dy):
        w_d, b_d, w_p, x, mask = ctx.saved_tensors
        dx, dw_d, db_d, dw_p, db_p = dilated_residual_layer_bwd(
            w_d, b_d, w_p, x, mask, dy.contiguous(), ctx.dilation, ctx.keep,
            ctx.seed, ctx.seeds)
        return dw_d, db_d, dw_p, db_p, dx, None, None, None, None, None
