"""The LSTM scan: the hand-written Hopper kernels (``csrc/lstm_scan_fwd.cu``,
``csrc/lstm_scan_bwd.cu``), their plain PyTorch versions, and the
``torch.autograd.Function`` that ties the training forward to its
backward.

Counterpart of the LSTM half of ``pytorch_video_action_tpu/ops/
rnn_pallas.py``: ``_lstm_fwd_kernel`` (the eval form),
``_lstm_fwd_save_kernel`` (the training forward, which also saves the
gates), ``_lstm_bwd_saved_kernel`` (the VJP from the saved gates) and
``_lstm_bwd_kernel`` (the VJP that recomputes them, ``PVA_RNN_RECOMPUTE=1``),
tied together by ``lstm_scan_pallas``'s ``custom_vjp`` and called through
``lstm_scan``.

Layouts: ``xg [T, B, 4W]`` time-major, the input projection with both
biases folded in, gates i, f, g, o; ``wh [W, 4W]``.  Per step, in f32:
``a = xg[t] + h @ wh``, ``c' = f c + i g``, ``h' = o tanh(c')``, from
``h = c = 0``.  The scan runs the raw recurrence with no carry freeze: the
masks are prefix-form, so padded steps can only touch the carry after
every valid output, and :func:`lstm_scan` masks the outputs.  On valid
frames that equals the JAX package's XLA scan, which freezes the carry.

Numerics (``rnn_pallas.py:430-463``): ``h`` is rounded to ``wh``'s dtype
before the hidden product, products accumulate in f32, ``c`` is carried in
f32; ``ys``, ``cs`` and the residuals ``[i, f, g, o, tanh c]`` are stored
in ``xg``'s dtype.  The backward (``:546-600``) carries ``dh`` and ``dc``
in f32, rounds the gate gradients to ``wh``'s dtype for the carry product
and ``dwh`` and to ``xg``'s dtype for ``dxg``, and sums ``dwh`` in f32.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .rnn_fused import _acc, _check_tensors, _DTYPE_CODE, _no_kernel

# the recompute backward (row 16) instead of the saved-gates one, read as
# JAX reads ``rnn_pallas._RECOMPUTE_BWD``; assign the module global to flip
RECOMPUTE_BWD: bool = os.environ.get("PVA_RNN_RECOMPUTE") == "1"

_GATES = 4
_RES = 5


def cluster_size(w: int) -> int:
    """Blocks a chain's cluster spreads ``W`` hidden units over: about 16
    units a block, a power of two, at most 16 and at most ``W``."""
    n = 1
    while n < 16 and n * 16 < w and 2 * n <= w:
        n *= 2
    return n


# ------------------------------------------------------------ plain versions


def _gates(pre, w):
    return (torch.sigmoid(pre[..., :w]), torch.sigmoid(pre[..., w:2 * w]),
            torch.tanh(pre[..., 2 * w:3 * w]), torch.sigmoid(pre[..., 3 * w:]))


def lstm_scan_ref(xg, wh, save=False):
    """Plain PyTorch version of the forward: ``(ys, cs)``, and with
    ``save`` also the residuals ``res [T, B, 5W]``."""
    t_len, b, _ = xg.shape
    w = wh.shape[0]
    dt, acc = xg.dtype, _acc(xg.dtype)
    whf = wh.to(acc)
    h = torch.zeros(b, w, dtype=acc, device=xg.device)
    c = torch.zeros_like(h)
    ys = torch.empty(t_len, b, w, dtype=dt, device=xg.device)
    cs = torch.empty_like(ys)
    res = (torch.empty(t_len, b, _RES * w, dtype=dt, device=xg.device)
           if save else None)
    for t in range(t_len):
        pre = xg[t].to(acc) + torch.matmul(h.to(wh.dtype).to(acc), whf)
        i, f, g, o = _gates(pre, w)
        c = f * c + i * g
        tc = torch.tanh(c)
        h = o * tc
        ys[t] = h.to(dt)
        cs[t] = c.to(dt)
        if save:
            res[t] = torch.cat([i, f, g, o, tc], dim=-1).to(dt)
    return (ys, cs, res) if save else (ys, cs)


def _bwd_chain(gate_fn, hp, cp, dy, wh, dxg_dtype):
    """The backward chain over ``t = T-1 .. 0`` and ``dwh``, from
    ``gate_fn(t) -> (i, f, g, o, tanh c)`` in the accumulation dtype."""
    t_len, b, w = dy.shape
    acc = _acc(dxg_dtype)
    wdt = wh.dtype
    wh_t = wh.to(acc).t()
    dg = torch.empty(t_len, b, _GATES * w, dtype=acc, device=dy.device)
    dh_c = torch.zeros(b, w, dtype=acc, device=dy.device)
    dc_c = torch.zeros_like(dh_c)
    for t in range(t_len - 1, -1, -1):
        i, f, g, o, tc = gate_fn(t)
        dh = dy[t].to(acc) + dh_c
        do = dh * tc
        dc = dh * o * (1.0 - tc * tc) + dc_c
        gates = torch.cat([dc * g * i * (1.0 - i),
                           dc * cp[t].to(acc) * f * (1.0 - f),
                           dc * i * (1.0 - g * g),
                           do * o * (1.0 - o)], dim=-1)
        dg[t] = gates
        dh_c = torch.matmul(gates.to(wdt).to(acc), wh_t)
        dc_c = dc * f
    m = t_len * b
    dwh = torch.matmul(hp.reshape(m, w).to(wdt).to(acc).t(),
                       dg.reshape(m, _GATES * w).to(wdt).to(acc))
    return dg.to(dxg_dtype), dwh.to(wdt)


def lstm_scan_bwd_saved_ref(res, hp, cp, dy, wh):
    """Plain PyTorch version of the saved-gates backward: ``(dxg, dwh)``
    from the residuals and ``hp``, ``cp``, ``ys`` and ``cs`` one step
    earlier (0 at ``t = 0``)."""
    w = wh.shape[0]
    acc = _acc(res.dtype)

    def gate_fn(t):
        r = res[t].to(acc)
        return tuple(r[..., q * w:(q + 1) * w] for q in range(_RES))

    return _bwd_chain(gate_fn, hp, cp, dy, wh, res.dtype)


def lstm_scan_bwd_ref(xg, hp, cp, cs, dy, wh):
    """Plain PyTorch version of the recompute backward: the gates again
    from ``xg[t] + hp[t] @ wh`` and ``tanh c`` from ``cs[t]``."""
    w = wh.shape[0]
    acc = _acc(xg.dtype)
    whf = wh.to(acc)

    def gate_fn(t):
        pre = xg[t].to(acc) + torch.matmul(hp[t].to(acc), whf)
        return (*_gates(pre, w), torch.tanh(cs[t].to(acc)))

    return _bwd_chain(gate_fn, hp, cp, dy, wh, xg.dtype)


# ------------------------------------------------------------------ kernels

_ARGTYPES = {
    # dtype; xg, wh, ys, cs, res; T, B, W, save, cluster; stream
    "lstm_scan_fwd": ([ctypes.c_int] + [ctypes.c_void_p] * 5
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    # dtype, recompute; xg or res, hp, cp, cs, dy, wh, wh^T, dxg, dwh;
    # T, B, W, cluster; stream
    "lstm_scan_bwd": ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
}


def _launch(name, x, *args):
    """Call one library's entry point on ``x``'s device and current stream;
    raise when the launch was refused."""
    from . import cuda_lib

    lib = cuda_lib.load(name)
    fn = getattr(lib, name)
    err_string = getattr(lib, f"{name}_error_string")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        err_string.restype = ctypes.c_char_p
        err_string.argtypes = [ctypes.c_int]
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{err_string(err).decode()} ({err})")


def _check(where, xg, wh, named, width):
    """Shapes, dtypes, one device and contiguity of the kernels' operands:
    ``xg`` (or ``res``) ``[T, B, width*W]`` with ``wh [W, 4W]`` of its
    dtype, and ``named`` further ``[T, B, W]`` tensors."""
    if xg.dtype not in _DTYPE_CODE:
        raise TypeError(f"{where}: dtype {xg.dtype} not supported "
                        "(float32 or bfloat16)")
    if xg.dim() != 3 or wh.dim() != 2:
        raise ValueError(f"{where}: expected [T, B, {width}W] and [W, 4W], "
                         f"got {tuple(xg.shape)} and {tuple(wh.shape)}")
    t_len, b, _ = xg.shape
    w = wh.shape[0]
    expect = [("xg", (t_len, b, width * w), 1), ("wh", (w, _GATES * w), 1)]
    expect += [(n, (t_len, b, w), 1) for n, _ in named]
    _check_tensors(where, xg.dtype, expect,
                   (xg, wh, *(t for _, t in named)))
    if t_len < 1 or b < 1:
        raise ValueError(f"{where}: empty sequence")
    return t_len, b, w


def _fwd(xg, wh, save):
    t_len, b, w = _check("lstm_scan_fwd", xg, wh, (), _GATES)
    ys = torch.empty((t_len, b, w), dtype=xg.dtype, device=xg.device)
    cs = torch.empty_like(ys)
    res = (torch.empty((t_len, b, _RES * w), dtype=xg.dtype, device=xg.device)
           if save else None)
    _launch("lstm_scan_fwd", xg, _DTYPE_CODE[xg.dtype], xg.data_ptr(),
            wh.data_ptr(), ys.data_ptr(), cs.data_ptr(),
            0 if res is None else res.data_ptr(), t_len, b, w, int(save),
            cluster_size(w))
    return (ys, cs, res) if save else (ys, cs)


def lstm_scan_fwd(xg, wh):
    """Row 13, the eval form's wrapper: ``(ys, cs)``.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises.
    ``launches`` counts launches."""
    if xg.device.type == "cpu":
        return lstm_scan_ref(xg, wh)
    if xg.device.type != "cuda":
        raise _no_kernel("lstm_scan_fwd", xg)
    out = _fwd(xg, wh, False)
    lstm_scan_fwd.launches += 1
    return out


lstm_scan_fwd.launches = 0


def lstm_scan_fwd_save(xg, wh):
    """Row 14, the training forward's wrapper: ``(ys, cs, res)``; as
    :func:`lstm_scan_fwd`."""
    if xg.device.type == "cpu":
        return lstm_scan_ref(xg, wh, save=True)
    if xg.device.type != "cuda":
        raise _no_kernel("lstm_scan_fwd_save", xg)
    out = _fwd(xg, wh, True)
    lstm_scan_fwd_save.launches += 1
    return out


lstm_scan_fwd_save.launches = 0


def _bwd(where, first, width, hp, cp, cs, dy, wh, recompute):
    named = [("hp", hp), ("cp", cp), ("dy", dy)]
    if cs is not None:
        named.append(("cs", cs))
    t_len, b, w = _check(where, first, wh, named, width)
    dxg = torch.empty((t_len, b, _GATES * w), dtype=first.dtype,
                      device=first.device)
    dwh = torch.empty_like(wh)
    wh_t = wh.t().contiguous()  # [4W, W]: the carry product's operand
    _launch("lstm_scan_bwd", first, _DTYPE_CODE[first.dtype], int(recompute),
            first.data_ptr(), hp.data_ptr(), cp.data_ptr(),
            0 if cs is None else cs.data_ptr(), dy.data_ptr(), wh.data_ptr(),
            wh_t.data_ptr(), dxg.data_ptr(), dwh.data_ptr(), t_len, b, w,
            cluster_size(w))
    return dxg, dwh


def lstm_scan_bwd_saved(res, hp, cp, dy, wh):
    """Row 15, the saved-gates backward's wrapper: ``(dxg, dwh)``.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises.  ``launches`` counts launches."""
    if res.device.type == "cpu":
        return lstm_scan_bwd_saved_ref(res, hp, cp, dy, wh)
    if res.device.type != "cuda":
        raise _no_kernel("lstm_scan_bwd_saved", res)
    out = _bwd("lstm_scan_bwd_saved", res, _RES, hp, cp, None, dy, wh, False)
    lstm_scan_bwd_saved.launches += 1
    return out


lstm_scan_bwd_saved.launches = 0


def lstm_scan_bwd(xg, hp, cp, cs, dy, wh):
    """Row 16, the recompute backward's wrapper: ``(dxg, dwh)``; as
    :func:`lstm_scan_bwd_saved`."""
    if xg.device.type == "cpu":
        return lstm_scan_bwd_ref(xg, hp, cp, cs, dy, wh)
    if xg.device.type != "cuda":
        raise _no_kernel("lstm_scan_bwd", xg)
    out = _bwd("lstm_scan_bwd", xg, _GATES, hp, cp, cs, dy, wh, True)
    lstm_scan_bwd.launches += 1
    return out


lstm_scan_bwd.launches = 0


def _shift(seq):
    """``seq`` one step later: ``[0, seq[0], ..., seq[T-2]]``."""
    return torch.cat([torch.zeros_like(seq[:1]), seq[:-1]])


class LSTMScanFn(torch.autograd.Function):
    """The scan under autograd, ``xg, wh -> ys``: the counterpart of
    ``lstm_scan_pallas``'s ``custom_vjp``.  The forward saves the gates
    (row 14, backward row 15), or with :data:`RECOMPUTE_BWD` only ``ys``
    and ``cs`` (row 13, backward row 16)."""

    @staticmethod
    def forward(ctx, xg, wh):
        ctx.recompute = RECOMPUTE_BWD
        if ctx.recompute:
            ys, cs = lstm_scan_fwd(xg, wh)
            ctx.save_for_backward(xg, wh, ys, cs)
        else:
            ys, cs, res = lstm_scan_fwd_save(xg, wh)
            ctx.save_for_backward(res, wh, ys, cs)
        return ys

    @staticmethod
    def backward(ctx, dy):
        first, wh, ys, cs = ctx.saved_tensors
        hp, cp = _shift(ys), _shift(cs)
        dy = dy.contiguous()
        if ctx.recompute:
            return lstm_scan_bwd(first, hp, cp, cs, dy, wh)
        return lstm_scan_bwd_saved(first, hp, cp, dy, wh)


def lstm_scan(xg_tm, wh, mask_tm):
    """Masked ``ys [T, B, W]`` of the scan over ``xg_tm [T, B, 4W]``
    (``mask_tm [T, B, 1]``, prefix-form): the eval form when grad mode is
    off or nothing requires a gradient, else :class:`LSTMScanFn`.  Kernels
    on CUDA tensors, plain versions on CPU tensors; neither falls back to
    the other."""
    xg_tm = xg_tm.contiguous()
    if torch.is_grad_enabled() and (xg_tm.requires_grad or wh.requires_grad):
        ys = LSTMScanFn.apply(xg_tm, wh)
    else:
        ys, _ = lstm_scan_fwd(xg_tm, wh)
    return ys * mask_tm
