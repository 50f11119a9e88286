"""Exact self-attention in O(T * block) memory with a recompute backward:
the hand-written Hopper kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``), their plain PyTorch versions, and the
``torch.autograd.Function`` that ties the forward to its backward; and the
same on the head-major flat layout ``[B, T, H*d]`` (the ``bthd`` section
at the end, ``PVA_FLASH_BTHD=1``).

Counterpart of ``pytorch_video_action_tpu/ops/flash.py`` (the XLA scan,
``_flash_fwd_scan`` and ``_flash_vjp_bwd``) together with the call surface
of ``ops/flash_pallas.py`` (``flash_fwd_pallas``, ``flash_bwd_pallas`` with
its fused single-pass and two-kernel split backwards).  Layouts are the
JAX ones: ``q [B, H, T, d]`` pre-scaled by ``1/sqrt(d)``, ``k`` and ``v
[B, H, T_kv, d]``, ``key_mask [B, T_kv]`` bool (True = attendable), one
uint32 ``seed`` for the attention site.

Semantics:

* online softmax over KV blocks; ``out = dropout(softmax(q k^T masked)) v``
  and the per-row log-sum-exp ``lse = m + log l`` in f32;
* post-softmax dropout multiplies the softmax numerator only (``l`` is
  dropout-free).  Its keep-mask is the fmix32 hash of the element's global
  index ``((b*H + h)*T + q)*T_kv + k`` (uint32 wrap) xor the site's key
  ``hashmask.stream_key(seed)``, compared with ``threshold(keep)``: the
  same bits for any tiling, in the forward and in each backward, and the
  same stream the dense path draws with ``hashmask.hash_dropout`` over
  ``[B, H, T, T]``;
* masked scores are the finite ``NEG_INF = -1e30``: a row with no valid
  key sees ``exp(0)`` and is zeroed by its ``row_valid`` test (``-inf``
  would give NaN); it gives 0 out, 0 lse and 0 gradients;
* the backward rebuilds ``p = exp(s - lse)`` and applies the softmax
  Jacobian through ``delta = sum(dout * out)`` (f32): ``ds = p (g - delta)``
  with the undropped ``p``, the mask applied to ``p`` for ``dv`` and to
  ``g = dout v^T`` for ``ds``.

Numerics: the score and value products take the input dtype (f32 or bf16)
and accumulate in f32; ``m``, ``l``, ``acc``, ``lse``, ``delta`` and ``dq``
are f32.  The dropped ``p`` is rounded to ``v``'s dtype before ``p v`` and
``dv``, ``ds`` to ``q``'s before ``dq`` and ``dk``; ``out`` is stored in
``q``'s dtype, ``dq``, ``dk`` and ``dv`` in their inputs' dtypes.  Under
bf16 the operands stay bf16 and under f32 they stay f32: the TPU path's
``MXU_BF16`` demotion of f32 operands (``flash_pallas.py:77``) is not
copied, as the XLA path does not do it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import hashmask

NEG_INF = -1e30
DEFAULT_BLOCK = 64  # KV block of the plain versions' scan (flash.py:73)

# --------------------------------------------------------- plain versions


def _acc(dtype):
    """Accumulation dtype: f32 for f32 and bf16 inputs (float64 stays)."""
    return torch.promote_types(dtype, torch.float32)


def block_keep_mask(seed: int, col0: int, t_kv: int, keep: float, shape,
                    device=None) -> torch.Tensor:
    """Dropout keep-mask of the KV block ``[B, H, T, c]`` whose first column
    is ``col0`` (``flash.py::_block_keep_mask``): element ``(b, h, q, j)``
    draws the global index ``((b*H + h)*T + q)*t_kv + col0 + j`` mod 2**32.
    Padding columns (``col0 + j >= t_kv``) alias into the next row's
    indices; their probabilities are zeroed by the key mask."""
    b, h, t, c = (int(s) for s in shape)
    i64 = dict(dtype=torch.int64, device=device)
    bh = torch.arange(b * h, **i64).view(b, h, 1, 1)
    q = torch.arange(t, **i64).view(1, 1, t, 1)
    col = torch.arange(col0, col0 + c, **i64).view(1, 1, 1, c)
    # exact in int64 while B*H*T*T_kv < 2**63
    idx = ((bh * t + q) * t_kv + col) & 0xFFFFFFFF
    return (hashmask.fmix32(idx ^ hashmask.stream_key(seed))
            < hashmask.threshold(keep))


def _kv_blocks(t_kv: int, block: int):
    c = min(block, t_kv)
    return [(j, min(j + c, t_kv)) for j in range(0, t_kv, c)]


def _scores(q, k_c, mask_c, acc):
    s = torch.matmul(q.to(acc), k_c.to(acc).transpose(-1, -2))
    return torch.where(mask_c[:, None, None, :], s,
                       torch.full((), NEG_INF, dtype=acc, device=q.device))


def flash_fwd_ref(q, k, v, key_mask, rate: float = 0.0, seed=None,
                  block: int = DEFAULT_BLOCK):
    """Plain version of the forward: the online-softmax scan over KV blocks
    of ``block`` columns (``flash.py::_flash_fwd_scan``).  Returns ``out``
    (q's dtype), ``lse`` f32 and ``row_valid`` ``[B, H, T]``."""
    b, h, t, d = q.shape
    t_kv = k.shape[2]
    acc_t = _acc(q.dtype)
    drop = rate > 0.0
    if drop and seed is None:
        raise ValueError("flash_fwd_ref: dropout needs a seed")
    keep = 1.0 - rate
    m = torch.full((b, h, t), NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros((b, h, t), dtype=acc_t, device=q.device)
    acc = torch.zeros((b, h, t, d), dtype=acc_t, device=q.device)
    for j0, j1 in _kv_blocks(t_kv, block):
        s = _scores(q, k[:, :, j0:j1], key_mask[:, j0:j1], acc_t)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        if drop:
            km = block_keep_mask(seed, j0, t_kv, keep, p.shape, q.device)
            p = p * km / keep
        pv = torch.matmul(p.to(v.dtype).to(acc_t), v[:, :, j0:j1].to(acc_t))
        acc = acc * alpha[..., None] + pv
        m = m_new
    row_valid = m > NEG_INF / 2
    l_safe = torch.clamp(l, min=1e-30)
    out = torch.where(row_valid[..., None], acc / l_safe[..., None], 0.0)
    lse = torch.where(row_valid, m + torch.log(l_safe), 0.0)
    return out.to(q.dtype), lse.to(torch.float32), row_valid


def flash_bwd_ref(q, k, v, key_mask, rate, seed, out, lse, dout,
                  block: int = DEFAULT_BLOCK):
    """Plain version of the backward: the recompute over KV blocks of
    ``flash.py::_flash_vjp_bwd``.  Returns ``(dq, dk, dv)`` in the dtypes of
    ``q``, ``k`` and ``v``."""
    delta = (dout.to(_acc(q.dtype)) * out.to(_acc(q.dtype))).sum(dim=-1)
    dq, dk, dv = _bwd_ref(q, k, v, key_mask, rate, seed, lse, delta, dout,
                          block)
    return dq.to(q.dtype), dk, dv


def _bwd_ref(q, k, v, key_mask, rate, seed, lse, delta, dout,
             block: int = DEFAULT_BLOCK):
    """:func:`flash_bwd_ref` from ``delta = sum(dout * out)`` [B, H, T]:
    ``dq`` in the accumulation dtype (f32), ``dk`` and ``dv`` in the
    dtypes of ``k`` and ``v``."""
    t_kv = k.shape[2]
    acc_t = _acc(q.dtype)
    drop = rate > 0.0
    if drop and seed is None:
        raise ValueError("flash_bwd_ref: dropout needs a seed")
    keep = 1.0 - rate
    delta = delta.to(acc_t)
    row_valid = key_mask.any(dim=-1)[:, None, None].expand_as(delta)
    lse_safe = torch.where(row_valid, lse.to(acc_t), 0.0)
    rv = row_valid[..., None].to(acc_t)
    dq = torch.zeros(q.shape, dtype=acc_t, device=q.device)
    dks, dvs = [], []
    for j0, j1 in _kv_blocks(t_kv, block):
        k_c, v_c = k[:, :, j0:j1], v[:, :, j0:j1]
        s = _scores(q, k_c, key_mask[:, j0:j1], acc_t)
        p = torch.exp(s - lse_safe[..., None]) * rv
        g = torch.matmul(dout.to(acc_t), v_c.to(acc_t).transpose(-1, -2))
        if drop:
            km = block_keep_mask(seed, j0, t_kv, keep, p.shape,
                                 q.device).to(acc_t) / keep
            p_drop, g = p * km, g * km
        else:
            p_drop = p
        dvs.append(torch.matmul(
            p_drop.to(dout.dtype).to(acc_t).transpose(-1, -2),
            dout.to(acc_t)).to(v.dtype))
        ds = (p * (g - delta[..., None])).to(q.dtype).to(acc_t)
        dq = dq + torch.matmul(ds, k_c.to(acc_t))
        dks.append(torch.matmul(ds.transpose(-1, -2), q.to(acc_t)).to(k.dtype))
    return dq, torch.cat(dks, dim=2), torch.cat(dvs, dim=2)


# ----------------------------------------------------------------- kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
D_MAX = 512  # the widest head the kernels take (csrc/flash_common.cuh kDHead)
TILE = 64  # query and KV rows per tile
# The fused backward's partial-dq scratch ([chunks, B*H, T, d] f32) may be
# at most this large; a longer video takes the split, which needs none.
FUSED_SCRATCH_BYTES = 64 << 20

_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                 + [ctypes.c_uint] * 2 + [ctypes.c_float, ctypes.c_int])
_ARGTYPES = {
    # dtype; q, k, v, mask, out, lse; B*H, H, T, T_kv, d; key, thresh;
    # keep; dropout; stream
    "flash_fwd": ([ctypes.c_int] + [ctypes.c_void_p] * 6
                  + [ctypes.c_int] * 5 + [ctypes.c_uint] * 2
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    # dtype; q, k, v, mask, lse, delta, dout, dq, dk, dv; B*H, H, T, T_kv,
    # d; key, thresh; keep; dropout; stream
    "flash_bwd_dkdv": _BWD_ARGTYPES + [ctypes.c_void_p],
    "flash_bwd_dq": _BWD_ARGTYPES + [ctypes.c_void_p],
    # the same, then the partial-dq scratch and the chunk count
    "flash_bwd_fused": _BWD_ARGTYPES + [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p],
}
# the head-major forms take the same arguments
_ARGTYPES["flash_fwd_bthd"] = _ARGTYPES["flash_fwd"]
_ARGTYPES["flash_bwd_fused_bthd"] = _ARGTYPES["flash_bwd_fused"]
_LIBRARY = {"flash_fwd": "flash_fwd", "flash_bwd_dkdv": "flash_bwd",
            "flash_bwd_dq": "flash_bwd", "flash_bwd_fused": "flash_bwd",
            "flash_fwd_bthd": "flash_fwd",
            "flash_bwd_fused_bthd": "flash_bwd"}


def _kernel(name):
    """``(entry point, error-string function)`` of ``name``'s library."""
    from . import cuda_lib

    lib_name = _LIBRARY[name]
    lib = cuda_lib.load(lib_name)
    fn = getattr(lib, name)
    err = getattr(lib, f"{lib_name}_error_string")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
    return fn, err


def _launch(name, x, *args):
    fn, err_string = _kernel(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{err_string(err).decode()} ({err})")


def _check(where, q, k, v, key_mask, extra=()):
    """What the kernels take; raises on anything else.  ``extra`` holds
    ``(name, tensor, shape, dtype)`` of further inputs."""
    if q.dim() != 4:
        raise ValueError(f"{where}: q must be [B, H, T, d], got "
                         f"{tuple(q.shape)}")
    b, h, t, d = q.shape
    t_kv = k.shape[2] if k.dim() == 4 else -1
    _check_expect(where, q, d, t, t_kv, [
        ("q", q, (b, h, t, d), q.dtype), ("k", k, (b, h, t_kv, d), q.dtype),
        ("v", v, (b, h, t_kv, d), q.dtype),
        ("key_mask", key_mask, (b, t_kv), torch.bool), *extra])
    return b, h, t, t_kv, d


def _check_expect(where, q, d, t, t_kv, expect):
    """q's dtype and the head width, then each ``(name, tensor, shape,
    dtype)`` of ``expect``: its shape, dtype, device and contiguity."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{where}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if not 0 < d <= D_MAX:
        raise ValueError(f"{where}: head width {d} not in 1..{D_MAX}")
    for name, x, shape, dtype in expect:
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{where}: {name} has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{where}: {name} is {x.dtype}, expected {dtype}")
        if x.device != q.device:
            raise ValueError(f"{where}: all tensors must be on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{where}: tensors must be contiguous")
    if t < 1 or t_kv < 1:
        raise ValueError(f"{where}: empty sequence")


def _dropout_args(rate: float, seed):
    """``(key, thresh, keep, on)`` for the kernels."""
    if rate <= 0.0:
        return 0, 0, 1.0, 0
    if seed is None:
        raise ValueError("flash: dropout needs a seed")
    keep = 1.0 - rate
    return hashmask.stream_key(seed), hashmask.threshold(keep), keep, 1


def _no_kernel(where, x):
    return ValueError(f"{where}: no kernel for device {x.device}")


def flash_fwd(q, k, v, key_mask, rate: float = 0.0, seed=None):
    """The forward kernel's wrapper: ``(out, lse)``.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises.
    ``launches`` counts launches."""
    if q.device.type == "cpu":
        out, lse, _ = flash_fwd_ref(q, k, v, key_mask, rate, seed)
        return out, lse
    if q.device.type != "cuda":
        raise _no_kernel("flash_fwd", q)
    b, h, t, t_kv, d = _check("flash_fwd", q, k, v, key_mask)
    key, thresh, keep, on = _dropout_args(rate, seed)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), key_mask.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b * h, h, t, t_kv, d, key, thresh, keep, on)
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def fused_chunks(bh: int, t_kv: int, sms: int) -> int:
    """KV chunks a (b, h) of the fused backward is spread over: enough
    blocks to fill the SMs once (``sms // bh``), at least 1, at most one
    chunk a KV tile."""
    return max(1, min(math.ceil(t_kv / TILE), sms // bh))


def use_fused(bh: int, t: int, t_kv: int, d: int, sms: int) -> bool:
    """The backward's dispatch: the fused form (one recompute of ``s``,
    ``p`` and the mask per element) while its partial-dq scratch, ``chunks
    * B*H * T * d`` f32, stays within ``FUSED_SCRATCH_BYTES``; the split
    (which recomputes them twice but needs no scratch) for longer videos.
    With one chunk the kernel writes ``dq`` itself and needs none."""
    chunks = fused_chunks(bh, t_kv, sms)
    return chunks == 1 or chunks * bh * t * d * 4 <= FUSED_SCRATCH_BYTES


def _check_bwd(where, q, k, v, key_mask, lse, delta, dout):
    rows = q.shape[:3]
    return _check(where, q, k, v, key_mask,
                  [("dout", dout, q.shape, q.dtype),
                   ("lse", lse, rows, torch.float32),
                   ("delta", delta, rows, torch.float32)])


def _bwd_launch(name, q, k, v, key_mask, rate, seed, lse, delta, dout, dq,
                dk, dv, *extra):
    """Launch one backward entry point; absent outputs pass as NULL."""
    b, h, t, t_kv, d = _check_bwd(name, q, k, v, key_mask, lse, delta, dout)
    key, thresh, keep, on = _dropout_args(rate, seed)
    _launch(name, q, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), key_mask.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dout.data_ptr(), _ptr(dq), _ptr(dk), _ptr(dv),
            b * h, h, t, t_kv, d, key, thresh, keep, on, *extra)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_bwd_fused(q, k, v, key_mask, rate, seed, lse, delta, dout):
    """The fused backward's wrapper, from ``delta = sum(dout * out)`` [B, H,
    T] f32: ``(dq f32, dk, dv)``.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (over :func:`fused_chunks` chunks) or
    raises.  ``launches`` counts launches."""
    if q.device.type == "cpu":
        return _bwd_ref(q, k, v, key_mask, rate, seed, lse, delta, dout)
    if q.device.type != "cuda":
        raise _no_kernel("flash_bwd_fused", q)
    b, h, t, d = q.shape
    chunks = fused_chunks(b * h, k.shape[2], _sms(q.device))
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part = (torch.empty((chunks, b * h, t, d), dtype=torch.float32,
                        device=q.device) if chunks > 1 else None)
    _bwd_launch("flash_bwd_fused", q, k, v, key_mask, rate, seed, lse, delta,
                dout, dq, dk, dv, _ptr(part), chunks)
    flash_bwd_fused.launches += 1
    return dq, dk, dv


flash_bwd_fused.launches = 0


def flash_bwd_dkdv(q, k, v, key_mask, rate, seed, lse, delta, dout):
    """The split's dk/dv kernel's wrapper: ``(dk, dv)``.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises.
    ``launches`` counts launches."""
    if q.device.type == "cpu":
        return _bwd_ref(q, k, v, key_mask, rate, seed, lse, delta, dout)[1:]
    if q.device.type != "cuda":
        raise _no_kernel("flash_bwd_dkdv", q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_bwd_dkdv", q, k, v, key_mask, rate, seed, lse, delta,
                dout, None, dk, dv)
    flash_bwd_dkdv.launches += 1
    return dk, dv


flash_bwd_dkdv.launches = 0


def flash_bwd_dq(q, k, v, key_mask, rate, seed, lse, delta, dout):
    """The split's dq kernel's wrapper: ``dq`` f32.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises.
    ``launches`` counts launches."""
    if q.device.type == "cpu":
        return _bwd_ref(q, k, v, key_mask, rate, seed, lse, delta, dout)[0]
    if q.device.type != "cuda":
        raise _no_kernel("flash_bwd_dq", q)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _bwd_launch("flash_bwd_dq", q, k, v, key_mask, rate, seed, lse, delta,
                dout, dq, None, None)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd(q, k, v, key_mask, rate, seed, out, lse, dout, fused=None):
    """The backward: ``(dq, dk, dv)`` in the dtypes of ``q``, ``k``, ``v``.
    A CPU tensor takes the plain version; a CUDA tensor computes ``delta``
    and launches :func:`flash_bwd_fused` (``fused=True``) or
    :func:`flash_bwd_dkdv` and :func:`flash_bwd_dq` (``False``), by
    :func:`use_fused` when ``fused`` is None."""
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, key_mask, rate, seed, out, lse, dout)
    if q.device.type != "cuda":
        raise _no_kernel("flash_bwd", q)
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("flash_bwd: out must have q's shape and dtype")
    delta = (dout.float() * out.float()).sum(dim=-1)
    b, h, t, d = q.shape
    if fused is None:
        fused = use_fused(b * h, t, k.shape[2], d, _sms(q.device))
    args = (q, k, v, key_mask, rate, seed, lse, delta, dout)
    if fused:
        dq, dk, dv = flash_bwd_fused(*args)
    else:
        dk, dv = flash_bwd_dkdv(*args)
        dq = flash_bwd_dq(*args)
    return dq.to(q.dtype), dk, dv


class FlashAttnFn(torch.autograd.Function):
    """The forward kernel, backward through :func:`flash_bwd`: the
    counterpart of ``flash_self_attention``'s ``custom_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, rate, seed):
        out, lse = flash_fwd(q, k, v, key_mask, rate, seed)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.rate, ctx.seed = rate, seed
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, key_mask, ctx.rate, ctx.seed, out,
                               lse, dout.contiguous())
        return dq, dk, dv, None, None, None


def flash_self_attention(q, k, v, key_mask, rate: float = 0.0, seed=None):
    """``dropout(softmax(q k^T masked)) v`` for pre-scaled ``q [B, H, T,
    d]``: the kernels on CUDA tensors, the plain versions on CPU tensors,
    differentiable through :class:`FlashAttnFn`.  ``rate`` > 0 needs the
    site's uint32 ``seed``."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    key_mask = key_mask.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttnFn.apply(q, k, v, key_mask, rate, seed)
    return flash_fwd(q, k, v, key_mask, rate, seed)[0]


# ------------------------------------------------ head-major flat layout
#
# Counterpart of ``ops/flash.py::flash_self_attention_bthd`` (``flash_pallas``
# with ``bthd=True``): q, k and v ``[B, T, H*d]`` as they fall out of a
# packed projection, head h the column slab ``[h*d, (h+1)*d)``, so no
# ``[B, H, T, d]`` transpose is made.  ``lse`` is ``[B*H, T]``; the dropout
# stream is the ``[B, H, T, T_kv]`` global-index stream above, unchanged.
# The forward and the fused backward read the layout in place
# (``flash_fwd_bthd``, ``flash_bwd_fused_bthd``).  Where :func:`use_fused`
# picks the split backward, the operands are transposed to ``[B, H, T, d]``
# for :func:`flash_bwd_dkdv` and :func:`flash_bwd_dq` and the gradients
# back, as ``flash_pallas.py:594-610`` does.  JAX's callers pad d to a
# multiple of 128 (``models/attention.py``); the kernels take any d up to
# ``D_MAX``.


def _heads(a, num_heads):
    """``[B, T, H*d]`` -> ``[B, H, T, d]`` (a view)."""
    b, t, hd = a.shape
    return a.view(b, t, num_heads, hd // num_heads).transpose(1, 2)


def _heads_dense(num_heads, *arrays):
    """Each ``[B, T, H*d]`` array as a contiguous ``[B, H, T, d]`` copy.
    Every head-major plain path runs the ``[B, H, T, d]`` plain versions on
    these, so it does the same arithmetic as they do on contiguous inputs:
    a CPU matmul's kernel and summation order depend on the strides."""
    return tuple(_heads(a, num_heads).contiguous() for a in arrays)


def _flat(a):
    """``[B, H, T, d]`` -> ``[B, T, H*d]``."""
    b, h, t, d = a.shape
    return a.transpose(1, 2).reshape(b, t, h * d)


def flash_fwd_bthd_ref(q, k, v, key_mask, num_heads, rate=0.0, seed=None):
    """Plain version of the head-major forward: :func:`flash_fwd_ref` on
    the ``[B, H, T, d]`` copies.  Returns ``out [B, T, H*d]`` and ``lse
    [B*H, T]``."""
    out, lse, _ = flash_fwd_ref(*_heads_dense(num_heads, q, k, v), key_mask,
                                rate, seed)
    return _flat(out), lse.reshape(-1, q.shape[1])


def _bwd_bthd_ref(q, k, v, key_mask, num_heads, rate, seed, lse, delta,
                  dout):
    """:func:`_bwd_ref` on the ``[B, H, T, d]`` copies, from ``delta [B*H,
    T]``: ``(dq f32, dk, dv)``, each ``[B, T, H*d]``."""
    b, t = q.shape[:2]
    qh, kh, vh, douth = _heads_dense(num_heads, q, k, v, dout)
    grads = _bwd_ref(qh, kh, vh, key_mask, rate, seed,
                     lse.view(b, num_heads, t), delta.view(b, num_heads, t),
                     douth)
    return tuple(_flat(g) for g in grads)


def _delta_bthd(dout, out, num_heads):
    """``sum(dout * out)`` over each head's d columns, f32 ``[B*H, T]``."""
    b, t, hd = out.shape
    prod = dout.to(_acc(out.dtype)) * out.to(_acc(out.dtype))
    return prod.view(b, t, num_heads, hd // num_heads).sum(dim=-1).transpose(
        1, 2).reshape(b * num_heads, t)


def flash_bwd_bthd_ref(q, k, v, key_mask, num_heads, rate, seed, out, lse,
                       dout):
    """Plain version of the head-major backward: ``(dq, dk, dv)``, each
    ``[B, T, H*d]`` in the dtypes of ``q``, ``k`` and ``v``."""
    dq, dk, dv = _bwd_bthd_ref(q, k, v, key_mask, num_heads, rate, seed, lse,
                               _delta_bthd(dout, out, num_heads), dout)
    return dq.to(q.dtype), dk, dv


def _check_bthd(where, q, k, v, key_mask, num_heads, extra=()):
    """What the head-major kernels take; raises on anything else."""
    if q.dim() != 3 or k.dim() != 3 or q.shape[2] % num_heads:
        raise ValueError(f"{where}: q, k and v must be [B, T, H*d] with H = "
                         f"{num_heads}, got {tuple(q.shape)}")
    b, t, hd = q.shape
    t_kv = k.shape[1]
    _check_expect(where, q, hd // num_heads, t, t_kv, [
        ("q", q, (b, t, hd), q.dtype), ("k", k, (b, t_kv, hd), q.dtype),
        ("v", v, (b, t_kv, hd), q.dtype),
        ("key_mask", key_mask, (b, t_kv), torch.bool), *extra])
    return b, num_heads, t, t_kv, hd // num_heads


def flash_fwd_bthd(q, k, v, key_mask, num_heads, rate: float = 0.0,
                   seed=None):
    """The head-major forward kernel's wrapper: ``(out [B, T, H*d], lse
    [B*H, T])``.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises.  ``launches`` counts launches."""
    if q.device.type == "cpu":
        return flash_fwd_bthd_ref(q, k, v, key_mask, num_heads, rate, seed)
    if q.device.type != "cuda":
        raise _no_kernel("flash_fwd_bthd", q)
    b, h, t, t_kv, d = _check_bthd("flash_fwd_bthd", q, k, v, key_mask,
                                   num_heads)
    key, thresh, keep, on = _dropout_args(rate, seed)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    _launch("flash_fwd_bthd", q, _DTYPE_CODE[q.dtype], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, h, t, t_kv, d, key, thresh, keep, on)
    flash_fwd_bthd.launches += 1
    return out, lse


flash_fwd_bthd.launches = 0


def flash_bwd_fused_bthd(q, k, v, key_mask, num_heads, rate, seed, lse,
                         delta, dout):
    """The head-major fused backward's wrapper, from ``delta [B*H, T]`` f32:
    ``(dq f32, dk, dv)``, each ``[B, T, H*d]``.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (over
    :func:`fused_chunks` chunks) or raises.  ``launches`` counts
    launches."""
    if q.device.type == "cpu":
        return _bwd_bthd_ref(q, k, v, key_mask, num_heads, rate, seed, lse,
                             delta, dout)
    if q.device.type != "cuda":
        raise _no_kernel("flash_bwd_fused_bthd", q)
    rows = (q.shape[0] * num_heads, q.shape[1])
    b, h, t, t_kv, d = _check_bthd(
        "flash_bwd_fused_bthd", q, k, v, key_mask, num_heads,
        [("dout", dout, q.shape, q.dtype), ("lse", lse, rows, torch.float32),
         ("delta", delta, rows, torch.float32)])
    key, thresh, keep, on = _dropout_args(rate, seed)
    chunks = fused_chunks(b * h, t_kv, _sms(q.device))
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part = (torch.empty((chunks, *q.shape), dtype=torch.float32,
                        device=q.device) if chunks > 1 else None)
    _launch("flash_bwd_fused_bthd", q, _DTYPE_CODE[q.dtype], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b * h, h, t, t_kv, d, key, thresh, keep, on,
            _ptr(part), chunks)
    flash_bwd_fused_bthd.launches += 1
    return dq, dk, dv


flash_bwd_fused_bthd.launches = 0


def flash_bwd_bthd(q, k, v, key_mask, num_heads, rate, seed, out, lse, dout,
                   fused=None):
    """The head-major backward: ``(dq, dk, dv)``, each ``[B, T, H*d]`` in
    the dtypes of ``q``, ``k``, ``v``.  Computes ``delta`` and calls
    :func:`flash_bwd_fused_bthd` (``fused=True``) or, on ``[B, H, T, d]``
    transposes, :func:`flash_bwd_dkdv` and :func:`flash_bwd_dq`
    (``False``); when ``fused`` is None, by :func:`use_fused` on the card
    and the fused wrapper on the CPU.  Each wrapper launches its kernel on
    CUDA tensors and takes its plain version on CPU tensors."""
    if q.device.type not in ("cpu", "cuda"):
        raise _no_kernel("flash_bwd_bthd", q)
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("flash_bwd_bthd: out must have q's shape and dtype")
    delta = _delta_bthd(dout, out, num_heads)
    b, t, hd = q.shape
    if fused is None:
        fused = q.device.type == "cpu" or use_fused(
            b * num_heads, t, k.shape[1], hd // num_heads, _sms(q.device))
    if fused:
        dq, dk, dv = flash_bwd_fused_bthd(q, k, v, key_mask, num_heads, rate,
                                          seed, lse, delta, dout)
    else:
        qh, kh, vh, douth = _heads_dense(num_heads, q, k, v, dout)
        args = (qh, kh, vh, key_mask, rate, seed,
                lse.view(b, num_heads, t), delta.view(b, num_heads, t), douth)
        dk, dv = (_flat(g) for g in flash_bwd_dkdv(*args))
        dq = _flat(flash_bwd_dq(*args))
    return dq.to(q.dtype), dk, dv


class FlashAttnBthdFn(torch.autograd.Function):
    """The head-major forward kernel, backward through
    :func:`flash_bwd_bthd`: the counterpart of
    ``flash_self_attention_bthd``'s ``custom_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, num_heads, rate, seed):
        out, lse = flash_fwd_bthd(q, k, v, key_mask, num_heads, rate, seed)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.num_heads, ctx.rate, ctx.seed = num_heads, rate, seed
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_bthd(q, k, v, key_mask, ctx.num_heads,
                                    ctx.rate, ctx.seed, out, lse,
                                    dout.contiguous())
        return dq, dk, dv, None, None, None, None


def flash_self_attention_bthd(q, k, v, key_mask, num_heads,
                              rate: float = 0.0, seed=None):
    """:func:`flash_self_attention` on the head-major flat ``[B, T, H*d]``
    layout (q pre-scaled): ``out [B, T, H*d]``, differentiable through
    :class:`FlashAttnBthdFn`.  The kernels on CUDA tensors, the plain
    versions on CPU tensors."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    key_mask = key_mask.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttnBthdFn.apply(q, k, v, key_mask, num_heads, rate,
                                     seed)
    return flash_fwd_bthd(q, k, v, key_mask, num_heads, rate, seed)[0]
