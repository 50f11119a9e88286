"""One bidirectional GRU or LSTM layer: the hand-written Hopper kernels
(``csrc/gru_bidir_fwd.cu``, ``csrc/gru_bidir_bwd.cu``,
``csrc/lstm_bidir_fwd.cu``, ``csrc/lstm_bidir_bwd.cu``), their plain
PyTorch versions, and the ``torch.autograd.Function``s that tie each
train-form forward to its backward.  The LSTM section, below the GRU's,
has its own notes.

GRU: counterpart of ``pytorch_video_action_tpu/ops/rnn_fused_pallas.py``
``gru_bidir_fused_split``: ``_fwd_kernel_split`` in its eval and train
forms and ``_bwd_kernel_split``, its VJP.  Same argument order and layouts:
``x [T, B, W]`` time-major, per-direction ``wi [W, 3H]``, ``wh [H, 3H]``,
``bi``/``bh [3H]``, ``lengths [B]``; returns ``(ys_f, ys_b)``, each
``[T, B, H]`` in original time order and unmasked.

Masking contract: the forward chain runs through padding and is not
frozen, so ``ys_f`` at ``t >= len`` holds the continued chain.  The
backward chain walks ``t = T-1 .. 0`` from ``h = 0`` and keeps its carry
while ``t >= len``, so ``ys_b`` is 0 on padding and starts at ``t = len-1``.

The train form also returns the residuals ``res_f``, ``res_b`` ``[T, B,
4H]`` = ``[r, z, n, hg_n]`` of every step, in original time order for both
directions, in the input dtype; ``hg_n = (h @ wh + bh)[:, 2H:]`` includes
``bh_n``.  The backward reads the previous state from ``ys`` (``ys_f[t-1]``
and ``ys_b[t+1]``, 0 past the ends) and, on the backward chain's padded
steps, gives no gate gradient and passes the carry through.

Numerics: matmuls take the input dtype (f32 or bf16) and accumulate in
f32; the carry and the gate math are f32; ``h`` is rounded to the weight
dtype before the hidden product; ``ys`` and the residuals are stored in
the input dtype.  In the backward, ``dhg`` and ``hp`` are rounded to the
weight dtype before their products, ``dxg`` to the ``wi`` dtype for ``dx``
and to the ``x`` dtype for ``dwi``; the gradients are accumulated in f32
and returned in the weight dtype.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HIDDEN = (16, 32, 64, 128)  # the kernels' register-resident widths


def _acc(dtype):
    """Accumulation dtype: f32 for f32 and bf16 inputs, else the input's
    (float64 in the tests that differentiate the plain versions)."""
    return torch.promote_types(dtype, torch.float32)


def gru_bidir_layer_ref(x, wif, wib, bif, bib, whf, whb, bhf, bhb, lengths,
                        train=False):
    """Plain PyTorch version of the forward: a loop over T with the kernel's
    masking contract and dtype handling.  Products of the input dtype are
    exact in f32, so casting the operands to f32 gives f32 accumulation.
    ``train=True`` also returns the residuals."""
    t_len, b, _ = x.shape
    h = whf.shape[0]
    dt = x.dtype
    acc = _acc(dt)
    wi = torch.stack([wif, wib]).to(acc)  # [2, W, 3H]
    bi = torch.stack([bif, bib]).to(acc)[:, None, None, :]
    xg = torch.matmul(x.to(acc).unsqueeze(0), wi.unsqueeze(1)) + bi  # [2,T,B,3H]
    wh = torch.stack([whf, whb]).to(acc)  # [2, H, 3H]
    bh = torch.stack([bhf, bhb]).to(acc)[:, None, :]
    lengths = lengths.to(x.device, torch.int64)
    hs = torch.zeros(2, b, h, dtype=acc, device=x.device)
    ysf, ysb = (torch.empty(t_len, b, h, dtype=dt, device=x.device)
                for _ in range(2))
    if train:
        resf, resb = (torch.empty(t_len, b, 4 * h, dtype=dt, device=x.device)
                      for _ in range(2))
    for s in range(t_len):
        tb = t_len - 1 - s
        gx = torch.stack([xg[0, s], xg[1, tb]])  # [2, B, 3H]
        hg = torch.bmm(hs.to(dt).to(acc), wh) + bh
        r = torch.sigmoid(gx[..., :h] + hg[..., :h])
        z = torch.sigmoid(gx[..., h:2 * h] + hg[..., h:2 * h])
        n = torch.tanh(gx[..., 2 * h:] + r * hg[..., 2 * h:])
        hn = (1.0 - z) * n + z * hs
        valid_b = (tb < lengths)[:, None]
        hs = torch.stack([hn[0], torch.where(valid_b, hn[1], hs[1])])
        ysf[s] = hs[0].to(dt)
        ysb[tb] = hs[1].to(dt)
        if train:
            step = torch.cat([r, z, n, hg[..., 2 * h:]], dim=-1).to(dt)
            resf[s] = step[0]
            resb[tb] = step[1]
    if train:
        return ysf, ysb, resf, resb
    return ysf, ysb


def gru_bidir_layer_bwd_ref(x, wif, wib, whf, whb, lengths, ysf, ysb, resf,
                            resb, dyf, dyb):
    """Plain PyTorch version of the backward: the VJP of the forward in the
    kernel's order and rounding.  Returns ``(dx, dwif, dwib, dbif, dbib,
    dwhf, dwhb, dbhf, dbhb)``."""
    t_len, b, w_in = x.shape
    h = whf.shape[0]
    dt, wdt = x.dtype, whf.dtype
    acc = _acc(dt)

    def rnd(v, d):
        return v.to(d).to(acc)

    lengths = lengths.to(x.device, torch.int64)
    zero = torch.zeros(1, b, h, dtype=acc, device=x.device)
    # previous state: ys_f[t-1] (0 at t=0), ys_b[t+1] (0 at t=T-1)
    hp = torch.stack([torch.cat([zero, ysf[:-1].to(acc)]),
                      torch.cat([ysb[1:].to(acc), zero])])  # [2, T, B, H]
    res = torch.stack([resf, resb]).to(acc)
    dy = torch.stack([dyf, dyb]).to(acc)
    wh_t = torch.stack([whf, whb]).to(acc).transpose(1, 2)  # [2, 3H, H]
    dxg = torch.empty(2, t_len, b, 3 * h, dtype=acc, device=x.device)
    dhg = torch.empty_like(dxg)
    carry = torch.zeros(2, b, h, dtype=acc, device=x.device)
    always = torch.ones(b, dtype=torch.bool, device=x.device)
    for s in range(t_len):
        tf, tb = t_len - 1 - s, s  # the chains' steps, walked backwards
        rs = torch.stack([res[0, tf], res[1, tb]])
        r, z, n, hgn = (rs[..., i * h:(i + 1) * h] for i in range(4))
        dh = torch.stack([dy[0, tf], dy[1, tb]]) + carry
        dz = dh * (torch.stack([hp[0, tf], hp[1, tb]]) - n)
        dpn = dh * (1.0 - z) * (1.0 - n * n)
        dpr = dpn * hgn * r * (1.0 - r)
        dpz = dz * z * (1.0 - z)
        # the backward chain was frozen on padding: no gate gradient there
        valid = torch.stack([always, tb < lengths])[:, :, None]
        keep = valid.to(acc)
        dpn, dpr, dpz = dpn * keep, dpr * keep, dpz * keep
        gx = torch.cat([dpr, dpz, dpn], dim=-1)
        gh = torch.cat([dpr, dpz, dpn * r], dim=-1)
        dxg[0, tf], dxg[1, tb] = gx[0], gx[1]
        dhg[0, tf], dhg[1, tb] = gh[0], gh[1]
        step = dh * z + torch.bmm(rnd(gh, wdt), wh_t)
        carry = torch.where(valid, step, dh)
    m = t_len * b
    dxg, dhg = dxg.reshape(2, m, 3 * h), dhg.reshape(2, m, 3 * h)
    x2 = x.reshape(m, w_in).to(acc)
    dwi = torch.matmul(x2.t(), rnd(dxg, dt))  # [2, W, 3H]
    dwh = torch.matmul(rnd(hp.reshape(2, m, h), wdt).transpose(1, 2),
                       rnd(dhg, wdt))  # [2, H, 3H]
    dbi, dbh = dxg.sum(dim=1), dhg.sum(dim=1)
    dx = (torch.matmul(rnd(dxg[0], wif.dtype), wif.to(acc).t())
          + torch.matmul(rnd(dxg[1], wib.dtype), wib.to(acc).t()))
    return (dx.reshape(t_len, b, w_in).to(dt), dwi[0].to(wif.dtype),
            dwi[1].to(wib.dtype), dbi[0].to(wdt), dbi[1].to(wdt),
            dwh[0].to(wdt), dwh[1].to(wdt), dbh[0].to(wdt), dbh[1].to(wdt))


def _check_tensors(where, dtype, expect, tensors):
    """Shapes, one device, contiguity and the dtypes: ``dtype`` for an
    entry marked 1, int32 for None, else the entry's own dtype."""
    device = tensors[0].device
    for (name, shape, dt), t in zip(expect, tensors):
        if tuple(t.shape) != shape:
            raise ValueError(f"{where}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        want = torch.int32 if dt is None else dtype if dt == 1 else dt
        if t.dtype != want:
            raise TypeError(f"{where}: {name} is {t.dtype}, expected {want}")
        if t.device != device:
            raise ValueError(f"{where}: all tensors must be on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{where}: tensors must be contiguous")


def _dims(where, x, whf):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{where}: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if x.dim() != 3:
        raise ValueError(f"{where}: x must be [T, B, W], got {tuple(x.shape)}")
    return (*x.shape, whf.shape[0])


def _check_hidden(where, h):
    if h not in _HIDDEN:
        raise ValueError(f"{where}: H={h} not supported by the kernel "
                         f"(one of {_HIDDEN})")


def _check(x, weights, lengths):
    """What the forward kernel takes; raises on anything else."""
    t_len, b, w_in, h = _dims("gru_bidir_layer", x, weights[4])
    g = 3 * h
    expect = [("x", (t_len, b, w_in), 1), ("wif", (w_in, g), 1),
              ("wib", (w_in, g), 1), ("bif", (g,), 1), ("bib", (g,), 1),
              ("whf", (h, g), 1), ("whb", (h, g), 1), ("bhf", (g,), 1),
              ("bhb", (g,), 1), ("lengths", (b,), None)]
    _check_tensors("gru_bidir_layer", x.dtype, expect, (x, *weights, lengths))
    _check_hidden("gru_bidir_layer", h)
    return t_len, b, w_in, h


def _check_bwd(x, wif, wib, whf, whb, lengths, ysf, ysb, resf, resb, dyf,
               dyb):
    """What the backward kernel takes; raises on anything else."""
    t_len, b, w_in, h = _dims("gru_bidir_bwd", x, whf)
    g = 3 * h
    ys, res = (t_len, b, h), (t_len, b, 4 * h)
    expect = [("x", (t_len, b, w_in), 1), ("wif", (w_in, g), 1),
              ("wib", (w_in, g), 1), ("whf", (h, g), 1), ("whb", (h, g), 1),
              ("lengths", (b,), None), ("ysf", ys, 1), ("ysb", ys, 1),
              ("resf", res, 1), ("resb", res, 1), ("dyf", ys, 1),
              ("dyb", ys, 1)]
    _check_tensors("gru_bidir_bwd", x.dtype, expect,
                   (x, wif, wib, whf, whb, lengths, ysf, ysb, resf, resb,
                    dyf, dyb))
    _check_hidden("gru_bidir_bwd", h)
    return t_len, b, w_in, h


# argument types of each library's entry point: an int (dtype code), the
# device pointers, the int sizes, the stream
_ARGTYPES = {
    "gru_bidir_fwd": ([ctypes.c_int] + [ctypes.c_void_p] * 15
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    "gru_bidir_bwd": ([ctypes.c_int] + [ctypes.c_void_p] * 24
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "lstm_bidir_fwd": ([ctypes.c_int] + [ctypes.c_void_p] * 15
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    "lstm_bidir_bwd": ([ctypes.c_int] + [ctypes.c_void_p] * 23
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
}


def _kernel(name):
    """``(entry point, error-string function)`` of ``csrc/<name>.cu``."""
    from . import cuda_lib

    lib = cuda_lib.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
    return fn, getattr(lib, f"{name}_error_string")


def _launch(name, x, *args):
    """Call one library's entry point on ``x``'s device and current stream;
    raise when the launch was refused."""
    fn, err_string = _kernel(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{err_string(err).decode()} ({err})")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _no_kernel(where, x):
    return ValueError(f"{where}: no kernel for device {x.device}")


def gru_bidir_fwd(x, wif, wib, bif, bib, whf, whb, bhf, bhb, lengths,
                  train=False):
    """The forward kernel's wrapper.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel or raises.  ``launches`` counts
    eval-form launches, ``train_launches`` train-form ones."""
    weights = (wif, wib, bif, bib, whf, whb, bhf, bhb)
    if x.device.type == "cpu":
        return gru_bidir_layer_ref(x, *weights, lengths, train=train)
    if x.device.type != "cuda":
        raise _no_kernel("gru_bidir_fwd", x)
    t_len, b, w_in, h = _check(x, weights, lengths)
    ysf = torch.empty((t_len, b, h), dtype=x.dtype, device=x.device)
    ysb = torch.empty_like(ysf)
    resf = resb = None
    if train:
        resf = torch.empty((t_len, b, 4 * h), dtype=x.dtype, device=x.device)
        resb = torch.empty_like(resf)
    xg = torch.empty((2, t_len * b, 3 * h), dtype=torch.float32,
                     device=x.device)
    _launch("gru_bidir_fwd", x, _DTYPE_CODE[x.dtype], x.data_ptr(),
            *(w.data_ptr() for w in weights), lengths.data_ptr(),
            ysf.data_ptr(), ysb.data_ptr(), _ptr(resf), _ptr(resb),
            xg.data_ptr(), t_len, b, w_in, h, int(train))
    if train:
        gru_bidir_fwd.train_launches += 1
        return ysf, ysb, resf, resb
    gru_bidir_fwd.launches += 1
    return ysf, ysb


gru_bidir_fwd.launches = 0
gru_bidir_fwd.train_launches = 0


def gru_bidir_bwd(x, wif, wib, whf, whb, lengths, ysf, ysb, resf, resb, dyf,
                  dyb):
    """The backward kernel's wrapper.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel or raises.  Returns ``(dx, dwif,
    dwib, dbif, dbib, dwhf, dwhb, dbhf, dbhb)``; ``launches`` counts
    launches."""
    args = (x, wif, wib, whf, whb, lengths, ysf, ysb, resf, resb, dyf, dyb)
    if x.device.type == "cpu":
        return gru_bidir_layer_bwd_ref(*args)
    if x.device.type != "cuda":
        raise _no_kernel("gru_bidir_bwd", x)
    t_len, b, w_in, h = _check_bwd(*args)
    g = 3 * h
    dt = x.dtype
    dx = torch.empty_like(x)
    dwif, dwib = (torch.empty((w_in, g), dtype=dt, device=x.device)
                  for _ in range(2))
    dwhf, dwhb = (torch.empty((h, g), dtype=dt, device=x.device)
                  for _ in range(2))
    dbif, dbib, dbhf, dbhb = (torch.empty((g,), dtype=dt, device=x.device)
                              for _ in range(4))
    # f32 scratch: the per-step gate gradients dxg and dhg of both
    # directions, and the per-row bias sums
    dxg = torch.empty((2, t_len * b, g), dtype=torch.float32, device=x.device)
    dhg = torch.empty_like(dxg)
    bias_part = torch.empty((2, 2, b, g), dtype=torch.float32,
                            device=x.device)
    _launch("gru_bidir_bwd", x, _DTYPE_CODE[dt],
            *(t.data_ptr() for t in args),
            dx.data_ptr(), dwif.data_ptr(), dwib.data_ptr(), dbif.data_ptr(),
            dbib.data_ptr(), dwhf.data_ptr(), dwhb.data_ptr(),
            dbhf.data_ptr(), dbhb.data_ptr(), dxg.data_ptr(), dhg.data_ptr(),
            bias_part.data_ptr(), t_len, b, w_in, h)
    gru_bidir_bwd.launches += 1
    return dx, dwif, dwib, dbif, dbib, dwhf, dwhb, dbhf, dbhb


gru_bidir_bwd.launches = 0


class GRUBidirLayerFn(torch.autograd.Function):
    """Train-form forward, backward through ``gru_bidir_bwd``: the
    counterpart of ``gru_bidir_fused_split``'s ``custom_vjp``."""

    @staticmethod
    def forward(ctx, x, wif, wib, bif, bib, whf, whb, bhf, bhb, lengths):
        ysf, ysb, resf, resb = gru_bidir_fwd(
            x, wif, wib, bif, bib, whf, whb, bhf, bhb, lengths, train=True)
        ctx.save_for_backward(x, wif, wib, whf, whb, lengths, ysf, ysb, resf,
                              resb)
        return ysf, ysb

    @staticmethod
    def backward(ctx, dyf, dyb):
        x, wif, wib, whf, whb, lengths, ysf, ysb, resf, resb = \
            ctx.saved_tensors
        grads = gru_bidir_bwd(
            x, wif, wib, whf, whb, lengths, ysf, ysb, resf, resb,
            dyf.contiguous(), dyb.contiguous())
        return (*grads, None)


def gru_bidir_layer(x, wif, wib, bif, bib, whf, whb, bhf, bhb, lengths):
    """One bidirectional GRU layer, ``(ys_f, ys_b)``.  The eval form when
    grad mode is off or no input requires a gradient; otherwise the train
    form through :class:`GRUBidirLayerFn`, whose backward is
    ``gru_bidir_bwd``.  Kernels on CUDA tensors, plain versions on CPU
    tensors; neither falls back to the other."""
    weights = (wif, wib, bif, bib, whf, whb, bhf, bhb)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, *weights)):
        return GRUBidirLayerFn.apply(x, *weights, lengths)
    return gru_bidir_fwd(x, *weights, lengths)


# ------------------------------------------------------------------- LSTM
#
# Counterpart of ``rnn_fused_pallas.lstm_bidir_fused_split``:
# ``_lstm_fwd_kernel_split`` in its eval and train forms and
# ``_lstm_bwd_kernel_split``, its VJP.  Layouts: ``x [T, B, W]``,
# per-direction ``wi [W, 4H]``, ``wh [H, 4H]`` and one folded bias
# ``b = bi + bh [4H]``, gates i, f, g, o; ``lengths [B]``; returns
# ``(ys_f, ys_b)``, each ``[T, B, H]`` in original time order, unmasked.
#
# Masking contract: the forward chain runs through padding unfrozen, in h
# and c.  The backward chain walks ``t = T-1 .. 0`` from ``h = c = 0`` and
# keeps both while ``t >= len``, so ``ys_b`` is 0 on padding.
#
# The train form also returns ``cs_f``, ``cs_b [T, B, H]``, the carried
# cell state after each step, in f32 (the accumulation dtype), and the
# residuals ``res_f``, ``res_b [T, B, 5H] = [i, f, g, o, tanh c]`` in the
# input dtype, ``tanh c`` of the step's own new cell (also on frozen
# steps); both directions in original time order.  The backward reads
# ``c_prev`` from ``cs`` and the previous ``h`` from ``ys`` (``t-1``
# forward, ``t+1`` backward, 0 past the ends); on the backward chain's
# frozen steps it gives no gate gradient and passes ``dh`` and ``dc``
# through.
#
# Numerics as the GRU's: products of the input dtype accumulate in f32;
# ``c`` and the gate math are f32; ``h`` is rounded to the weight dtype
# before the hidden product.  In the backward the gate gradients are
# rounded to the weight dtype before the carry product and ``dwh``, to the
# ``wi`` dtype for ``dx`` and to the ``x`` dtype for ``dwi``.


def lstm_bidir_layer_ref(x, wif, wib, bf, bb, whf, whb, lengths,
                         train=False):
    """Plain PyTorch version of the LSTM forward: a loop over T with the
    kernel's masking contract and dtype handling.  ``train=True`` also
    returns ``(cs_f, cs_b, res_f, res_b)``."""
    t_len, b, _ = x.shape
    h = whf.shape[0]
    dt = x.dtype
    acc = _acc(dt)
    wi = torch.stack([wif, wib]).to(acc)  # [2, W, 4H]
    bias = torch.stack([bf, bb]).to(acc)[:, None, None, :]
    xg = torch.matmul(x.to(acc).unsqueeze(0), wi.unsqueeze(1)) + bias
    wh = torch.stack([whf, whb]).to(acc)  # [2, H, 4H]
    lengths = lengths.to(x.device, torch.int64)
    hs = torch.zeros(2, b, h, dtype=acc, device=x.device)
    cs = torch.zeros_like(hs)
    ysf, ysb = (torch.empty(t_len, b, h, dtype=dt, device=x.device)
                for _ in range(2))
    if train:
        csf, csb = (torch.empty(t_len, b, h, dtype=acc, device=x.device)
                    for _ in range(2))
        resf, resb = (torch.empty(t_len, b, 5 * h, dtype=dt, device=x.device)
                      for _ in range(2))
    for s in range(t_len):
        tb = t_len - 1 - s
        gates = (torch.stack([xg[0, s], xg[1, tb]])
                 + torch.bmm(hs.to(dt).to(acc), wh))
        i = torch.sigmoid(gates[..., :h])
        f = torch.sigmoid(gates[..., h:2 * h])
        g = torch.tanh(gates[..., 2 * h:3 * h])
        o = torch.sigmoid(gates[..., 3 * h:])
        cn = f * cs + i * g
        tc = torch.tanh(cn)
        hn = o * tc
        valid_b = (tb < lengths)[:, None]
        cs = torch.stack([cn[0], torch.where(valid_b, cn[1], cs[1])])
        hs = torch.stack([hn[0], torch.where(valid_b, hn[1], hs[1])])
        ysf[s] = hs[0].to(dt)
        ysb[tb] = hs[1].to(dt)
        if train:
            csf[s], csb[tb] = cs[0], cs[1]
            step = torch.cat([i, f, g, o, tc], dim=-1).to(dt)
            resf[s], resb[tb] = step[0], step[1]
    if train:
        return ysf, ysb, csf, csb, resf, resb
    return ysf, ysb


def lstm_bidir_layer_bwd_ref(x, wif, wib, whf, whb, lengths, ysf, ysb, csf,
                             csb, resf, resb, dyf, dyb):
    """Plain PyTorch version of the LSTM backward: the VJP of the forward
    in the kernel's order and rounding.  Returns ``(dx, dwif, dwib, dbf,
    dbb, dwhf, dwhb)``, ``db`` the folded bias's gradient."""
    t_len, b, w_in = x.shape
    h = whf.shape[0]
    dt, wdt = x.dtype, whf.dtype
    acc = _acc(dt)

    def rnd(v, d):
        return v.to(d).to(acc)

    def prev(f_seq, b_seq):
        """The chains' previous states: t-1 forward, t+1 backward."""
        zero = torch.zeros(1, b, h, dtype=acc, device=x.device)
        return torch.stack([torch.cat([zero, f_seq[:-1].to(acc)]),
                            torch.cat([b_seq[1:].to(acc), zero])])

    lengths = lengths.to(x.device, torch.int64)
    hp, cp = prev(ysf, ysb), prev(csf, csb)  # [2, T, B, H]
    res = torch.stack([resf, resb]).to(acc)
    dy = torch.stack([dyf, dyb]).to(acc)
    wh_t = torch.stack([whf, whb]).to(acc).transpose(1, 2)  # [2, 4H, H]
    dg = torch.empty(2, t_len, b, 4 * h, dtype=acc, device=x.device)
    carry_h = torch.zeros(2, b, h, dtype=acc, device=x.device)
    carry_c = torch.zeros_like(carry_h)
    always = torch.ones(b, dtype=torch.bool, device=x.device)
    for s in range(t_len):
        tf, tb = t_len - 1 - s, s  # the chains' steps, walked backwards
        rs = torch.stack([res[0, tf], res[1, tb]])
        i, f, g, o, tc = (rs[..., q * h:(q + 1) * h] for q in range(5))
        c_prev = torch.stack([cp[0, tf], cp[1, tb]])
        dh = torch.stack([dy[0, tf], dy[1, tb]]) + carry_h
        dc = dh * o * (1.0 - tc * tc) + carry_c
        gates = torch.cat([dc * g * i * (1.0 - i),
                           dc * c_prev * f * (1.0 - f),
                           dc * i * (1.0 - g * g),
                           dh * tc * o * (1.0 - o)], dim=-1)
        # the backward chain was frozen on padding: no gate gradient there
        valid = torch.stack([always, tb < lengths])[:, :, None]
        gates = torch.where(valid, gates, torch.zeros_like(gates))
        dg[0, tf], dg[1, tb] = gates[0], gates[1]
        carry_h = torch.where(valid, torch.bmm(rnd(gates, wdt), wh_t), dh)
        carry_c = torch.where(valid, dc * f, dc)
    m = t_len * b
    dg = dg.reshape(2, m, 4 * h)
    x2 = x.reshape(m, w_in).to(acc)
    dwi = torch.matmul(x2.t(), rnd(dg, dt))  # [2, W, 4H]
    dwh = torch.matmul(rnd(hp.reshape(2, m, h), wdt).transpose(1, 2),
                       rnd(dg, wdt))  # [2, H, 4H]
    db = dg.sum(dim=1)
    dx = (torch.matmul(rnd(dg[0], wif.dtype), wif.to(acc).t())
          + torch.matmul(rnd(dg[1], wib.dtype), wib.to(acc).t()))
    return (dx.reshape(t_len, b, w_in).to(dt), dwi[0].to(wif.dtype),
            dwi[1].to(wib.dtype), db[0].to(wdt), db[1].to(wdt),
            dwh[0].to(wdt), dwh[1].to(wdt))


def _check_lstm(x, weights, lengths):
    """What the LSTM forward kernel takes; raises on anything else."""
    t_len, b, w_in, h = _dims("lstm_bidir_layer", x, weights[4])
    g = 4 * h
    expect = [("x", (t_len, b, w_in), 1), ("wif", (w_in, g), 1),
              ("wib", (w_in, g), 1), ("bf", (g,), 1), ("bb", (g,), 1),
              ("whf", (h, g), 1), ("whb", (h, g), 1),
              ("lengths", (b,), None)]
    _check_tensors("lstm_bidir_layer", x.dtype, expect,
                   (x, *weights, lengths))
    _check_hidden("lstm_bidir_layer", h)
    return t_len, b, w_in, h


def _check_lstm_bwd(x, wif, wib, whf, whb, lengths, ysf, ysb, csf, csb,
                    resf, resb, dyf, dyb):
    """What the LSTM backward kernel takes; raises on anything else."""
    t_len, b, w_in, h = _dims("lstm_bidir_bwd", x, whf)
    g = 4 * h
    ys, res = (t_len, b, h), (t_len, b, 5 * h)
    f32 = torch.float32
    expect = [("x", (t_len, b, w_in), 1), ("wif", (w_in, g), 1),
              ("wib", (w_in, g), 1), ("whf", (h, g), 1), ("whb", (h, g), 1),
              ("lengths", (b,), None), ("ysf", ys, 1), ("ysb", ys, 1),
              ("csf", ys, f32), ("csb", ys, f32), ("resf", res, 1),
              ("resb", res, 1), ("dyf", ys, 1), ("dyb", ys, 1)]
    _check_tensors("lstm_bidir_bwd", x.dtype, expect,
                   (x, wif, wib, whf, whb, lengths, ysf, ysb, csf, csb, resf,
                    resb, dyf, dyb))
    _check_hidden("lstm_bidir_bwd", h)
    return t_len, b, w_in, h


def lstm_bidir_fwd(x, wif, wib, bf, bb, whf, whb, lengths, train=False):
    """The LSTM forward kernel's wrapper.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.  ``launches``
    counts eval-form launches, ``train_launches`` train-form ones."""
    weights = (wif, wib, bf, bb, whf, whb)
    if x.device.type == "cpu":
        return lstm_bidir_layer_ref(x, *weights, lengths, train=train)
    if x.device.type != "cuda":
        raise _no_kernel("lstm_bidir_fwd", x)
    t_len, b, w_in, h = _check_lstm(x, weights, lengths)
    ysf = torch.empty((t_len, b, h), dtype=x.dtype, device=x.device)
    ysb = torch.empty_like(ysf)
    csf = csb = resf = resb = None
    if train:
        csf = torch.empty((t_len, b, h), dtype=torch.float32, device=x.device)
        csb = torch.empty_like(csf)
        resf = torch.empty((t_len, b, 5 * h), dtype=x.dtype, device=x.device)
        resb = torch.empty_like(resf)
    xg = torch.empty((2, t_len * b, 4 * h), dtype=torch.float32,
                     device=x.device)
    _launch("lstm_bidir_fwd", x, _DTYPE_CODE[x.dtype], x.data_ptr(),
            *(w.data_ptr() for w in weights), lengths.data_ptr(),
            ysf.data_ptr(), ysb.data_ptr(), _ptr(csf), _ptr(csb), _ptr(resf),
            _ptr(resb), xg.data_ptr(), t_len, b, w_in, h, int(train))
    if train:
        lstm_bidir_fwd.train_launches += 1
        return ysf, ysb, csf, csb, resf, resb
    lstm_bidir_fwd.launches += 1
    return ysf, ysb


lstm_bidir_fwd.launches = 0
lstm_bidir_fwd.train_launches = 0


def lstm_bidir_bwd(x, wif, wib, whf, whb, lengths, ysf, ysb, csf, csb, resf,
                   resb, dyf, dyb):
    """The LSTM backward kernel's wrapper.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.  Returns ``(dx,
    dwif, dwib, dbf, dbb, dwhf, dwhb)``; ``launches`` counts launches."""
    args = (x, wif, wib, whf, whb, lengths, ysf, ysb, csf, csb, resf, resb,
            dyf, dyb)
    if x.device.type == "cpu":
        return lstm_bidir_layer_bwd_ref(*args)
    if x.device.type != "cuda":
        raise _no_kernel("lstm_bidir_bwd", x)
    t_len, b, w_in, h = _check_lstm_bwd(*args)
    g = 4 * h
    dt = x.dtype
    dx = torch.empty_like(x)
    dwif, dwib = (torch.empty((w_in, g), dtype=dt, device=x.device)
                  for _ in range(2))
    dbf, dbb = (torch.empty((g,), dtype=dt, device=x.device)
                for _ in range(2))
    dwhf, dwhb = (torch.empty((h, g), dtype=dt, device=x.device)
                  for _ in range(2))
    # f32 scratch: the per-step gate gradients of both directions, and the
    # per-row bias sums
    dg = torch.empty((2, t_len * b, g), dtype=torch.float32, device=x.device)
    bias_part = torch.empty((2, b, g), dtype=torch.float32, device=x.device)
    _launch("lstm_bidir_bwd", x, _DTYPE_CODE[dt],
            *(t.data_ptr() for t in args),
            dx.data_ptr(), dwif.data_ptr(), dwib.data_ptr(), dbf.data_ptr(),
            dbb.data_ptr(), dwhf.data_ptr(), dwhb.data_ptr(), dg.data_ptr(),
            bias_part.data_ptr(), t_len, b, w_in, h)
    lstm_bidir_bwd.launches += 1
    return dx, dwif, dwib, dbf, dbb, dwhf, dwhb


lstm_bidir_bwd.launches = 0


class LSTMBidirLayerFn(torch.autograd.Function):
    """Train-form forward, backward through ``lstm_bidir_bwd``: the
    counterpart of ``lstm_bidir_fused_split``'s ``custom_vjp``."""

    @staticmethod
    def forward(ctx, x, wif, wib, bf, bb, whf, whb, lengths):
        ysf, ysb, csf, csb, resf, resb = lstm_bidir_fwd(
            x, wif, wib, bf, bb, whf, whb, lengths, train=True)
        ctx.save_for_backward(x, wif, wib, whf, whb, lengths, ysf, ysb, csf,
                              csb, resf, resb)
        return ysf, ysb

    @staticmethod
    def backward(ctx, dyf, dyb):
        grads = lstm_bidir_bwd(*ctx.saved_tensors, dyf.contiguous(),
                               dyb.contiguous())
        return (*grads, None)


def lstm_bidir_layer(x, wif, wib, bf, bb, whf, whb, lengths):
    """One bidirectional LSTM layer, ``(ys_f, ys_b)``: dispatched as
    :func:`gru_bidir_layer` is, through :class:`LSTMBidirLayerFn` under
    autograd."""
    weights = (wif, wib, bf, bb, whf, whb)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, *weights)):
        return LSTMBidirLayerFn.apply(x, *weights, lengths)
    return lstm_bidir_fwd(x, *weights, lengths)
