"""One bidirectional GRU or LSTM layer: the hand-written Hopper kernels
(``csrc/gru_bidir_fwd.cu``, ``csrc/gru_bidir_bwd.cu``,
``csrc/lstm_bidir_fwd.cu``, ``csrc/lstm_bidir_bwd.cu``), their plain
PyTorch versions, and the ``torch.autograd.Function``s that tie each
train-form forward to its backward.  The LSTM section, below the GRU's,
has its own notes, and so has the merged-body section at the end (the
``PVA_RNN_SPLIT=0`` route, ``csrc/{gru,lstm}_merged_{fwd,bwd}.cu``).

The GRU's fused-boundary form (rows 1 alt and 2 alt, the layers after
the first under ``PVA_RNN_FUSED_BOUNDARY=1``) follows the GRU section.

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
import os

import torch

from . import hashmask
from .masking import length_mask

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


def _inputs(where, xs, whf):
    """The layer input as a tuple, its sizes and its check entries: ``x``,
    or the previous layer's halves ``(xa, xb)`` of the fused-boundary form
    (W = 2 Hx)."""
    xs = xs if isinstance(xs, tuple) else (xs,)
    t_len, b, w, h = _dims(where, xs[0], whf)
    if len(xs) == 1:
        return xs, t_len, b, w, h, [("x", (t_len, b, w), 1)]
    return xs, t_len, b, 2 * w, h, [("xa", (t_len, b, w), 1),
                                    ("xb", (t_len, b, w), 1)]


def _check(xs, weights, lengths, where="gru_bidir_layer"):
    """What the forward kernel takes, for the layer input ``xs`` (as
    :func:`_inputs`); raises on anything else."""
    xs, t_len, b, w_in, h, expect = _inputs(where, xs, weights[4])
    g = 3 * h
    expect += [("wif", (w_in, g), 1),
               ("wib", (w_in, g), 1), ("bif", (g,), 1), ("bib", (g,), 1),
               ("whf", (h, g), 1), ("whb", (h, g), 1), ("bhf", (g,), 1),
               ("bhb", (g,), 1), ("lengths", (b,), None)]
    _check_tensors(where, xs[0].dtype, expect, (*xs, *weights, lengths))
    _check_hidden(where, h)
    return t_len, b, w_in, h


def _check_bwd(xs, wif, wib, whf, whb, lengths, ysf, ysb, resf, resb, dyf,
               dyb, where="gru_bidir_bwd"):
    """What the backward kernel takes, for the layer input ``xs`` (as
    :func:`_inputs`); raises on anything else."""
    xs, t_len, b, w_in, h, expect = _inputs(where, xs, whf)
    g = 3 * h
    ys, res = (t_len, b, h), (t_len, b, 4 * h)
    expect += [("wif", (w_in, g), 1),
               ("wib", (w_in, g), 1), ("whf", (h, g), 1), ("whb", (h, g), 1),
               ("lengths", (b,), None), ("ysf", ys, 1), ("ysb", ys, 1),
               ("resf", res, 1), ("resb", res, 1), ("dyf", ys, 1),
               ("dyb", ys, 1)]
    _check_tensors(where, xs[0].dtype, expect,
                   (*xs, wif, wib, whf, whb, lengths, ysf, ysb, resf, resb,
                    dyf, dyb))
    _check_hidden(where, h)
    return t_len, b, w_in, h


# argument types of each library's entry point: an int (dtype code), the
# device pointers, the int sizes, the stream
_ARGTYPES = {
    "gru_bidir_fwd": ([ctypes.c_int] + [ctypes.c_void_p] * 15
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    "gru_bidir_bwd": ([ctypes.c_int] + [ctypes.c_void_p] * 25
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    "lstm_bidir_fwd": ([ctypes.c_int] + [ctypes.c_void_p] * 15
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    "lstm_bidir_bwd": ([ctypes.c_int] + [ctypes.c_void_p] * 24
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    "gru_merged_fwd": ([ctypes.c_int] + [ctypes.c_void_p] * 11
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    "gru_merged_bwd": ([ctypes.c_int] + [ctypes.c_void_p] * 20
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    "lstm_merged_fwd": ([ctypes.c_int] + [ctypes.c_void_p] * 11
                        + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    "lstm_merged_bwd": ([ctypes.c_int] + [ctypes.c_void_p] * 19
                        + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    # the fused-boundary forms: then the seed, the keep threshold, the
    # scale and the dropout switch
    "gru_bidir_bnd_fwd": ([ctypes.c_int] + [ctypes.c_void_p] * 16
                          + [ctypes.c_int] * 5 + [ctypes.c_uint] * 2
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "gru_bidir_bnd_bwd": ([ctypes.c_int] + [ctypes.c_void_p] * 27
                          + [ctypes.c_int] * 5 + [ctypes.c_uint] * 2
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
}
# the entry points that live in another entry point's csrc/<name>.cu
_LIBRARY = {"gru_bidir_bnd_fwd": "gru_bidir_fwd",
            "gru_bidir_bnd_bwd": "gru_bidir_bwd",
            "gru_merged_fwd": "gru_bidir_fwd",
            "lstm_merged_fwd": "lstm_bidir_fwd"}


def _kernel(name):
    """``(entry point, error-string function)`` of ``name``'s library,
    ``csrc/<name>.cu`` unless ``_LIBRARY`` names another."""
    from . import cuda_lib

    lib_name = _LIBRARY.get(name, name)
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


# The layer backwards' weight-gradient products (csrc/rnn_wgmma.cuh: rows 2
# and 2 alt, the GRU's; row 4, the LSTM's; row 6, the merged GRU's) split K
# = T*B into slices of whole 64-row chunks, one block a (64 x 128 tile,
# slice), and add the slices' f32 partials in order afterwards.
_CHUNK = 64
_MAX_SLICES = 16
_MIN_SLICE_CHUNKS = 4


def _ceil(a, b):
    return -(-a // b)


def _wgrad_rows(w_in, h, merged):
    """Rows of the weight gradients' four problems, each ``[rows, G]``:
    dwif, dwib ``[W, G]`` and dwhf, dwhb ``[H, G]``, or for the merged body
    dwh2's two column halves ``[2H, G]``."""
    hidden = 2 * h if merged else h
    return (w_in, w_in, hidden, hidden)


def wgrad_tiles(w_in, h, n_gates=3, merged=False):
    """Blocks of one K slice of the weight gradients: 64 x 128 tiles of the
    four problems of gate width G = ``n_gates`` * H (3, the GRU's; 4, the
    LSTM's), their rows as :func:`_wgrad_rows` gives them."""
    pairs = _ceil(_ceil(n_gates * h, _CHUNK), 2)
    return sum(_ceil(r, _CHUNK) for r in _wgrad_rows(w_in, h, merged)) * pairs


def wgrad_slice_chunks(rows, w_in, h, sms, n_gates=3, merged=False):
    """Chunks of each K slice of the weight gradients, for K = ``rows`` (T*B)
    on a card of ``sms`` SMs: :func:`slice_chunks` of their tiles."""
    return slice_chunks(rows, wgrad_tiles(w_in, h, n_gates, merged), sms)


def slice_chunks(rows, tiles, sms):
    """Chunks of each K slice of a weight gradient of ``tiles`` 64 x 128
    tiles (csrc/rnn_wgmma.cuh's products; also the LSTM scan's dwh), for K =
    ``rows`` (T*B) on a card of ``sms`` SMs, one block an SM: of the slice
    counts up to ``_MAX_SLICES`` that give every slice at least
    ``_MIN_SLICE_CHUNKS`` chunks (or the one slice), the one whose blocks
    finish soonest, ``ceil(tiles * slices / sms)`` waves of a slice's chunks
    each; on a tie the fewest slices, whose partials cost the least."""
    chunks = _ceil(rows, _CHUNK)
    best = None
    for want in range(1, _MAX_SLICES + 1):
        depth = _ceil(chunks, want)
        if want > 1 and depth < _MIN_SLICE_CHUNKS:
            break
        slices = _ceil(chunks, depth)
        cost = _ceil(tiles * slices, sms) * depth
        if best is None or cost < best[0]:
            best = (cost, depth)
    return best[1]


def wgrad_scratch_shape(t_len, b, w_in, h, sms, n_gates=3, merged=False):
    """``(slice_chunks, (slices, elements a slice))`` of the weight
    gradients' K slices and their f32 partials: a slice holds the four
    problems' ``[rows, G]`` partials (the merged body's dwh2 halves as one
    ``[2H, 2G]`` block)."""
    rows = t_len * b
    depth = wgrad_slice_chunks(rows, w_in, h, sms, n_gates, merged)
    per_slice = sum(_wgrad_rows(w_in, h, merged)) * n_gates * h
    return depth, (_ceil(_ceil(rows, _CHUNK), depth), per_slice)


def _wgrad_scratch(t_len, b, w_in, h, device, n_gates=3, merged=False):
    """``(slice_chunks, f32 partials)`` of the weight gradients' K slices."""
    depth, shape = wgrad_scratch_shape(t_len, b, w_in, h, _sms(device),
                                       n_gates, merged)
    return depth, torch.empty(shape, dtype=torch.float32, device=device)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    depth, part = _wgrad_scratch(t_len, b, w_in, h, x.device)
    _launch("gru_bidir_bwd", x, _DTYPE_CODE[dt],
            *(t.data_ptr() for t in args),
            dx.data_ptr(), dwif.data_ptr(), dwib.data_ptr(), dbif.data_ptr(),
            dbib.data_ptr(), dwhf.data_ptr(), dwhb.data_ptr(),
            dbhf.data_ptr(), dbhb.data_ptr(), dxg.data_ptr(), dhg.data_ptr(),
            bias_part.data_ptr(), part.data_ptr(), depth, t_len, b, w_in, h)
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


# --------------------------------------------------- GRU, fused boundary
#
# Counterpart of ``rnn_fused_pallas.gru_bidir_fused_split_bnd``: the GRU
# layer above on the stack's layer boundary.  Its input is not ``x [T, B,
# W]`` but the previous layer's raw direction halves ``xa``, ``xb [T, B,
# Hx]`` (W = 2 Hx), from which it builds the boundary the stack's glue
# (``ops/rnn.py``) would have built, :func:`boundary_input`: ``concat([xa,
# xb]) * mask`` and, with a ``seed``, the hash dropout over ``[T, B, 2Hx]``
# at strides ``(2Hx, T*2Hx, 1)`` with the scale ``1/keep`` rounded to the
# input dtype.  The kernels build it in the products' tile loads and never
# write it.  The backward returns ``dxa`` and ``dxb`` in place of ``dx``:
# the glue's VJP of ``dx`` rounded to the dtype (:func:`boundary_vjp`),
# ``dwi`` taken against the boundary.  The same values as the glue's, in
# the same rounding steps, so the flag never changes a result.
#
# ``FUSED_BOUNDARY`` (``PVA_RNN_FUSED_BOUNDARY``, read at import, off by
# default as in JAX; the stack reads the attribute at call time) routes the
# split GRU stack's layers after the first here.

FUSED_BOUNDARY = os.environ.get("PVA_RNN_FUSED_BOUNDARY", "0") == "1"


def time_mask(lengths, t_len, dtype):
    """The time-major length mask ``[T, B, 1]`` in ``dtype``."""
    return length_mask(lengths, t_len).t().to(dtype)[:, :, None]


def boundary_input(xa, xb, mask_tb, seed=None, keep=1.0):
    """The stack's layer boundary ``[T, B, 2Hx]`` (its glue, ``ops/rnn.py``):
    ``concat([xa, xb]) * mask_tb`` then, with a ``seed``, the hash dropout
    at the time-major strides."""
    x = torch.cat([xa, xb], dim=-1) * mask_tb
    if seed is not None:
        h2 = x.shape[-1]
        x = hashmask.hash_dropout(seed, x, keep,
                                  strides=(h2, x.shape[0] * h2, 1))
    return x


def boundary_vjp(dx, mask_tb, seed=None, keep=1.0):
    """``(dxa, dxb)`` from the boundary's gradient ``dx [T, B, 2Hx]``: the
    VJP of :func:`boundary_input` (the dropout's ``where(kept, dx * scale,
    0)`` with its scale and keep bits, times the mask, split in halves)."""
    t_len, _, h2 = dx.shape
    if seed is not None:
        dx = hashmask.hash_dropout(seed, dx, keep,
                                   strides=(h2, t_len * h2, 1))
    dx = dx * mask_tb
    return dx[..., :h2 // 2].contiguous(), dx[..., h2 // 2:].contiguous()


def gru_bidir_bnd_layer_ref(xa, xb, wif, wib, bif, bib, whf, whb, bhf, bhb,
                            lengths, seed=None, keep=1.0, train=False):
    """Plain version of the fused-boundary forward: :func:`boundary_input`,
    then :func:`gru_bidir_layer_ref`."""
    x = boundary_input(xa, xb, time_mask(lengths, xa.shape[0], xa.dtype),
                       seed, keep)
    return gru_bidir_layer_ref(x, wif, wib, bif, bib, whf, whb, bhf, bhb,
                               lengths, train=train)


def gru_bidir_bnd_layer_bwd_ref(xa, xb, wif, wib, whf, whb, lengths, ysf,
                                ysb, resf, resb, dyf, dyb, seed=None,
                                keep=1.0):
    """Plain version of the fused-boundary backward: row 2's on the
    boundary, then :func:`boundary_vjp`.  Returns ``(dxa, dxb, dwif, dwib,
    dbif, dbib, dwhf, dwhb, dbhf, dbhb)``."""
    mask_tb = time_mask(lengths, xa.shape[0], xa.dtype)
    x = boundary_input(xa, xb, mask_tb, seed, keep)
    dx, *grads = gru_bidir_layer_bwd_ref(x, wif, wib, whf, whb, lengths, ysf,
                                         ysb, resf, resb, dyf, dyb)
    return (*boundary_vjp(dx, mask_tb, seed, keep), *grads)


def _dropout_args(seed, keep, dtype):
    """``(seed, thresh, scale, on)`` of the boundary's dropout for the
    kernels; the scale is 1/keep rounded to ``dtype``."""
    if seed is None:
        return 0, 0, 1.0, 0
    scale = float(torch.tensor(1.0 / keep, dtype=dtype))
    return int(seed) & 0xFFFFFFFF, hashmask.threshold(keep), scale, 1


def gru_bidir_bnd_fwd(xa, xb, wif, wib, bif, bib, whf, whb, bhf, bhb,
                      lengths, seed=None, keep=1.0, train=False):
    """The fused-boundary forward kernel's wrapper (row 1 alt): dropout on
    the boundary when ``seed`` is given.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.  ``launches``
    counts eval-form launches, ``train_launches`` train-form ones."""
    weights = (wif, wib, bif, bib, whf, whb, bhf, bhb)
    if xa.device.type == "cpu":
        return gru_bidir_bnd_layer_ref(xa, xb, *weights, lengths, seed, keep,
                                       train=train)
    if xa.device.type != "cuda":
        raise _no_kernel("gru_bidir_bnd_fwd", xa)
    t_len, b, w_in, h = _check((xa, xb), weights, lengths,
                               "gru_bidir_bnd_fwd")
    ysf = torch.empty((t_len, b, h), dtype=xa.dtype, device=xa.device)
    ysb = torch.empty_like(ysf)
    resf = resb = None
    if train:
        resf = torch.empty((t_len, b, 4 * h), dtype=xa.dtype,
                           device=xa.device)
        resb = torch.empty_like(resf)
    xg = torch.empty((2, t_len * b, 3 * h), dtype=torch.float32,
                     device=xa.device)
    _launch("gru_bidir_bnd_fwd", xa, _DTYPE_CODE[xa.dtype], xa.data_ptr(),
            xb.data_ptr(), *(w.data_ptr() for w in weights),
            lengths.data_ptr(), ysf.data_ptr(), ysb.data_ptr(), _ptr(resf),
            _ptr(resb), xg.data_ptr(), t_len, b, w_in // 2, h, int(train),
            *_dropout_args(seed, keep, xa.dtype))
    if train:
        gru_bidir_bnd_fwd.train_launches += 1
        return ysf, ysb, resf, resb
    gru_bidir_bnd_fwd.launches += 1
    return ysf, ysb


gru_bidir_bnd_fwd.launches = 0
gru_bidir_bnd_fwd.train_launches = 0


def gru_bidir_bnd_bwd(xa, xb, wif, wib, whf, whb, lengths, ysf, ysb, resf,
                      resb, dyf, dyb, seed=None, keep=1.0):
    """The fused-boundary backward kernel's wrapper (row 2 alt).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises.  Returns ``(dxa, dxb, dwif, dwib, dbif, dbib, dwhf, dwhb, dbhf,
    dbhb)``; ``launches`` counts launches."""
    args = (wif, wib, whf, whb, lengths, ysf, ysb, resf, resb, dyf, dyb)
    if xa.device.type == "cpu":
        return gru_bidir_bnd_layer_bwd_ref(xa, xb, *args, seed, keep)
    if xa.device.type != "cuda":
        raise _no_kernel("gru_bidir_bnd_bwd", xa)
    t_len, b, w_in, h = _check_bwd((xa, xb), *args, "gru_bidir_bnd_bwd")
    g = 3 * h
    dt = xa.dtype
    dxa, dxb = torch.empty_like(xa), torch.empty_like(xb)
    dwif, dwib = (torch.empty((w_in, g), dtype=dt, device=xa.device)
                  for _ in range(2))
    dwhf, dwhb = (torch.empty((h, g), dtype=dt, device=xa.device)
                  for _ in range(2))
    dbif, dbib, dbhf, dbhb = (torch.empty((g,), dtype=dt, device=xa.device)
                              for _ in range(4))
    dxg = torch.empty((2, t_len * b, g), dtype=torch.float32,
                      device=xa.device)
    dhg = torch.empty_like(dxg)
    bias_part = torch.empty((2, 2, b, g), dtype=torch.float32,
                            device=xa.device)
    depth, part = _wgrad_scratch(t_len, b, w_in, h, xa.device)
    _launch("gru_bidir_bnd_bwd", xa, _DTYPE_CODE[dt], xa.data_ptr(),
            xb.data_ptr(), *(t.data_ptr() for t in args), dxa.data_ptr(),
            dxb.data_ptr(), dwif.data_ptr(), dwib.data_ptr(), dbif.data_ptr(),
            dbib.data_ptr(), dwhf.data_ptr(), dwhb.data_ptr(),
            dbhf.data_ptr(), dbhb.data_ptr(), dxg.data_ptr(), dhg.data_ptr(),
            bias_part.data_ptr(), part.data_ptr(), depth, t_len, b,
            w_in // 2, h, *_dropout_args(seed, keep, dt))
    gru_bidir_bnd_bwd.launches += 1
    return dxa, dxb, dwif, dwib, dbif, dbib, dwhf, dwhb, dbhf, dbhb


gru_bidir_bnd_bwd.launches = 0


class GRUBidirBndLayerFn(torch.autograd.Function):
    """Train-form fused-boundary forward, backward through
    ``gru_bidir_bnd_bwd``: the counterpart of
    ``gru_bidir_fused_split_bnd``'s ``custom_vjp``."""

    @staticmethod
    def forward(ctx, xa, xb, wif, wib, bif, bib, whf, whb, bhf, bhb, lengths,
                seed, keep):
        ysf, ysb, resf, resb = gru_bidir_bnd_fwd(
            xa, xb, wif, wib, bif, bib, whf, whb, bhf, bhb, lengths, seed,
            keep, train=True)
        ctx.save_for_backward(xa, xb, wif, wib, whf, whb, lengths, ysf, ysb,
                              resf, resb)
        ctx.seed, ctx.keep = seed, keep
        return ysf, ysb

    @staticmethod
    def backward(ctx, dyf, dyb):
        grads = gru_bidir_bnd_bwd(*ctx.saved_tensors, dyf.contiguous(),
                                  dyb.contiguous(), ctx.seed, ctx.keep)
        return (*grads, None, None, None)


def gru_bidir_bnd_layer(xa, xb, wif, wib, bif, bib, whf, whb, bhf, bhb,
                        lengths, seed=None, keep=1.0):
    """One bidirectional GRU layer on the stack's boundary of the previous
    layer's halves, ``(ys_f, ys_b)``, dropout on the boundary when ``seed``
    is given.  The eval form when grad mode is off or no input requires a
    gradient; otherwise the train form through
    :class:`GRUBidirBndLayerFn`.  Kernels on CUDA tensors, plain versions
    on CPU tensors; neither falls back to the other."""
    weights = (wif, wib, bif, bib, whf, whb, bhf, bhb)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xa, xb, *weights)):
        return GRUBidirBndLayerFn.apply(xa, xb, *weights, lengths, seed,
                                        keep)
    return gru_bidir_bnd_fwd(xa, xb, *weights, lengths, seed, keep)


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
    # f32 scratch: the per-step gate gradients of both directions, the
    # per-row bias sums and the weight gradients' K-slice partials
    dg = torch.empty((2, t_len * b, g), dtype=torch.float32, device=x.device)
    bias_part = torch.empty((2, b, g), dtype=torch.float32, device=x.device)
    depth, part = _wgrad_scratch(t_len, b, w_in, h, x.device, n_gates=4)
    _launch("lstm_bidir_bwd", x, _DTYPE_CODE[dt],
            *(t.data_ptr() for t in args),
            dx.data_ptr(), dwif.data_ptr(), dwib.data_ptr(), dbf.data_ptr(),
            dbb.data_ptr(), dwhf.data_ptr(), dwhb.data_ptr(), dg.data_ptr(),
            bias_part.data_ptr(), part.data_ptr(), depth, t_len, b, w_in, h)
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


# ------------------------------------------------------------ merged body
#
# Counterpart of ``rnn_fused_pallas.gru_bidir_fused`` and
# ``lstm_bidir_fused``, the route ``PVA_RNN_SPLIT=0`` selects:
# ``_fwd_kernel`` / ``_lstm_fwd_kernel`` in their eval and train forms and
# ``_bwd_kernel`` / ``_lstm_bwd_kernel``, their VJPs.  Both directions run
# as one ``[B, 2H]`` chain against a gate-grouped hidden weight.  Layouts,
# g = 3 gates (GRU) or 4 (LSTM):
#
# * dense per-direction input weights ``wif2``, ``wib2 [W, gH]``;
# * gate-grouped ``bi2 [g*2H]``, ``wh2 [2H, g*2H]`` and, for the GRU only,
#   ``bh2 [g*2H]``: columns ``[gate0_f gate0_b | gate1_f gate1_b | ...]``
#   (``ops/rnn.py:_pack_gate_grouped``); ``wh2`` is block-diagonal, the
#   LSTM's ``bi2`` holds both folded biases;
# * ``ys_f``, ``ys_b [T, B, H]`` in original time order, unmasked;
# * the train form's residuals in KERNEL order, row s holding the forward
#   chain's step s (time s) and the backward chain's step s (time T-1-s):
#   GRU ``res [T, B, 8H] = [r z n hg_n]``, LSTM ``res [T, B, 10H] = [i f g
#   o tanh_c]``, each of them 2H wide, gate-grouped; and the LSTM's
#   carried cell state ``cs [T, B, 2H]``, kernel order, in the input
#   dtype (the split route keeps its cell states in f32).
#
# Masking contract as the split route's: the backward chain's carry is
# frozen on its flipped-prefix padding (kernel step s < T - len, i.e.
# time t >= len), where its VJP gives no gate gradient and passes dh (and
# the LSTM's dc) through.  The backward takes ``hp2`` (and ``cp2``), the
# kernel-order previous state, which the autograd Function builds from
# ``ys`` (and ``cs``) in plain torch, as JAX builds them outside the
# kernel, and returns ``dx_f`` and ``dx_b`` apart, each in x's dtype;
# the Function sums them in f32.  Its ``dwh2`` is the whole ``[2H,
# g*2H]``, off-diagonal blocks included (``hp2^T dhg2``); the packing's
# VJP keeps only the diagonal blocks.  Numerics as the split route's.

SPLIT = os.environ.get("PVA_RNN_SPLIT", "1") == "1"


def _dense(v, h, n_gates, d):
    """Direction ``d``'s dense ``[..., gH]`` columns out of gate-grouped
    ``[..., g*2H]`` ones."""
    return torch.cat([v[..., q * 2 * h + d * h:q * 2 * h + (d + 1) * h]
                      for q in range(n_gates)], dim=-1)


def _grouped(vf, vb, h, n_gates):
    """Gate-grouped ``[..., g*2H]`` columns of two directions' dense
    ``[..., gH]`` ones."""
    return torch.cat([v[..., q * h:(q + 1) * h] for q in range(n_gates)
                      for v in (vf, vb)], dim=-1)


def _merged_xg(x, wif2, wib2, n_gates):
    """The chain's input gates, no bias, kernel order, gate-grouped
    ``[T, B, g*2H]`` in the accumulation dtype."""
    acc = _acc(x.dtype)
    h = wif2.shape[1] // n_gates
    xf = x.to(acc)
    xgf = torch.matmul(xf, wif2.to(acc))
    xgb = torch.matmul(xf, wib2.to(acc)).flip(0)
    return _grouped(xgf, xgb, h, n_gates)


def _updated_lanes(s, t_len, lengths, h):
    """``[B, 2H]`` bool: True on the lanes a kernel step updates (every
    forward lane; the backward chain's where s >= T - len)."""
    valid = (s >= t_len - lengths)[:, None].expand(-1, h)
    return torch.cat([torch.ones_like(valid), valid], dim=-1)


def gru_merged_layer_ref(x, wif2, wib2, bi2, wh2, bh2, lengths, train=False):
    """Plain PyTorch version of the merged GRU forward: one ``[B, 2H]``
    chain against the whole ``wh2``, a loop over the kernel steps.
    ``train=True`` also returns the kernel-order residuals."""
    t_len, b, _ = x.shape
    h = wh2.shape[0] // 2
    w2 = 2 * h
    dt = x.dtype
    acc = _acc(dt)
    xg2 = _merged_xg(x, wif2, wib2, 3)
    bi, wh, bh = bi2.to(acc), wh2.to(acc), bh2.to(acc)
    lengths = lengths.to(x.device, torch.int64)
    h2 = torch.zeros(b, w2, dtype=acc, device=x.device)
    ysf, ysb = (torch.empty(t_len, b, h, dtype=dt, device=x.device)
                for _ in range(2))
    if train:
        res = torch.empty(t_len, b, 8 * h, dtype=dt, device=x.device)
    for s in range(t_len):
        gx = xg2[s] + bi
        hg = torch.matmul(h2.to(wh2.dtype).to(acc), wh) + bh
        r = torch.sigmoid(gx[:, :w2] + hg[:, :w2])
        z = torch.sigmoid(gx[:, w2:2 * w2] + hg[:, w2:2 * w2])
        hg_n = hg[:, 2 * w2:]
        n = torch.tanh(gx[:, 2 * w2:] + r * hg_n)
        hn = (1.0 - z) * n + z * h2
        h2 = torch.where(_updated_lanes(s, t_len, lengths, h), hn, h2)
        ysf[s] = h2[:, :h].to(dt)
        ysb[t_len - 1 - s] = h2[:, h:].to(dt)
        if train:
            res[s] = torch.cat([r, z, n, hg_n], dim=-1).to(dt)
    if train:
        return ysf, ysb, res
    return ysf, ysb


def _merged_products(x, wif2, wib2, wh2, hp2, dxg2, dhg2, n_gates):
    """The backward's products off the chain, from the kernel-order
    gate-grouped gate gradients ``dxg2``, ``dhg2 [T, B, g*2H]``: ``(dx_f,
    dx_b, dwif, dwib, dbi2, dwh2, dbh2)``, the per-direction ones in
    original time order."""
    t_len, b, w_in = x.shape
    h = wh2.shape[0] // 2
    dt, wdt = x.dtype, wh2.dtype
    acc = _acc(dt)
    m = t_len * b

    def rnd(v, d):
        return v.to(d).to(acc)

    gw = n_gates * h
    dxg_f = _dense(dxg2, h, n_gates, 0).reshape(m, gw)
    dxg_b = _dense(dxg2, h, n_gates, 1).flip(0).reshape(m, gw)
    x2 = x.reshape(m, w_in).to(acc)
    dxf = torch.matmul(rnd(dxg_f, wif2.dtype), wif2.to(acc).t())
    dxb = torch.matmul(rnd(dxg_b, wib2.dtype), wib2.to(acc).t())
    dwif = torch.matmul(x2.t(), rnd(dxg_f, dt))
    dwib = torch.matmul(x2.t(), rnd(dxg_b, dt))
    dwh2 = torch.matmul(rnd(hp2.reshape(m, 2 * h).to(acc), wdt).t(),
                        rnd(dhg2.reshape(m, 2 * gw), wdt))
    return (dxf.reshape(t_len, b, w_in).to(dt),
            dxb.reshape(t_len, b, w_in).to(dt), dwif.to(wif2.dtype),
            dwib.to(wib2.dtype), dxg2.sum(dim=(0, 1)).to(wdt), dwh2.to(wdt),
            dhg2.sum(dim=(0, 1)).to(wdt))


def gru_merged_layer_bwd_ref(x, res, hp2, dyf, dyb, wif2, wib2, wh2,
                             lengths):
    """Plain PyTorch version of the merged GRU backward: the VJP of the
    forward in JAX's ``_bwd_kernel``'s order and rounding, the carry
    product against the whole ``wh2``.  Returns ``(dx_f, dx_b, dwif, dwib,
    dbi2, dwh2, dbh2)``."""
    t_len, b, _ = x.shape
    h = wh2.shape[0] // 2
    w2 = 2 * h
    acc = _acc(x.dtype)
    wdt = wh2.dtype
    lengths = lengths.to(x.device, torch.int64)
    res = res.to(acc)
    hp = hp2.to(acc)
    dy2 = torch.cat([dyf, dyb.flip(0)], dim=-1).to(acc)  # kernel order
    wh_t = wh2.to(acc).t()
    dxg2 = torch.empty(t_len, b, 6 * h, dtype=acc, device=x.device)
    dhg2 = torch.empty_like(dxg2)
    carry = torch.zeros(b, w2, dtype=acc, device=x.device)
    for s in range(t_len - 1, -1, -1):
        r, z, n, hg_n = (res[s, :, i * w2:(i + 1) * w2] for i in range(4))
        dh = dy2[s] + carry
        dz = dh * (hp[s] - n)
        dpn = dh * (1.0 - z) * (1.0 - n * n)
        dpr = dpn * hg_n * r * (1.0 - r)
        dpz = dz * z * (1.0 - z)
        # the backward chain was frozen on its padding: no gate gradient
        valid = _updated_lanes(s, t_len, lengths, h)
        keep = valid.to(acc)
        dpn, dpr, dpz = dpn * keep, dpr * keep, dpz * keep
        dxg2[s] = torch.cat([dpr, dpz, dpn], dim=-1)
        dhg2[s] = torch.cat([dpr, dpz, dpn * r], dim=-1)
        step = dh * z + torch.matmul(dhg2[s].to(wdt).to(acc), wh_t)
        carry = torch.where(valid, step, dh)
    return _merged_products(x, wif2, wib2, wh2, hp, dxg2, dhg2, 3)


def lstm_merged_layer_ref(x, wif2, wib2, bi2, wh2, lengths, train=False):
    """Plain PyTorch version of the merged LSTM forward: one ``[B, 2H]``
    chain (h and c) against the whole ``wh2``.  ``train=True`` also
    returns ``(cs, res)``, kernel order, in x's dtype."""
    t_len, b, _ = x.shape
    h = wh2.shape[0] // 2
    w2 = 2 * h
    dt = x.dtype
    acc = _acc(dt)
    xg2 = _merged_xg(x, wif2, wib2, 4)
    bi, wh = bi2.to(acc), wh2.to(acc)
    lengths = lengths.to(x.device, torch.int64)
    h2 = torch.zeros(b, w2, dtype=acc, device=x.device)
    c2 = torch.zeros_like(h2)
    ysf, ysb = (torch.empty(t_len, b, h, dtype=dt, device=x.device)
                for _ in range(2))
    if train:
        cs = torch.empty(t_len, b, w2, dtype=dt, device=x.device)
        res = torch.empty(t_len, b, 10 * h, dtype=dt, device=x.device)
    for s in range(t_len):
        gates = (xg2[s] + bi) + torch.matmul(h2.to(wh2.dtype).to(acc), wh)
        i = torch.sigmoid(gates[:, :w2])
        f = torch.sigmoid(gates[:, w2:2 * w2])
        g = torch.tanh(gates[:, 2 * w2:3 * w2])
        o = torch.sigmoid(gates[:, 3 * w2:])
        c = f * c2 + i * g
        tanh_c = torch.tanh(c)
        valid = _updated_lanes(s, t_len, lengths, h)
        h2 = torch.where(valid, o * tanh_c, h2)
        c2 = torch.where(valid, c, c2)
        ysf[s] = h2[:, :h].to(dt)
        ysb[t_len - 1 - s] = h2[:, h:].to(dt)
        if train:
            cs[s] = c2.to(dt)
            res[s] = torch.cat([i, f, g, o, tanh_c], dim=-1).to(dt)
    if train:
        return ysf, ysb, cs, res
    return ysf, ysb


def lstm_merged_layer_bwd_ref(x, res, hp2, cp2, dyf, dyb, wif2, wib2, wh2,
                              lengths):
    """Plain PyTorch version of the merged LSTM backward, in JAX's
    ``_lstm_bwd_kernel``'s order and rounding.  Returns ``(dx_f, dx_b,
    dwif, dwib, dbi2, dwh2)``."""
    t_len, b, _ = x.shape
    h = wh2.shape[0] // 2
    w2 = 2 * h
    acc = _acc(x.dtype)
    wdt = wh2.dtype
    lengths = lengths.to(x.device, torch.int64)
    res = res.to(acc)
    hp, cp = hp2.to(acc), cp2.to(acc)
    dy2 = torch.cat([dyf, dyb.flip(0)], dim=-1).to(acc)
    wh_t = wh2.to(acc).t()
    dg2 = torch.empty(t_len, b, 8 * h, dtype=acc, device=x.device)
    carry_h = torch.zeros(b, w2, dtype=acc, device=x.device)
    carry_c = torch.zeros_like(carry_h)
    for s in range(t_len - 1, -1, -1):
        i, f, g, o, tanh_c = (res[s, :, q * w2:(q + 1) * w2]
                              for q in range(5))
        dh = dy2[s] + carry_h
        dc = dh * o * (1.0 - tanh_c * tanh_c) + carry_c
        valid = _updated_lanes(s, t_len, lengths, h)
        keep = valid.to(acc)
        dg2[s] = torch.cat([dc * g * i * (1.0 - i) * keep,
                            dc * cp[s] * f * (1.0 - f) * keep,
                            dc * i * (1.0 - g * g) * keep,
                            dh * tanh_c * o * (1.0 - o) * keep], dim=-1)
        carry_h = torch.where(
            valid, torch.matmul(dg2[s].to(wdt).to(acc), wh_t), dh)
        carry_c = torch.where(valid, dc * f, dc)
    # the LSTM's input and hidden gate gradients are both dgates
    return _merged_products(x, wif2, wib2, wh2, hp, dg2, dg2, 4)[:6]


def _merged_dims(where, x, wh2):
    """``(T, B, W, H)`` of a merged kernel's call; raises on a dtype, rank or
    width the kernels do not take."""
    if wh2.dim() != 2 or wh2.shape[0] % 2:
        raise ValueError(f"{where}: wh2 must be [2H, g*2H], got "
                         f"{tuple(wh2.shape)}")
    t_len, b, w_in, h = _dims(where, x, wh2[:wh2.shape[0] // 2])
    _check_hidden(where, h)
    return t_len, b, w_in, h


def _merged_expect(t_len, b, w_in, h, n_gates, *names):
    """The shapes of the merged kernels' arguments, by name, as
    ``_check_tensors`` takes them."""
    g, g2 = n_gates * h, 2 * n_gates * h
    n_res = 8 * h if n_gates == 3 else 10 * h
    shapes = {"x": (t_len, b, w_in), "wif2": (w_in, g), "wib2": (w_in, g),
              "bi2": (g2,), "wh2": (2 * h, g2), "bh2": (g2,),
              "res": (t_len, b, n_res), "hp2": (t_len, b, 2 * h),
              "cp2": (t_len, b, 2 * h), "dyf": (t_len, b, h),
              "dyb": (t_len, b, h), "lengths": (b,)}
    return [(n, shapes[n], None if n == "lengths" else 1) for n in names]


def gru_merged_fwd(x, wif2, wib2, bi2, wh2, bh2, lengths, train=False):
    """Row 5's wrapper.  A CPU tensor takes the plain version; a CUDA tensor
    launches row 1's recurrence with the merged addressing
    (``csrc/gru_bidir_fwd.cu``, ``gru_merged_fwd``) or raises.  It reads only
    the two diagonal blocks of ``wh2`` (and of ``bi2``/``bh2`` the
    direction's own columns): it relies on ``wh2`` being block-diagonal, as
    ``ops/rnn.py:_pack_gate_grouped`` makes it.  ``launches`` counts
    eval-form launches, ``train_launches`` train-form ones."""
    if x.device.type == "cpu":
        return gru_merged_layer_ref(x, wif2, wib2, bi2, wh2, bh2, lengths,
                                    train=train)
    if x.device.type != "cuda":
        raise _no_kernel("gru_merged_fwd", x)
    t_len, b, w_in, h = _merged_dims("gru_merged_fwd", x, wh2)
    _check_tensors("gru_merged_fwd", x.dtype, _merged_expect(
        t_len, b, w_in, h, 3, "x", "wif2", "wib2", "bi2", "wh2", "bh2",
        "lengths"), (x, wif2, wib2, bi2, wh2, bh2, lengths))
    ysf = torch.empty((t_len, b, h), dtype=x.dtype, device=x.device)
    ysb = torch.empty_like(ysf)
    res = (torch.empty((t_len, b, 8 * h), dtype=x.dtype, device=x.device)
           if train else None)
    xg = torch.empty((2, t_len * b, 3 * h), dtype=torch.float32,
                     device=x.device)
    _launch("gru_merged_fwd", x, _DTYPE_CODE[x.dtype], x.data_ptr(),
            wif2.data_ptr(), wib2.data_ptr(), bi2.data_ptr(), wh2.data_ptr(),
            bh2.data_ptr(), lengths.data_ptr(), ysf.data_ptr(),
            ysb.data_ptr(), _ptr(res), xg.data_ptr(), t_len, b, w_in, h,
            int(train))
    if train:
        gru_merged_fwd.train_launches += 1
        return ysf, ysb, res
    gru_merged_fwd.launches += 1
    return ysf, ysb


gru_merged_fwd.launches = 0
gru_merged_fwd.train_launches = 0


def gru_merged_bwd(x, res, hp2, dyf, dyb, wif2, wib2, wh2, lengths):
    """Row 6's wrapper.  A CPU tensor takes the plain version; a CUDA tensor
    launches ``csrc/gru_merged_bwd.cu`` or raises.  Returns ``(dx_f,
    dx_b, dwif, dwib, dbi2, dwh2, dbh2)``; ``launches`` counts launches.
    Like JAX's ``_bwd_kernel`` it relies on ``wh2`` being block-diagonal:
    its carry product reads only the diagonal blocks."""
    args = (x, res, hp2, dyf, dyb, wif2, wib2, wh2, lengths)
    if x.device.type == "cpu":
        return gru_merged_layer_bwd_ref(*args)
    if x.device.type != "cuda":
        raise _no_kernel("gru_merged_bwd", x)
    t_len, b, w_in, h = _merged_dims("gru_merged_bwd", x, wh2)
    _check_tensors("gru_merged_bwd", x.dtype, _merged_expect(
        t_len, b, w_in, h, 3, "x", "res", "hp2", "dyf", "dyb", "wif2",
        "wib2", "wh2", "lengths"), args)
    dt = x.dtype
    dxf, dxb = torch.empty_like(x), torch.empty_like(x)
    dwif, dwib = (torch.empty_like(wif2), torch.empty_like(wib2))
    dbi2, dbh2 = (torch.empty(6 * h, dtype=dt, device=x.device)
                  for _ in range(2))
    dwh2 = torch.empty_like(wh2)
    # f32 scratch: the chain's gate gradients, dxg per direction in time
    # order and dhg2 in kernel order, gate-grouped; the per-row bias sums;
    # the weight gradients' K-slice partials
    dxg = torch.empty((2, t_len * b, 3 * h), dtype=torch.float32,
                      device=x.device)
    dhg = torch.empty((t_len * b, 6 * h), dtype=torch.float32,
                      device=x.device)
    bias_part = torch.empty((2, b, 6 * h), dtype=torch.float32,
                            device=x.device)
    depth, part = _wgrad_scratch(t_len, b, w_in, h, x.device, merged=True)
    _launch("gru_merged_bwd", x, _DTYPE_CODE[dt],
            *(t.data_ptr() for t in args), dxf.data_ptr(), dxb.data_ptr(),
            dwif.data_ptr(), dwib.data_ptr(), dbi2.data_ptr(),
            dwh2.data_ptr(), dbh2.data_ptr(), dxg.data_ptr(), dhg.data_ptr(),
            bias_part.data_ptr(), part.data_ptr(), depth, t_len, b, w_in, h)
    gru_merged_bwd.launches += 1
    return dxf, dxb, dwif, dwib, dbi2, dwh2, dbh2


gru_merged_bwd.launches = 0


def _prev_kernel_order(ysf, ysb):
    """``hp2 [T, B, 2H]``: the kernel-order state before each step,
    ``[ys_f[s-1], ys_b[T-s]]``, 0 at s = 0."""
    ys_k = torch.cat([ysf, ysb.flip(0)], dim=-1)
    return torch.cat([torch.zeros_like(ys_k[:1]), ys_k[:-1]])


def _sum_dx(dxf, dxb, dtype):
    return (dxf.float() + dxb.float()).to(dtype)


class GRUMergedLayerFn(torch.autograd.Function):
    """Row 5's train form, backward through row 6: the counterpart of
    ``gru_bidir_fused``'s ``custom_vjp``."""

    @staticmethod
    def forward(ctx, x, wif2, wib2, bi2, wh2, bh2, lengths):
        ysf, ysb, res = gru_merged_fwd(x, wif2, wib2, bi2, wh2, bh2,
                                       lengths, train=True)
        ctx.save_for_backward(x, wif2, wib2, wh2, lengths, ysf, ysb, res)
        return ysf, ysb

    @staticmethod
    def backward(ctx, dyf, dyb):
        x, wif2, wib2, wh2, lengths, ysf, ysb, res = ctx.saved_tensors
        dxf, dxb, *grads = gru_merged_bwd(
            x, res, _prev_kernel_order(ysf, ysb), dyf.contiguous(),
            dyb.contiguous(), wif2, wib2, wh2, lengths)
        return (_sum_dx(dxf, dxb, x.dtype), *grads, None)


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def gru_merged_layer(x, wif2, wib2, bi2, wh2, bh2, lengths):
    """One bidirectional GRU layer on the merged body, ``(ys_f, ys_b)``:
    dispatched as :func:`gru_bidir_layer` is, through
    :class:`GRUMergedLayerFn` under autograd."""
    weights = (wif2, wib2, bi2, wh2, bh2)
    if _needs_grad(x, *weights):
        return GRUMergedLayerFn.apply(x, *weights, lengths)
    return gru_merged_fwd(x, *weights, lengths)


def lstm_merged_fwd(x, wif2, wib2, bi2, wh2, lengths, train=False):
    """Row 7's wrapper.  A CPU tensor takes the plain version; a CUDA tensor
    launches ``csrc/lstm_bidir_fwd.cu``'s merged form (row 3's recurrence
    with the merged addressing) or raises.  Like row 5's kernel it reads
    only the diagonal blocks of ``wh2``.  ``launches`` counts
    eval-form launches, ``train_launches`` train-form ones."""
    if x.device.type == "cpu":
        return lstm_merged_layer_ref(x, wif2, wib2, bi2, wh2, lengths,
                                     train=train)
    if x.device.type != "cuda":
        raise _no_kernel("lstm_merged_fwd", x)
    t_len, b, w_in, h = _merged_dims("lstm_merged_fwd", x, wh2)
    _check_tensors("lstm_merged_fwd", x.dtype, _merged_expect(
        t_len, b, w_in, h, 4, "x", "wif2", "wib2", "bi2", "wh2", "lengths"),
        (x, wif2, wib2, bi2, wh2, lengths))
    ysf = torch.empty((t_len, b, h), dtype=x.dtype, device=x.device)
    ysb = torch.empty_like(ysf)
    cs = res = None
    if train:
        cs = torch.empty((t_len, b, 2 * h), dtype=x.dtype, device=x.device)
        res = torch.empty((t_len, b, 10 * h), dtype=x.dtype, device=x.device)
    xg = torch.empty((2, t_len * b, 4 * h), dtype=torch.float32,
                     device=x.device)
    _launch("lstm_merged_fwd", x, _DTYPE_CODE[x.dtype], x.data_ptr(),
            wif2.data_ptr(), wib2.data_ptr(), bi2.data_ptr(), wh2.data_ptr(),
            lengths.data_ptr(), ysf.data_ptr(), ysb.data_ptr(), _ptr(cs),
            _ptr(res), xg.data_ptr(), t_len, b, w_in, h, int(train))
    if train:
        lstm_merged_fwd.train_launches += 1
        return ysf, ysb, cs, res
    lstm_merged_fwd.launches += 1
    return ysf, ysb


lstm_merged_fwd.launches = 0
lstm_merged_fwd.train_launches = 0


def lstm_merged_bwd(x, res, hp2, cp2, dyf, dyb, wif2, wib2, wh2, lengths):
    """Row 8's wrapper.  A CPU tensor takes the plain version; a CUDA tensor
    launches ``csrc/lstm_merged_bwd.cu`` or raises.  Returns ``(dx_f,
    dx_b, dwif, dwib, dbi2, dwh2)``; ``launches`` counts launches.  Its
    carry product reads only the diagonal blocks of ``wh2``."""
    args = (x, res, hp2, cp2, dyf, dyb, wif2, wib2, wh2, lengths)
    if x.device.type == "cpu":
        return lstm_merged_layer_bwd_ref(*args)
    if x.device.type != "cuda":
        raise _no_kernel("lstm_merged_bwd", x)
    t_len, b, w_in, h = _merged_dims("lstm_merged_bwd", x, wh2)
    _check_tensors("lstm_merged_bwd", x.dtype, _merged_expect(
        t_len, b, w_in, h, 4, "x", "res", "hp2", "cp2", "dyf", "dyb", "wif2",
        "wib2", "wh2", "lengths"), args)
    dt = x.dtype
    dxf, dxb = torch.empty_like(x), torch.empty_like(x)
    dwif, dwib = (torch.empty_like(wif2), torch.empty_like(wib2))
    dbi2 = torch.empty(8 * h, dtype=dt, device=x.device)
    dwh2 = torch.empty_like(wh2)
    # f32 scratch: the chain's gate gradients, per direction in time order
    # and in kernel order, gate-grouped; the per-row bias sums
    dg = torch.empty((2, t_len * b, 4 * h), dtype=torch.float32,
                     device=x.device)
    dg2 = torch.empty((t_len * b, 8 * h), dtype=torch.float32,
                      device=x.device)
    bias_part = torch.empty((b, 8 * h), dtype=torch.float32, device=x.device)
    _launch("lstm_merged_bwd", x, _DTYPE_CODE[dt],
            *(t.data_ptr() for t in args), dxf.data_ptr(), dxb.data_ptr(),
            dwif.data_ptr(), dwib.data_ptr(), dbi2.data_ptr(),
            dwh2.data_ptr(), dg.data_ptr(), dg2.data_ptr(),
            bias_part.data_ptr(), t_len, b, w_in, h)
    lstm_merged_bwd.launches += 1
    return dxf, dxb, dwif, dwib, dbi2, dwh2


lstm_merged_bwd.launches = 0


class LSTMMergedLayerFn(torch.autograd.Function):
    """Row 7's train form, backward through row 8: the counterpart of
    ``lstm_bidir_fused``'s ``custom_vjp``."""

    @staticmethod
    def forward(ctx, x, wif2, wib2, bi2, wh2, lengths):
        ysf, ysb, cs, res = lstm_merged_fwd(x, wif2, wib2, bi2, wh2, lengths,
                                            train=True)
        ctx.save_for_backward(x, wif2, wib2, wh2, lengths, ysf, ysb, cs, res)
        return ysf, ysb

    @staticmethod
    def backward(ctx, dyf, dyb):
        x, wif2, wib2, wh2, lengths, ysf, ysb, cs, res = ctx.saved_tensors
        cp2 = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
        dxf, dxb, *grads = lstm_merged_bwd(
            x, res, _prev_kernel_order(ysf, ysb), cp2, dyf.contiguous(),
            dyb.contiguous(), wif2, wib2, wh2, lengths)
        return (_sum_dx(dxf, dxb, x.dtype), *grads, None)


def lstm_merged_layer(x, wif2, wib2, bi2, wh2, lengths):
    """One bidirectional LSTM layer on the merged body, ``(ys_f, ys_b)``,
    through :class:`LSTMMergedLayerFn` under autograd."""
    weights = (wif2, wib2, bi2, wh2)
    if _needs_grad(x, *weights):
        return LSTMMergedLayerFn.apply(x, *weights, lengths)
    return lstm_merged_fwd(x, *weights, lengths)
