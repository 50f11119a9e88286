"""The LSTM and GRU scans: the hand-written Hopper kernels
(``csrc/lstm_scan_fwd.cu``, ``csrc/lstm_scan_bwd.cu``,
``csrc/gru_scan_fwd.cu``, ``csrc/gru_scan_bwd.cu``), their plain PyTorch
versions, and the ``torch.autograd.Function`` of each that ties the
training forward to its backward.  The GRU section, below the LSTM's, has
its own notes.

LSTM: counterpart of the LSTM half of ``pytorch_video_action_tpu/ops/
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
from typing import NamedTuple

import torch

from .rnn_fused import (_acc, _ceil, _check_tensors, _CHUNK, _DTYPE_CODE,
                        _no_kernel, _sms, slice_chunks)

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


# The register-resident chain's geometry (csrc/scan_chain.cuh, which checks
# what it is given against its own kThreads, kRegWords and kSmem), shared by
# both scans' forwards and saved-gates backwards: threads a block at most,
# weights a thread keeps in registers (as f32 in either dtype), the dynamic
# shared memory a block may take, the chains' block counts and rows, and
# the rows a chain whose threads take units in rounds
FWD_THREADS = 256
FWD_REG_VALS = 128
FWD_SMEM = 225 * 1024
_FWD_NC = (1, 2, 4, 8, 16)
_FWD_ROWS = (1, 2, 3, 4, 6, 8)
_FWD_ROWS_ROUNDS = (1, 2, 4)


class FwdGeometry(NamedTuple):
    """A launch of a chain kernel: ``nc`` blocks a chain, ``s`` depth
    slices a weight vector (thread (unit, lane group, slice), U = ceil(W /
    nc) units a block, ceil(U / rounds) of them a round, 4 lane groups a
    unit: the LSTM's gates, the GRU's three and an idle one, the LSTM
    backward's column chunks of wh's row), ``rows`` batch rows a chain,
    ``depth`` of a slice (a multiple of 8), of it ``ls`` read from shared
    memory after the registers' (the rest, if any, from L2), ``threads`` and
    ``smem`` bytes a block, and ``rounds``, the units a thread takes in turn
    each step (past 1, every weight is read through L2 and the carry is
    kept in shared memory), and ``gx``: the input's two buffers in device
    memory instead of shared memory (one row a chain, in rounds; the
    saved-gates backwards' where even one row's 4W or 3W gradients pass the
    shared memory)."""
    nc: int
    s: int
    rows: int
    depth: int
    ls: int
    threads: int
    smem: int
    rounds: int = 1
    gx: int = 0


# scan_common.cuh's chains (rows 12 and 16): threads a block, rows a
# chain at most, (row, unit) pairs a thread (and in the one-row forms),
# the dynamic shared memory; the forms, where the gate gradients cross
# the cluster
SCAN_THREADS = 256
SCAN_MAX_ROWS = 8
SCAN_PAIRS, SCAN_WIDE_PAIRS = 2, 8
SCAN_FORMS = ("full", "one", "gx")


class ScanForm(NamedTuple):
    """A launch of a scan_common.cuh kernel: ``cluster`` blocks a chain,
    ``rows`` batch rows a chain and its ``form``: up to 8 rows with the
    gradients crossing the cluster in shared memory ("full"), one row so
    ("one"), or one row with them in device memory ("gx"), the first
    whose buffers fit."""
    cluster: int
    rows: int
    form: str


def _round4(n):
    return -(-n // 4) * 4


def scan_form(entry, b, w) -> ScanForm:
    """The launch of ``entry`` (``gru_scan_bwd`` or ``lstm_scan_bwd``, the
    recompute backwards) for ``b`` rows of width ``w``: its buffers other
    than the resident weights, as the kernel lays them out (f32: the
    gradients' two buffers unless "gx", the product's partial sums, the
    carries, hp's row and the LSTM's gates), within the shared memory.
    Raises ValueError where none fits."""
    nc = cluster_size(w)
    u = -(-w // nc)
    gates = _GATES if entry == "lstm_scan_bwd" else 3
    g = _round4(gates * w)

    def fixed(rm, gx):
        floats = ((0 if gx else 2 * rm * g) + rm * max(gates * u, 256)
                  + 2 * rm * u + rm * _round4(w)
                  + (rm * gates * u if entry == "lstm_scan_bwd" else 0))
        return 4 * _round4(floats)  # bytes, to 16

    rows = max(1, min(b, SCAN_MAX_ROWS, SCAN_PAIRS * SCAN_THREADS // u))
    if rows * u <= SCAN_PAIRS * SCAN_THREADS and \
            fixed(SCAN_MAX_ROWS, False) <= FWD_SMEM:
        return ScanForm(nc, rows, "full")
    if u <= SCAN_WIDE_PAIRS * SCAN_THREADS:
        for form in ("one", "gx"):
            if fixed(1, form == "gx") <= FWD_SMEM:
                return ScanForm(nc, 1, form)
    raise ValueError(f"{entry}: no launch takes W={w}")


def _fwd_layout(w, nc, rounds=1):
    """(slices, depth, threads) of ``nc`` blocks over ``w`` in ``rounds``,
    or None when a block would own no unit or a round more than
    ``FWD_THREADS // 4``."""
    u = -(-w // nc)
    ut = -(-u // rounds)
    if (nc - 1) * u >= w or (rounds - 1) * ut >= u or 4 * ut > FWD_THREADS:
        return None
    s = 1
    while rounds == 1 and s < 8 and 8 * u * s <= FWD_THREADS:
        s *= 2
    depth = (-(-w // s) + 7) // 8 * 8
    return s, depth, (4 * ut * s + 31) // 32 * 32


def chain_row_floats(s, depth, inputs=1):
    """f32 values of one row of a chain kernel's input buffer (``ldh``):
    ``inputs`` vectors of W a row in ``s`` slices of ``depth``."""
    return inputs * s * (max(depth, FWD_REG_VALS) + 4)


def _fwd_smem(rows, s, depth, threads, ls, rounds, size, inputs=1, gx=False,
              carries=1):
    """The kernel's shared memory (``chain_smem``): the input's two buffers
    (``inputs`` vectors of W a row; none with ``gx``) and the mbarriers,
    then the weights' ``ls`` or, in rounds, each thread's ``carries``
    carries."""
    fixed = (0 if gx else 4 * 2 * rows * chain_row_floats(s, depth, inputs))
    return fixed + 16 + (threads * ls * size if rounds == 1
                         else 4 * carries * rounds * rows * threads)


def chain_geometry(b, w, dtype, sms, fits, inputs=1, gx=False, carries=1
                   ) -> FwdGeometry:
    """A chain kernel's launch (the LSTM scan forward's, whose numbers
    follow; with ``inputs`` 4 or 3 the saved-gates backwards', whose input a
    row is 4W or 3W gate gradients, the GRU's with ``carries`` 2 a unit in
    rounds) for ``b`` rows of width ``w`` in
    ``dtype`` on a card of ``sms`` SMs, of which ``fits(nc)`` clusters of
    ``nc`` blocks run at once (below 1: not at all; a cluster lies in one
    GPC, so fewer than ``sms // nc``); ``fits`` is asked only of the block
    counts the pick weighs.  Blocks: the fewest (up to 8, one portable
    cluster) whose registers hold wh's slices, ``FWD_REG_VALS`` a thread
    (W=64: 1; W=256: 8); else the fewest (up to 16) whose registers and
    shared memory hold them (W=512: 16 in f32, 8 in bf16, whose
    shared-memory weights take half the bytes); else the most, the depth
    past both read through L2 (W <= 1024); else the most, each thread
    taking its units in rounds, every weight through L2.  Rows a chain: the
    fewest whose chains all run at once (at most 8; 4 in rounds, and fewer
    where the input's buffers would pass the shared memory).  Where even
    one row's buffers pass it, a kernel that can (``gx``, the saved-gates
    backward) takes them in device memory, one row a chain; else no launch
    takes the width (the widest is :func:`widest_chain`)."""
    size = torch.tensor([], dtype=dtype).element_size()
    chunk = 16 // size  # the shared-memory weights' 16-byte chunks
    counts = {}

    def n_fit(nc):
        if nc not in counts:
            counts[nc] = fits(nc)
        return counts[nc]

    def rows_for(nc, choices):
        return next((r for r in choices if -(-b // r) <= n_fit(nc)),
                    choices[-1])

    def resident(nc):
        """The launch on ``nc`` blocks, one unit a thread, the depth past
        the registers in shared memory as far as it fits; None if no
        layout fits or the card runs no such cluster."""
        lay = _fwd_layout(w, nc)
        if lay is None or n_fit(nc) < 1:
            return None
        s, depth, threads = lay
        most = _FWD_ROWS.index(rows_for(nc, _FWD_ROWS))
        rows = next((r for r in reversed(_FWD_ROWS[:most + 1])
                     if _fwd_smem(r, s, depth, threads, 0, 1, size, inputs)
                     <= FWD_SMEM), None)
        if rows is None:
            return None
        fixed = _fwd_smem(rows, s, depth, threads, 0, 1, size, inputs)
        room = (FWD_SMEM - fixed) // (threads * size) // chunk * chunk
        ls = min(max(depth - FWD_REG_VALS, 0), room)
        return FwdGeometry(nc, s, rows, depth, ls, threads,
                           fixed + threads * ls * size)

    for nc in _FWD_NC[:-1]:  # registers alone
        lay = _fwd_layout(w, nc)
        if lay and lay[1] <= FWD_REG_VALS and (geo := resident(nc)):
            return geo
    for nc in _FWD_NC:  # registers and shared memory
        geo = resident(nc)
        if geo and geo.depth <= FWD_REG_VALS + geo.ls:
            return geo
    for nc in reversed(_FWD_NC):  # the rest through L2
        if geo := resident(nc):
            return geo
    for nc in reversed(_FWD_NC):  # rounds
        u = -(-w // nc)
        rounds = -(-u // (FWD_THREADS // 4))
        lay = _fwd_layout(w, nc, rounds)
        if lay is None or n_fit(nc) < 1:
            continue
        s, depth, threads = lay
        most = _FWD_ROWS_ROUNDS.index(rows_for(nc, _FWD_ROWS_ROUNDS))
        for rows in reversed(_FWD_ROWS_ROUNDS[:most + 1]):
            smem = _fwd_smem(rows, s, depth, threads, 0, rounds, size,
                             inputs, carries=carries)
            if smem <= FWD_SMEM:
                return FwdGeometry(nc, s, rows, depth, 0, threads, smem,
                                   rounds)
        if gx and (smem := _fwd_smem(1, s, depth, threads, 0, rounds, size,
                                     inputs, True, carries)) <= FWD_SMEM:
            return FwdGeometry(nc, s, 1, depth, 0, threads, smem, rounds, 1)
    raise ValueError(f"chain kernel: no launch takes W={w} on this card")


_WIDEST: dict = {}


def widest_chain(dtype, sms, fits, key=None) -> int:
    """The widest W a chain kernel's forward launch takes (the LSTM scan's
    eval forward, row 13, and the GRU scan's, row 9, share it): every
    narrower W has one too, and each scan wrapper refuses a wider one.
    ``key`` caches the answer (a card's index)."""
    if key is not None and (dtype, key) in _WIDEST:
        return _WIDEST[(dtype, key)]

    def takes(w):
        try:
            chain_geometry(1, w, dtype, sms, fits)
        except ValueError:
            return False
        return True

    lo, hi = 0, 1 << 16  # takes(lo), not takes(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if takes(mid) else (lo, mid)
    if key is not None:
        _WIDEST[(dtype, key)] = lo
    return lo


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
    # dtype; xg, wh, ys, cs, res; T, B, W, save, nc, s, rows, ls, rounds;
    # stream
    "lstm_scan_fwd": ([ctypes.c_int] + [ctypes.c_void_p] * 5
                      + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
    # dtype; res, hp, cp, dy, wh, dxg, dwh, dwh's partials, the exchange
    # buffer; T, B, W, nc, s, rows, ls, rounds, gx, slice_chunks; stream
    "lstm_scan_bwd_saved": ([ctypes.c_int] + [ctypes.c_void_p] * 9
                            + [ctypes.c_int] * 10 + [ctypes.c_void_p]),
    # dtype; xg, hp, cp, cs, dy, wh, wh^T, dxg, dwh, dwh's partials, the
    # exchange buffer; T, B, W, cluster, rows, form, slice_chunks; stream
    "lstm_scan_bwd": ([ctypes.c_int] + [ctypes.c_void_p] * 11
                      + [ctypes.c_int] * 7 + [ctypes.c_void_p]),
    # dtype; xg, wh, bh, ys, res (0: the eval form); T, B, W, nc, s, rows,
    # ls, rounds; stream
    "gru_scan_fwd": ([ctypes.c_int] + [ctypes.c_void_p] * 5
                     + [ctypes.c_int] * 8 + [ctypes.c_void_p]),
    # dtype; res, hp, dy, wh, dxg, rnd(dhg), bias_part, the exchange
    # buffer, dwh, dbh, dwh's partials; T, B, W, nc, s, rows, ls, rounds,
    # gx, slice_chunks; stream
    "gru_scan_bwd_saved": ([ctypes.c_int] + [ctypes.c_void_p] * 11
                           + [ctypes.c_int] * 10 + [ctypes.c_void_p]),
    # dtype, recompute (1); xg, hp, dy, wh, wh^T, bh, dxg, dhg, bias_part,
    # the exchange buffer, dwh, dbh; T, B, W, cluster, rows, form; stream
    "gru_scan_bwd": ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 12
                     + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
}


# entry points whose library (csrc/<library>.cu) has another name
_LIBRARY = {"lstm_scan_bwd_saved": "lstm_scan_bwd",
            "gru_scan_bwd_saved": "gru_scan_bwd"}


def _launch(name, x, *args):
    """Call one library's entry point on ``x``'s device and current stream;
    raise when the launch was refused."""
    from . import cuda_lib

    library = _LIBRARY.get(name, name)
    lib = cuda_lib.load(library)
    fn = getattr(lib, name)
    err_string = getattr(lib, f"{library}_error_string")
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


def _check(where, xg, wh, named, width, gates=_GATES, bh=None):
    """Shapes, dtypes, one device and contiguity of the kernels' operands:
    ``xg`` (or ``res``) ``[T, B, width*W]`` with ``wh [W, gates*W]`` (and
    ``bh [gates*W]``) of its dtype, and ``named`` further ``[T, B, W]``
    tensors."""
    if xg.dtype not in _DTYPE_CODE:
        raise TypeError(f"{where}: dtype {xg.dtype} not supported "
                        "(float32 or bfloat16)")
    if xg.dim() != 3 or wh.dim() != 2:
        raise ValueError(f"{where}: expected [T, B, {width}W] and "
                         f"[W, {gates}W], got {tuple(xg.shape)} and "
                         f"{tuple(wh.shape)}")
    t_len, b, _ = xg.shape
    w = wh.shape[0]
    expect = [("xg", (t_len, b, width * w), 1), ("wh", (w, gates * w), 1)]
    expect += [(n, (t_len, b, w), 1) for n, _ in named]
    tensors = [xg, wh, *(t for _, t in named)]
    if bh is not None:
        expect.append(("bh", (gates * w,), 1))
        tensors.append(bh)
    _check_tensors(where, xg.dtype, expect, tensors)
    if t_len < 1 or b < 1:
        raise ValueError(f"{where}: empty sequence")
    return t_len, b, w


_FITS: dict = {}


def _cluster_fits(device):
    """``fits(nc)`` of :func:`chain_geometry` on ``device``: the
    kernel's own occupancy query (``lstm_scan_fwd_clusters``) for blocks of
    256 threads, which take an SM each, as every launch's blocks of 160 or
    more threads do; -1 where the card refuses the size."""
    from . import cuda_lib

    def fits(nc):
        key = (device.index, nc)
        if key not in _FITS:
            lib = cuda_lib.load("lstm_scan_fwd")
            lib.lstm_scan_fwd_clusters.argtypes = [ctypes.c_int]
            with torch.cuda.device(device):
                _FITS[key] = lib.lstm_scan_fwd_clusters(nc)
        return _FITS[key]

    return fits


def check_width(where, w, dtype, sms, fits, key=None):
    """Refuse a W wider than the scans' forward launches take on a card of
    ``sms`` SMs and cluster occupancy ``fits`` (:func:`widest_chain`),
    naming the wrapper ``where``: every scan kernel, forward or backward,
    takes every narrower one."""
    widest = widest_chain(dtype, sms, fits, key)
    if w > widest:
        raise ValueError(f"{where}: W={w} is wider than the scan kernels "
                         f"take on this card (at most {widest}, the "
                         f"forward's widest launch)")


def _check_width(where, w, dtype, device):
    check_width(where, w, dtype, _sms(device), _cluster_fits(device),
                device.index)


def _fwd(xg, wh, save):
    t_len, b, w = _check("lstm_scan_fwd", xg, wh, (), _GATES)
    _check_width("lstm_scan_fwd_save" if save else "lstm_scan_fwd", w,
                 xg.dtype, xg.device)
    ys = torch.empty((t_len, b, w), dtype=xg.dtype, device=xg.device)
    cs = torch.empty_like(ys)
    res = (torch.empty((t_len, b, _RES * w), dtype=xg.dtype, device=xg.device)
           if save else None)
    geo = scan_launch("lstm_scan_fwd", b, w, xg.dtype, xg.device)
    _launch("lstm_scan_fwd", xg, _DTYPE_CODE[xg.dtype], xg.data_ptr(),
            wh.data_ptr(), ys.data_ptr(), cs.data_ptr(),
            0 if res is None else res.data_ptr(), t_len, b, w, int(save),
            geo.nc, geo.s, geo.rows, geo.ls, geo.rounds)
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


def dwh_slices(t_len, b, w, sms, gates=_GATES):
    """``(chunks a K slice, slices)`` of a saved-gates backward's dwh ``[W,
    gates*W]`` over K = T*B on the tensor cores (csrc/rnn_wgmma.cuh's
    dwh_wgmma_kernel, the LSTM scan's with 4 gates, the GRU scan's with 3,
    whose blocks restart their accumulators every 8 chunks of a slice): one
    slice where its 64 x 128 tiles alone fill the card's ``sms`` (more would
    only trim the last wave, at W*4W f32 of partials a slice: 4 GiB for 16
    slices at W=4096), else the tiles' :func:`~.rnn_fused.slice_chunks`."""
    rows = t_len * b
    chunks = _ceil(rows, _CHUNK)
    tiles = _ceil(w, _CHUNK) * _ceil(_ceil(gates * w, _CHUNK), 2)
    depth = chunks if tiles >= sms else slice_chunks(rows, tiles, sms)
    return depth, _ceil(chunks, depth)


# the chain kernels' entry points (csrc/scan_chain.cuh), each with its
# input vectors of W a row: the saved-gates backwards' are the 4W or 3W
# gate gradients (and they may keep them in device memory, gx); the GRU's
# take the LSTM's launch, its three gates' columns (or column chunks of
# wh's row) on three of a unit's four lane groups (the fourth holds no
# weights, so that a unit's lanes divide a warp), and its backward keeps
# two carries a unit in rounds (dh z and dbh's sum)
_CHAIN_INPUTS = {"lstm_scan_fwd": 1, "lstm_scan_fwd_save": 1,
                 "gru_scan_fwd": 1, "gru_scan_fwd_save": 1,
                 "lstm_scan_bwd_saved": 4, "gru_scan_bwd_saved": 3}


def scan_launch(entry, b, w, dtype, device):
    """The launch of a scan kernel's wrapper ``entry`` on ``device``: the
    chain's :class:`FwdGeometry` (rows 9, 10, 11, 13, 14, 15), else the
    :class:`ScanForm` of scan_common.cuh's chain (rows 12, 16)."""
    if entry not in _CHAIN_INPUTS:
        return scan_form(entry, b, w)
    return chain_geometry(b, w, dtype, _sms(device), _cluster_fits(device),
                          _CHAIN_INPUTS[entry],
                          gx=entry.endswith("_bwd_saved"),
                          carries=2 if entry == "gru_scan_bwd_saved" else 1)


def _exchange(form, b, g, device):
    """A "gx" form's exchange buffer, f32 [B, 2, round4(g)] for g gradients
    a row (each step writes its buffer before it reads it), else None."""
    if form.form != "gx":
        return None
    return torch.empty((b, 2, _round4(g)), dtype=torch.float32,
                       device=device)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _bwd(where, first, width, hp, cp, cs, dy, wh):
    named = [("hp", hp), ("cp", cp), ("dy", dy)]
    if cs is not None:
        named.append(("cs", cs))
    t_len, b, w = _check(where, first, wh, named, width)
    _check_width(where, w, first.dtype, first.device)
    dxg = torch.empty((t_len, b, _GATES * w), dtype=first.dtype,
                      device=first.device)
    dwh = torch.empty_like(wh)
    depth, slices = dwh_slices(t_len, b, w, _sms(first.device))
    part = torch.empty((slices, w * _GATES * w), dtype=torch.float32,
                       device=first.device)  # dwh's K-slice partials
    code = _DTYPE_CODE[first.dtype]
    f32 = dict(dtype=torch.float32, device=first.device)
    if cs is None:  # the saved gates, on their chain
        geo = scan_launch(where, b, w, first.dtype, first.device)
        # the gradients' two buffers a row, in device memory (gx): dh_c = 0
        # at the first step, so they start at 0
        xbuf = (torch.zeros((b, 2, chain_row_floats(geo.s, geo.depth,
                                                    _GATES)), **f32)
                if geo.gx else None)
        _launch("lstm_scan_bwd_saved", first, code, first.data_ptr(),
                hp.data_ptr(), cp.data_ptr(), dy.data_ptr(), wh.data_ptr(),
                dxg.data_ptr(), dwh.data_ptr(), part.data_ptr(), _ptr(xbuf),
                t_len, b, w, geo.nc,
                geo.s, geo.rows, geo.ls, geo.rounds, geo.gx, depth)
        return dxg, dwh
    wh_t = wh.t().contiguous()  # [4W, W]: the carry product's operand
    form = scan_form(where, b, w)
    xbuf = _exchange(form, b, _GATES * w, first.device)
    _launch("lstm_scan_bwd", first, code, first.data_ptr(), hp.data_ptr(),
            cp.data_ptr(), cs.data_ptr(), dy.data_ptr(), wh.data_ptr(),
            wh_t.data_ptr(), dxg.data_ptr(), dwh.data_ptr(), part.data_ptr(),
            _ptr(xbuf), t_len, b, w, form.cluster, form.rows,
            SCAN_FORMS.index(form.form), depth)
    return dxg, dwh


def lstm_scan_bwd_saved(res, hp, cp, dy, wh):
    """Row 15, the saved-gates backward's wrapper: ``(dxg, dwh)``.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises.  ``launches`` counts launches."""
    if res.device.type == "cpu":
        return lstm_scan_bwd_saved_ref(res, hp, cp, dy, wh)
    if res.device.type != "cuda":
        raise _no_kernel("lstm_scan_bwd_saved", res)
    out = _bwd("lstm_scan_bwd_saved", res, _RES, hp, cp, None, dy, wh)
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
    out = _bwd("lstm_scan_bwd", xg, _GATES, hp, cp, cs, dy, wh)
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


# ====================================================================== GRU
# Counterpart of the GRU half of ``rnn_pallas.py``: ``_gru_fwd_kernel``
# (the eval form), ``_gru_fwd_save_kernel`` (the training forward, which
# also saves the gates), ``_gru_bwd_saved_kernel`` (the VJP from the saved
# gates) and ``_gru_bwd_kernel`` (the VJP that recomputes them,
# ``PVA_RNN_RECOMPUTE=1``, read as :data:`RECOMPUTE_BWD`), tied together by
# ``gru_scan_pallas``'s ``custom_vjp`` and called through ``gru_scan``.
#
# Layouts: ``xg [T, B, 3W]`` time-major, the input projection with ``bi``
# only, gates r, z, n; ``wh [W, 3W]``; ``bh [3W]``, which stays inside the
# reset gate.  Per step, in f32: ``hg = h @ wh + bh``, ``r = sigmoid(xg_r +
# hg_r)``, ``z = sigmoid(xg_z + hg_z)``, ``n = tanh(xg_n + r hg_n)``, ``h' =
# (1 - z) n + z h``, from ``h = 0``, with no carry freeze (prefix-form
# masks, as the LSTM scan).
#
# Numerics (``rnn_pallas.py:92-256``): ``h`` is rounded to ``wh``'s dtype
# before the hidden product, products accumulate in f32, ``h`` and the gate
# math are f32; ``ys`` and the residuals ``[r, z, n, hg_n]`` are stored in
# ``xg``'s dtype.  The backward carries ``dh`` in f32, forms ``dhg = [dr,
# dz, dn r]`` (``hg_n`` enters ``n`` through ``r``), rounds it to ``wh``'s
# dtype for the carry product and ``dwh`` and ``dxg = [dr, dz, dn]`` to
# ``xg``'s dtype, and sums ``dwh`` (of the rounded ``dhg``) and ``dbh`` (of
# the unrounded one) in f32, returned in the weights' dtype.

_GRU_GATES = 3
_GRU_RES = 4


def gru_scan_ref(xg, wh, bh, save=False):
    """Plain PyTorch version of the forward: ``ys``, and with ``save`` also
    the residuals ``(ys, res [T, B, 4W])``."""
    t_len, b, _ = xg.shape
    w = wh.shape[0]
    dt, acc = xg.dtype, _acc(xg.dtype)
    whf, bhf = wh.to(acc), bh.to(acc)
    h = torch.zeros(b, w, dtype=acc, device=xg.device)
    ys = torch.empty(t_len, b, w, dtype=dt, device=xg.device)
    res = (torch.empty(t_len, b, _GRU_RES * w, dtype=dt, device=xg.device)
           if save else None)
    for t in range(t_len):
        x = xg[t].to(acc)
        hg = torch.matmul(h.to(wh.dtype).to(acc), whf) + bhf
        r = torch.sigmoid(x[:, :w] + hg[:, :w])
        z = torch.sigmoid(x[:, w:2 * w] + hg[:, w:2 * w])
        hg_n = hg[:, 2 * w:]
        n = torch.tanh(x[:, 2 * w:] + r * hg_n)
        h = (1.0 - z) * n + z * h
        ys[t] = h.to(dt)
        if save:
            res[t] = torch.cat([r, z, n, hg_n], dim=-1).to(dt)
    return (ys, res) if save else ys


def _gru_bwd_chain(gate_fn, hp, dy, wh, dxg_dtype):
    """The backward chain over ``t = T-1 .. 0``, ``dwh`` and ``dbh``, from
    ``gate_fn(t) -> (r, z, n, hg_n)`` in the accumulation dtype."""
    t_len, b, w = dy.shape
    acc = _acc(dxg_dtype)
    wdt = wh.dtype
    wh_t = wh.to(acc).t()
    dxg = torch.empty(t_len, b, _GRU_GATES * w, dtype=acc, device=dy.device)
    dhg_c = torch.empty_like(dxg)
    dbh = torch.zeros(_GRU_GATES * w, dtype=acc, device=dy.device)
    dh_c = torch.zeros(b, w, dtype=acc, device=dy.device)
    for t in range(t_len - 1, -1, -1):
        r, z, n, hg_n = gate_fn(t)
        dh = dy[t].to(acc) + dh_c
        dz = dh * (hp[t].to(acc) - n)
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dr = dn * hg_n * r * (1.0 - r)
        dzp = dz * z * (1.0 - z)
        dxg[t] = torch.cat([dr, dzp, dn], dim=-1)
        dhg = torch.cat([dr, dzp, dn * r], dim=-1)
        dhg_c[t] = dhg.to(wdt).to(acc)
        dh_c = dh * z + torch.matmul(dhg_c[t], wh_t)
        dbh = dbh + dhg.sum(0)
    m = t_len * b
    dwh = torch.matmul(hp.reshape(m, w).to(wdt).to(acc).t(),
                       dhg_c.reshape(m, _GRU_GATES * w))
    return dxg.to(dxg_dtype), dwh.to(wdt), dbh.to(wdt)


def gru_scan_bwd_saved_ref(res, hp, dy, wh):
    """Plain PyTorch version of the saved-gates backward: ``(dxg, dwh,
    dbh)`` from the residuals and ``hp``, ``ys`` one step earlier (0 at
    ``t = 0``)."""
    w = wh.shape[0]
    acc = _acc(res.dtype)

    def gate_fn(t):
        r = res[t].to(acc)
        return tuple(r[..., q * w:(q + 1) * w] for q in range(_GRU_RES))

    return _gru_bwd_chain(gate_fn, hp, dy, wh, res.dtype)


def gru_scan_bwd_ref(xg, hp, dy, wh, bh):
    """Plain PyTorch version of the recompute backward: the gates again
    from ``xg[t]`` and ``hp[t] @ wh + bh``."""
    w = wh.shape[0]
    acc = _acc(xg.dtype)
    whf, bhf = wh.to(acc), bh.to(acc)

    def gate_fn(t):
        x = xg[t].to(acc)
        hg = torch.matmul(hp[t].to(acc), whf) + bhf
        r = torch.sigmoid(x[:, :w] + hg[:, :w])
        z = torch.sigmoid(x[:, w:2 * w] + hg[:, w:2 * w])
        n = torch.tanh(x[:, 2 * w:] + r * hg[:, 2 * w:])
        return r, z, n, hg[:, 2 * w:]

    return _gru_bwd_chain(gate_fn, hp, dy, wh, xg.dtype)


def _gru_check(where, first, width, wh, bh, named):
    t_len, b, w = _check(where, first, wh, named, width, _GRU_GATES, bh)
    _check_width(where, w, first.dtype, first.device)
    return t_len, b, w


def _gru_fwd(xg, wh, bh, save):
    where = "gru_scan_fwd_save" if save else "gru_scan_fwd"
    t_len, b, w = _gru_check(where, xg, _GRU_GATES, wh, bh, ())
    ys = torch.empty((t_len, b, w), dtype=xg.dtype, device=xg.device)
    res = (torch.empty((t_len, b, _GRU_RES * w), dtype=xg.dtype,
                       device=xg.device) if save else None)
    geo = scan_launch(where, b, w, xg.dtype, xg.device)
    _launch("gru_scan_fwd", xg, _DTYPE_CODE[xg.dtype], xg.data_ptr(),
            wh.data_ptr(), bh.data_ptr(), ys.data_ptr(), _ptr(res), t_len, b,
            w, geo.nc, geo.s, geo.rows, geo.ls, geo.rounds)
    return (ys, res) if save else ys


def gru_scan_fwd(xg, wh, bh):
    """Row 9, the eval form's wrapper: ``ys``.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises.
    ``launches`` counts launches."""
    if xg.device.type == "cpu":
        return gru_scan_ref(xg, wh, bh)
    if xg.device.type != "cuda":
        raise _no_kernel("gru_scan_fwd", xg)
    out = _gru_fwd(xg, wh, bh, False)
    gru_scan_fwd.launches += 1
    return out


gru_scan_fwd.launches = 0


def gru_scan_fwd_save(xg, wh, bh):
    """Row 10, the training forward's wrapper: ``(ys, res)``; as
    :func:`gru_scan_fwd`."""
    if xg.device.type == "cpu":
        return gru_scan_ref(xg, wh, bh, save=True)
    if xg.device.type != "cuda":
        raise _no_kernel("gru_scan_fwd_save", xg)
    out = _gru_fwd(xg, wh, bh, True)
    gru_scan_fwd_save.launches += 1
    return out


gru_scan_fwd_save.launches = 0


def _gru_bwd(where, first, width, hp, dy, wh, bh):
    t_len, b, w = _gru_check(where, first, width, wh, bh,
                             [("hp", hp), ("dy", dy)])
    g = _GRU_GATES * w
    dxg = torch.empty((t_len, b, g), dtype=first.dtype, device=first.device)
    dwh = torch.empty_like(wh)
    dbh = torch.empty((g,), dtype=wh.dtype, device=wh.device)
    f32 = dict(dtype=torch.float32, device=first.device)
    bias_part = torch.empty((b, g), **f32)  # each row's dbh
    code = _DTYPE_CODE[first.dtype]
    if bh is None:  # the saved gates, on their chain
        geo = scan_launch(where, b, w, first.dtype, first.device)
        depth, slices = dwh_slices(t_len, b, w, _sms(first.device),
                                   _GRU_GATES)
        part = torch.empty((slices, w * g), **f32)  # dwh's K-slice partials
        dhg = torch.empty_like(dxg)  # rnd(dhg), dwh's operand
        # the gradients' two buffers a row, in device memory (gx): dh_c = 0
        # at the first step, so they start at 0
        xbuf = (torch.zeros((b, 2, chain_row_floats(geo.s, geo.depth,
                                                    _GRU_GATES)), **f32)
                if geo.gx else None)
        _launch("gru_scan_bwd_saved", first, code, first.data_ptr(),
                hp.data_ptr(), dy.data_ptr(), wh.data_ptr(), dxg.data_ptr(),
                dhg.data_ptr(), bias_part.data_ptr(), _ptr(xbuf),
                dwh.data_ptr(), dbh.data_ptr(), part.data_ptr(), t_len, b, w,
                geo.nc, geo.s, geo.rows, geo.ls, geo.rounds, geo.gx, depth)
        return dxg, dwh, dbh
    dhg = torch.empty((t_len, b, g), **f32)  # rnd(dhg), dwh's operand
    form = scan_form(where, b, w)
    xbuf = _exchange(form, b, g, first.device)
    wh_t = wh.t().contiguous()  # [3W, W]: the carry product's operand
    _launch("gru_scan_bwd", first, code, 1, first.data_ptr(), hp.data_ptr(),
            dy.data_ptr(), wh.data_ptr(), wh_t.data_ptr(), bh.data_ptr(),
            dxg.data_ptr(), dhg.data_ptr(), bias_part.data_ptr(), _ptr(xbuf),
            dwh.data_ptr(), dbh.data_ptr(), t_len, b, w, form.cluster,
            form.rows, SCAN_FORMS.index(form.form))
    return dxg, dwh, dbh


def gru_scan_bwd_saved(res, hp, dy, wh):
    """Row 11, the saved-gates backward's wrapper: ``(dxg, dwh, dbh)``.  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernels
    (the chain, dwh, the sum of dbh) or raises.  ``launches`` counts
    launches."""
    if res.device.type == "cpu":
        return gru_scan_bwd_saved_ref(res, hp, dy, wh)
    if res.device.type != "cuda":
        raise _no_kernel("gru_scan_bwd_saved", res)
    out = _gru_bwd("gru_scan_bwd_saved", res, _GRU_RES, hp, dy, wh, None)
    gru_scan_bwd_saved.launches += 1
    return out


gru_scan_bwd_saved.launches = 0


def gru_scan_bwd(xg, hp, dy, wh, bh):
    """Row 12, the recompute backward's wrapper: ``(dxg, dwh, dbh)``; as
    :func:`gru_scan_bwd_saved`."""
    if xg.device.type == "cpu":
        return gru_scan_bwd_ref(xg, hp, dy, wh, bh)
    if xg.device.type != "cuda":
        raise _no_kernel("gru_scan_bwd", xg)
    out = _gru_bwd("gru_scan_bwd", xg, _GRU_GATES, hp, dy, wh, bh)
    gru_scan_bwd.launches += 1
    return out


gru_scan_bwd.launches = 0


class GRUScanFn(torch.autograd.Function):
    """The GRU scan under autograd, ``xg, wh, bh -> ys``: the counterpart
    of ``gru_scan_pallas``'s ``custom_vjp``.  The forward saves the gates
    (row 10, backward row 11), or with :data:`RECOMPUTE_BWD` only ``ys``
    (row 9, backward row 12)."""

    @staticmethod
    def forward(ctx, xg, wh, bh):
        ctx.recompute = RECOMPUTE_BWD
        if ctx.recompute:
            ys = gru_scan_fwd(xg, wh, bh)
            ctx.save_for_backward(xg, wh, bh, ys)
        else:
            ys, res = gru_scan_fwd_save(xg, wh, bh)
            ctx.save_for_backward(res, wh, bh, ys)
        return ys

    @staticmethod
    def backward(ctx, dy):
        first, wh, bh, ys = ctx.saved_tensors
        hp = _shift(ys)
        dy = dy.contiguous()
        if ctx.recompute:
            return gru_scan_bwd(first, hp, dy, wh, bh)
        return gru_scan_bwd_saved(first, hp, dy, wh)


def gru_scan(xg_tm, wh, bh, mask_tm):
    """Masked ``ys [T, B, W]`` of the GRU scan over ``xg_tm [T, B, 3W]``
    (``mask_tm [T, B, 1]``, prefix-form): the eval form when grad mode is
    off or nothing requires a gradient, else :class:`GRUScanFn`.  Kernels
    on CUDA tensors, plain versions on CPU tensors; neither falls back to
    the other."""
    xg_tm = xg_tm.contiguous()
    if torch.is_grad_enabled() and (xg_tm.requires_grad or wh.requires_grad
                                    or bh.requires_grad):
        ys = GRUScanFn.apply(xg_tm, wh, bh)
    else:
        ys = gru_scan_fwd(xg_tm, wh, bh)
    return ys * mask_tm
