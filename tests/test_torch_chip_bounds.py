"""``chip_smoke.py``'s bound of the flash kernels (``flash_bound``), the
least time the card could take for their work: the operations run on the
tensor cores, bf16 at its peak and f32 as 3xTF32 (three TF32 products for
each f32 one) at the TF32 peak; the bytes are each operand read and each
output written once.  Arithmetic on shapes only: no card.  And its
summary of the build's ``-Xptxas -v`` output for the flash kernels that
must run on wgmma (``ptxas_summary``), on a log of that form."""

import importlib.util
from pathlib import Path

import pytest

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
CS = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(CS)

# attn's serving main path: B=3, T=1280, H=4, d=100
LENGTHS, T, H, D = [1280, 1100, 1024], 1280, 4, 100


@pytest.mark.parametrize("dt_name,rate", [("float32", 495e12 / 3),
                                          ("bfloat16", 989e12)])
def test_flash_bound_reads_the_tensor_cores_work(dt_name, rate):
    """The forward (2 products) at the serving shape is bound by its
    operations: 2 * 2 * H * T * d * sum(lengths) at the dtype's rate."""
    ms, by = CS.flash_bound(LENGTHS, T, dt_name, 2, 4, 0, 1)
    flops = 2 * 2 * H * T * D * sum(LENGTHS)
    assert by == "operations"
    assert ms == pytest.approx(flops / rate * 1e3, rel=1e-12)


def test_flash_bound_counts_each_byte_once():
    """With one valid key a video the bytes bound it: 4 operands of the
    input dtype, lse in f32 and the key mask."""
    ms, by = CS.flash_bound([1, 1, 1], T, "bfloat16", 2, 4, 0, 1)
    n_bytes = 4 * 2 * 3 * H * T * D + 3 * H * T * 4 + 3 * T
    assert by == "bytes"
    assert ms == pytest.approx(n_bytes / 3.35e12 * 1e3, rel=1e-12)


# bigru's layer 0 in training: B=8, T=1920, W=400, H=128
B8, T8, W0, H0 = 8, 1920, 400, 128


@pytest.mark.parametrize("dt_name,rate", [("float32", 495e12 / 3),
                                          ("bfloat16", 989e12)])
def test_gru_bwd_bound_reads_the_tensor_cores_and_the_chain(dt_name, rate):
    """The bound of row 2 (the GRU layer's backward), row 4 (the LSTM's)
    and row 6 (the merged GRU's): the products off the chain (dwi, dx,
    dwh: 4*T*B*gH*(2W + H); row 6's dwh2 twice row 2's dwh, its
    off-diagonal half too) at the tensor cores' rate for the dtype, plus
    the chain's carry product (4*T*B*gH*H) at the f32 SIMT peak; the count
    with every operation at the dtype's old peak stays beside it
    (``simt=True``).  Row 8 (the merged LSTM's, SIMT products) keeps that
    count."""
    for row in ("2", "4", "6"):
        cell = CS.Cell("lstm" if row == "4" else "gru")
        g = cell.n_gates * H0
        hidden = 2 * H0 if row == "6" else H0
        products = 4 * T8 * B8 * g * (2 * W0 + hidden)
        chain = 4 * T8 * B8 * g * H0
        bound = cell.merged_bound_bwd if row == "6" else cell.bound_bwd
        ms, by = bound(T8, B8, W0, dt_name)
        assert by == "operations", row
        assert ms == pytest.approx((products / rate + chain / 67e12) * 1e3,
                                   rel=1e-12), row
        old = (products + chain) / CS.PEAK_FLOPS[dt_name] * 1e3
        simt, _ = bound(T8, B8, W0, dt_name, simt=True)
        assert simt >= old * (1 - 1e-12), row  # bytes may bound it in bf16
        if dt_name == "float32":
            assert simt == pytest.approx(old, rel=1e-12) and simt > ms, row
    lstm = CS.Cell("lstm")
    assert lstm.merged_bound_bwd(T8, B8, W0, dt_name) == \
        lstm.merged_bound_bwd(T8, B8, W0, dt_name, simt=True)


@pytest.mark.parametrize("dt_name,rate,carry", [
    ("float32", 495e12 / 3, 67e12), ("bfloat16", 989e12, 989e12)])
def test_lstm_scan_bwd_saved_bound_reads_dwh_on_the_tensor_cores(
        dt_name, rate, carry):
    """Row 15's bound (``scan_bound``): dwh (2*T*B*W*4W) at the tensor
    cores' rate for the dtype, the chain's carry product (as many) at the
    f32 SIMT peak in f32 and at bf16's peak in bf16, against its bytes
    (res, hp, cp, dy in, dxg out, wh in, dwh out); the SIMT count beside it
    (``simt=True``) is the old one, both products at the dtype's peak, the
    same in bf16; no other row's bound moves."""
    for t, b, w in ((1920, 8, 256), (1024, 64, 256)):
        size = 4 if dt_name == "float32" else 2
        product = 2 * t * b * w * 4 * w
        n_bytes = (t * b * w * 12 + 2 * 4 * w * w) * size
        ms, by = CS.scan_bound("lstm_scan_bwd_saved", t, b, w, dt_name)
        want = max(n_bytes / 3.35e12, product / rate + product / carry) * 1e3
        assert ms == pytest.approx(want, rel=1e-12)
        assert by == ("operations" if n_bytes / 3.35e12 * 1e3 < ms
                      else "bytes")
        simt, _ = CS.scan_bound("lstm_scan_bwd_saved", t, b, w, dt_name,
                                simt=True)
        old = max(n_bytes / 3.35e12,
                  2 * product / CS.PEAK_FLOPS[dt_name]) * 1e3
        assert simt == pytest.approx(old, rel=1e-12)
        if dt_name == "float32":
            assert ms < simt
        else:  # no looser than the old count: bytes-bound at B=8
            assert ms == pytest.approx(simt, rel=1e-12)
            assert (t, b) != (1920, 8) or by == "bytes"
        for name in ("lstm_scan_bwd", "lstm_scan_fwd", "gru_scan_fwd"):
            assert CS.scan_bound(name, t, b, w, dt_name) == CS.scan_bound(
                name, t, b, w, dt_name, simt=True)


@pytest.mark.parametrize("dt_name,rate,carry", [
    ("float32", 495e12 / 3, 67e12), ("bfloat16", 989e12, 989e12)])
def test_gru_scan_bwd_saved_bound_reads_dwh_on_the_tensor_cores(
        dt_name, rate, carry):
    """Row 11's bound (``scan_bound``), as row 15's: dwh (2*T*B*W*3W) at the
    tensor cores' rate for the dtype, the chain's carry product (as many)
    at the f32 SIMT peak in f32 and at bf16's peak in bf16, against its
    bytes (res, hp, dy in, dxg out, wh and bh in, dwh and dbh out); the SIMT
    count beside it (``simt=True``) is the old one, both products at the
    dtype's peak; no other row's bound moves (row 12, the recompute form,
    keeps its SIMT dwh and count)."""
    for t, b, w in ((1920, 8, 256), (1920, 8, 1024), (1024, 64, 256)):
        size = 4 if dt_name == "float32" else 2
        product = 2 * t * b * w * 3 * w
        n_bytes = (t * b * w * 9 + 2 * (3 * w * w + 3 * w)) * size
        ms, by = CS.scan_bound("gru_scan_bwd_saved", t, b, w, dt_name)
        want = max(n_bytes / 3.35e12, product / rate + product / carry) * 1e3
        assert ms == pytest.approx(want, rel=1e-12)
        assert by == ("operations" if n_bytes / 3.35e12 * 1e3 < ms
                      else "bytes")
        simt, _ = CS.scan_bound("gru_scan_bwd_saved", t, b, w, dt_name,
                                simt=True)
        old = max(n_bytes / 3.35e12,
                  2 * product / CS.PEAK_FLOPS[dt_name]) * 1e3
        assert simt == pytest.approx(old, rel=1e-12)
        if dt_name == "float32":
            assert ms < simt
        else:
            assert ms == pytest.approx(simt, rel=1e-12)
        for name in ("gru_scan_bwd", "gru_scan_fwd", "gru_scan_fwd_save",
                     "lstm_scan_bwd"):
            assert CS.scan_bound(name, t, b, w, dt_name) == CS.scan_bound(
                name, t, b, w, dt_name, simt=True)


# the shape of nvcc's -Xptxas -v output for two of the split's kernels
_DQ = ("_ZN12_GLOBAL__N_119flash_bwd_dq_kernelIfLi2ELi2EEEvNS_7BwdArgsENS_9"
       "SplitPlanE")
_DKDV = ("_ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelIfLi1EEEvNS_7BwdArgsENS_9"
         "SplitPlanE")
_PTXAS = f"""ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to insufficient register resources for the \
function '{_DKDV}'
ptxas info    : Compiling entry function '{_DQ}' for 'sm_90a'
ptxas info    : Function properties for {_DQ}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers, 208 bytes smem
ptxas info    : Compiling entry function '{_DKDV}' for 'sm_90a'
ptxas info    : Function properties for {_DKDV}
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 208 bytes smem
"""


@pytest.mark.parametrize("kernel,want", [
    ("flash_bwd_dq_kernel", ["0 bytes spill stores", "Used 168 registers"]),
    ("flash_bwd_dkdv_kernel", ["4 bytes spill stores", "Used 255 registers",
                               "wgmma serialized (C7512)"])])
def test_ptxas_summary_reads_registers_spills_and_serialization(kernel, want):
    """One line for each instantiation of a wgmma kernel, holding its
    spills, its registers and, where ptxas said so, that its wgmma were
    serialized."""
    lines = [line for line in CS.ptxas_summary({"flash_bwd": _PTXAS})
             if f"] {kernel} (" in line]
    assert len(lines) == 1
    for text in want:
        assert text in lines[0]
    assert len(CS.ptxas_summary({"flash_bwd": _PTXAS})) == 2
