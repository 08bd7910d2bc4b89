"""Fused AM envelope chain: the Hopper kernel, its wrappers and its plain
versions, for both fronts.

Counterpart of ``gsdr_tpu/kernels/fm_chain_pallas.py``'s AM chain
(``am_chain_pallas`` with the dense front, ``pfb_am_chain_pallas`` with the
PFB front). One call maps a tail-prepended planar RF buffer of Nb samples
to audio (C, M) in [-1, 1], M = (Nb - T)//D + 1: the front, the LO rotor
and the envelope 2*clip(|y|, 0, 1) - 1. The chain carries nothing past the
caller's raw RF tail.

The plain versions run the rotor, op for op as the JAX chain; the kernel
leaves it out, because a unit phasor does not change the magnitude.
``am_chain`` and ``pfb_am_chain`` launch ``csrc/am_chain.cu`` for CUDA
tensors and take the plain versions only for tensors on the CPU; the
dense front takes any T and D, its taps staged in chunks where the whole
bank does not fit a block (``chain.dense_chunk``), and the PFB front any
grid with D | K the JAX package's plans take, its lanes and fold taps
staged in chunks where its bank, taps or window do not fit
(``chain.pfb_chunk``), at the bf16 grades in blocks of 256, 128 or 64 rows
by the call's outputs and channels and the card's SMs
(``chain.pfb_block``). Both fronts run at a
grade (``precision``), as in ``fm_chain``: 'bf16x3' (the
kernels' default, as ``am_chain_pallas``'s), 'bf16x2', 'f32'; the plain
versions emulate it and default to 'f32'. Where tracing counts
(``utils/profiling.py``, COUNTERS), the PFB front's chunked launch at
'bf16x3' takes the counted instantiation (``csrc/clocks.cuh``), which adds
its clocks into ``pfb_counters``.
"""

import ctypes
import functools

import torch

from gsdr_tpu_torch.kernels.chain import (
    CHAIN_CLOCKS,
    PFB_ROWS,
    ChainKernel,
    check_operands,
    check_pfb_tables,
    counted_launch,
    cuda_error,
    dense_chunk,
    dense_f32_tables,
    dense_mma_tables,
    grade_code,
    graded_bank_front,
    graded_uniform_front,
    load_chain_library,
    pfb_launch_plan,
    pfb_operands,
)
from gsdr_tpu_torch.ops.channelize import rotate_bank
from gsdr_tpu_torch.ops.quad_demod import quad_am_demod
from gsdr_tpu_torch.utils.profiling import KernelCounters


def am_chain_reference(buf, tap_bank, lo_table, n0_rot, decimation,
                       precision="f32"):
    """The unfused chain with the dense front at the grade ``precision``
    (``graded_bank_front``; at 'f32' mix_fir_decimate_bank in full
    float32), then rotate_bank, quad_am_demod.

    Args:
      buf: planar (Nb,) RF including the (T-1)-sample history.
      tap_bank: (2C, 2, T) float32 (make_complex_tap_bank).
      lo_table: (C, 4) float32 digit-fraction table (phase_digit_table).
      n0_rot: int32 scalar tensor, global raw-sample index of window 0 mod Fs.
      decimation: D.
      precision: 'f32', 'bf16x3' or 'bf16x2'.
    """
    y = graded_bank_front(buf, tap_bank, decimation, precision)
    return quad_am_demod(rotate_bank(y, lo_table, n0_rot, decimation))


def pfb_am_chain_reference(buf, poly_taps, dft_bank, num_taps, lo_table,
                           n0_rot, decimation, precision="f32"):
    """The unfused chain with the PFB front at the grade ``precision``
    (``graded_uniform_front`` on its (Q, K) and (2C, 2K) tables), then
    rotate_bank, quad_am_demod."""
    y = graded_uniform_front(buf, poly_taps, dft_bank, num_taps, decimation,
                             precision)
    return quad_am_demod(rotate_bank(y, lo_table, n0_rot, decimation))


@functools.lru_cache(maxsize=None)
def _library():
    """The built am_chain library, its launch signatures declared."""
    lib = load_chain_library("am_chain")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.am_chain_launch.argtypes = [p] * 5 + [i] * 7 + [p]
    lib.am_chain_launch.restype = i
    lib.pfb_am_chain_launch.argtypes = [p] * 5 + [i] * 11 + [p, p]
    lib.pfb_am_chain_launch.restype = i
    return lib


# The counted PFB kernel's counters (kernels/chain.py, CHAIN_CLOCKS): no
# look-back, so no poll clocks or polls
pfb_counters = KernelCounters(
    "pfb_am_chain", (None if f in ("poll_clocks", "polls") else f
                     for f in CHAIN_CLOCKS))


def _launch(fn, ptrs, ints, buf, c, t, d, grade, plan=(), counted=()):
    """Check the buffer, allocate the audio and launch ``fn`` at ``grade``;
    ``ptrs`` and ``ints`` are the front's tables and sizes, ``plan`` the
    PFB front's (lanes, fold taps, rows), ``counted`` its counter buffer
    (its address, or None: no counted kernel)."""
    dev = buf.re.device
    nb = buf.re.shape[-1]
    check_operands(fn, {"buf.re": (buf.re, (nb,)),
                        "buf.im": (buf.im, (nb,))}, dev)
    if d < 1 or nb < t:
        raise ValueError(f"{fn}: Nb={nb} < T={t} or D={d} < 1")
    lib = _library()
    m = (nb - t) // d + 1
    audio = torch.empty((c, m), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(lib, fn + "_launch")(
            buf.re.data_ptr(), buf.im.data_ptr(), *ptrs, audio.data_ptr(),
            nb, c, *ints, d, m, *plan, grade, stream, *counted)
    cuda_error("am_chain", f"{fn} kernel launch", err)
    return audio


def _launch_dense(buf, tap_bank, lo_table, n0_rot, decimation,
                  precision="bf16x3", chunk=None):
    """The dense-front kernel, on the plain version's arguments; the kernel
    reads no rotor table. ``chunk`` as ``chain.ChainKernel`` says."""
    dev = buf.re.device
    grade = grade_code("am_chain", precision)
    c2, two, t = tap_bank.shape
    if two != 2 or c2 % 2:
        raise ValueError(f"am_chain: tap_bank shape {tuple(tap_bank.shape)}")
    check_operands("am_chain", {"tap_bank": (tap_bank, (c2, 2, t))}, dev)
    m = (buf.re.shape[-1] - t) // max(int(decimation), 1) + 1
    tc = dense_chunk("am_chain", dev, t, decimation, precision, c2 // 2,
                     m) if chunk is None else int(chunk)
    table = dense_mma_tables(tap_bank) if grade \
        else dense_f32_tables(tap_bank)
    ptrs = (None, table.data_ptr()) if grade else (table.data_ptr(), None)
    return _launch("am_chain", ptrs, (t, tc), buf, c2 // 2, t,
                   int(decimation), grade)


def _launch_pfb(buf, poly_taps, dft_bank, num_taps, lo_table, n0_rot,
                decimation, precision="bf16x3", plan=None, rows=None):
    """The PFB-front kernel; ``plan`` and ``rows`` as ``chain.ChainKernel``
    says."""
    dev = buf.re.device
    grade = grade_code("pfb_am_chain", precision)
    c, k, q = check_pfb_tables("pfb_am_chain", poly_taps, dft_bank,
                               num_taps, decimation)
    check_operands("pfb_am_chain", {
        "poly_taps": (poly_taps, (q, k)),
        "dft_bank": (dft_bank, (2 * c, 2 * k))}, dev)
    t = int(num_taps)
    m = (buf.re.shape[-1] - t) // max(int(decimation), 1) + 1
    lanes, uc, rows = pfb_launch_plan("am_chain", dev, k, q, decimation,
                                      precision, plan, c, m, rows)
    taps, btab = pfb_operands(poly_taps, dft_bank, decimation, grade,
                              (lanes, uc))
    counted = counted_launch(pfb_counters, dev, grade, (lanes, uc), k, q)
    out = _launch("pfb_am_chain", (taps.data_ptr(), btab.data_ptr()),
                  (t, k, q), buf, c, t, int(decimation), grade,
                  plan=(lanes, uc, rows), counted=(counted,))
    if grade and (lanes < k or uc < q):
        pfb_am_chain.row_tiles[rows] += 1
    return out


am_chain = ChainKernel("am_chain", am_chain_reference, _launch_dense)
pfb_am_chain = ChainKernel("pfb_am_chain", pfb_am_chain_reference,
                           _launch_pfb, row_tiles=PFB_ROWS)
