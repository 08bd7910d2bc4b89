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
tensors and take the plain versions only for tensors on the CPU.
"""

import ctypes
import functools

import torch

from gsdr_tpu_torch.kernels.chain import (
    ChainKernel,
    check_operands,
    check_pfb_tables,
    cuda_error,
    front_supported,
    load_chain_library,
)
from gsdr_tpu_torch.ops.channelize import mix_fir_decimate_bank, rotate_bank
from gsdr_tpu_torch.ops.pfb import uniform_bank_front
from gsdr_tpu_torch.ops.quad_demod import quad_am_demod


def am_chain_reference(buf, tap_bank, lo_table, n0_rot, decimation):
    """The unfused chain with the dense front: mix_fir_decimate_bank,
    rotate_bank, quad_am_demod, in full float32.

    Args:
      buf: planar (Nb,) RF including the (T-1)-sample history.
      tap_bank: (2C, 2, T) float32 (make_complex_tap_bank).
      lo_table: (C, 4) float32 digit-fraction table (phase_digit_table).
      n0_rot: int32 scalar tensor, global raw-sample index of window 0 mod Fs.
      decimation: D.
    """
    y = mix_fir_decimate_bank(buf, tap_bank, decimation)
    return quad_am_demod(rotate_bank(y, lo_table, n0_rot, decimation))


def pfb_am_chain_reference(buf, poly_taps, dft_bank, num_taps, lo_table,
                           n0_rot, decimation):
    """The unfused chain with the PFB front (mix_fir_decimate_bank_uniform
    on its (Q, K) and (2C, 2K) tables), then rotate_bank, quad_am_demod."""
    y = uniform_bank_front(buf, poly_taps, dft_bank, num_taps, decimation)
    return quad_am_demod(rotate_bank(y, lo_table, n0_rot, decimation))


@functools.lru_cache(maxsize=None)
def _library():
    """The built am_chain library, its launch signatures declared."""
    lib = load_chain_library("am_chain")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.am_chain_launch.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.am_chain_launch.restype = i
    lib.pfb_am_chain_launch.argtypes = [p] * 5 + [i] * 7 + [p]
    lib.pfb_am_chain_launch.restype = i
    return lib


def _launch(fn, ptrs, ints, buf, c, t, d):
    """Check the buffer, allocate the audio and launch ``fn``; ``ptrs`` and
    ``ints`` are the front's tables and sizes."""
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
            nb, c, *ints, d, m, stream)
    cuda_error("am_chain", f"{fn} kernel launch", err)
    return audio


def _launch_dense(buf, tap_bank, lo_table, n0_rot, decimation):
    """The dense-front kernel, on the plain version's arguments; the kernel
    reads no rotor table."""
    dev = buf.re.device
    c2, two, t = tap_bank.shape
    if two != 2 or c2 % 2:
        raise ValueError(f"am_chain: tap_bank shape {tuple(tap_bank.shape)}")
    check_operands("am_chain", {"tap_bank": (tap_bank, (c2, 2, t))}, dev)
    if not front_supported("am_chain", dev, t, decimation):
        raise ValueError(f"am_chain: a block for T={t}, D={decimation} does "
                         f"not fit the card's shared memory")
    return _launch("am_chain", (tap_bank.data_ptr(),), (t,), buf, c2 // 2, t,
                   int(decimation))


def _launch_pfb(buf, poly_taps, dft_bank, num_taps, lo_table, n0_rot,
                decimation):
    dev = buf.re.device
    c, k, q = check_pfb_tables("pfb_am_chain", "am_chain", poly_taps,
                               dft_bank, num_taps, decimation)
    check_operands("pfb_am_chain", {
        "poly_taps": (poly_taps, (q, k)),
        "dft_bank": (dft_bank, (2 * c, 2 * k))}, dev)
    t = int(num_taps)
    return _launch("pfb_am_chain", (poly_taps.data_ptr(), dft_bank.data_ptr()),
                   (t, k, q), buf, c, t, int(decimation))


am_chain = ChainKernel("am_chain", am_chain_reference, _launch_dense)
pfb_am_chain = ChainKernel("pfb_am_chain", pfb_am_chain_reference,
                           _launch_pfb)
