"""Fused FM receive chain: the Hopper kernel, its wrappers and its plain
versions, for both fronts.

Counterpart of ``gsdr_tpu/kernels/fm_chain_pallas.py`` (``fm_chain_pallas``
with the dense front, ``pfb_fm_chain_pallas`` with the PFB front). One call
runs, over a tail-prepended planar RF buffer of Nb samples, the front (the
complex-tap-bank mix + FIR + decimate, or on a uniform Fs/K grid the
polyphase fold + DFT bank), the LO rotor, the quadrature discriminator with
its carried previous sample and the TDF-II de-emphasis with its carried
state, and returns (audio (C, M), carry_f', carry_z') with
M = (Nb - T)//D + 1 -- the state leaves of ``FmChannelizer``, exported at
the last output. Both fronts share the state, so a stream may switch
between them at any block.

``fm_chain`` and ``pfb_fm_chain`` launch ``csrc/fm_chain.cu`` for CUDA
tensors, one grid launch a call (the de-emphasis start state of each tile
by a decoupled look-back over a per-stream scratch that no call resets,
``chain.LookBackScratch``), and take their plain versions,
``fm_chain_reference`` and ``pfb_fm_chain_reference``, only for tensors on
the CPU. The dense front takes any T and D: its block stages the taps in
chunks where the whole bank does not fit (``chain.dense_chunk``); the PFB
front takes any grid with D | K the JAX package's plans take: its block
stages the lanes and fold taps in chunks where the whole bank, taps or
window do not fit (``chain.pfb_chunk``), at the bf16 grades in blocks of
256, 128 or 64 rows by the call's outputs and channels and the card's SMs
(``chain.pfb_block``). Either front runs at a grade
(``precision``, the JAX package's): 'bf16x3', the kernels' default as it
is ``fm_chain_pallas``'s and
``pfb_fm_chain_pallas``'s, and 'bf16x2' on the tensor cores, 'f32' on the
FP32 FMAs; the plain versions emulate the grade
(``chain.graded_bank_front``, ``chain.graded_uniform_front``) and default
to 'f32' (``chain.ChainKernel`` says why). Where tracing counts
(``utils/profiling.py``, COUNTERS), the PFB front's chunked launch at
'bf16x3' takes the counted instantiation (``csrc/clocks.cuh``), which adds
its clocks into ``pfb_counters``.
"""

import ctypes
import functools

import torch

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.kernels.chain import (
    CHAIN_CLOCKS,
    PFB_ROWS,
    ChainKernel,
    LookBackScratch,
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
from gsdr_tpu_torch.ops.iir import iir_block
from gsdr_tpu_torch.ops.quad_demod import quad_fm_demod
from gsdr_tpu_torch.utils.profiling import KernelCounters

_DEEMPH_BLOCK_LEN = 256


def deemphasis_triple(b, a):
    """The chain's de-emphasis operand (b0, cc, a') of a first-order IIR
    (b0, b1), (a0, a1): the TDF-II recursion z[j] = cc*d[j] + a'*z[j-1],
    out[j] = b0*d[j] + z[j-1] with cc = b1 - a1*b0 and a' = -a1, after
    normalizing by a0. The identity filter b = (1, 0), a = (1, 0) gives
    (1, 0, 0); the bilinear de-emphasis, whose b1 equals b0, gives
    (b0, b0 - a1*b0, -a1)."""
    a0 = float(a[0])
    b0, b1 = float(b[0]) / a0, float(b[1]) / a0
    a1 = float(a[1]) / a0
    return (b0, b1 - a1 * b0, -a1)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _fm_back_end(y, lo_table, n0_rot, decimation, gain, deemph, carry_f,
                 carry_z):
    """Rotor, discriminator and de-emphasis of the unfused chain."""
    filt = rotate_bank(y, lo_table, n0_rot, decimation)
    disc_in = ComplexArray(torch.cat([carry_f.re, filt.re], dim=-1),
                           torch.cat([carry_f.im, filt.im], dim=-1))
    demod = quad_fm_demod(disc_in, gain)
    # contiguous, so that the state can feed the kernel on the next step
    new_carry = ComplexArray(disc_in.re[..., -1:].contiguous(),
                             disc_in.im[..., -1:].contiguous())
    b0, cc, a = deemph[0], deemph[1], deemph[2]
    b = torch.stack([b0, cc - a * b0])
    a_vec = torch.stack([torch.ones_like(a), -a])
    audio, new_zi = iir_block(b, a_vec, demod, zi=carry_z,
                              block_len=_DEEMPH_BLOCK_LEN)
    return audio, new_carry, new_zi


def fm_chain_reference(buf, tap_bank, lo_table, n0_rot, decimation, gain,
                       deemph, carry_f, carry_z, precision="f32"):
    """The unfused chain with the dense front, op by op, in full float32,
    the front at the grade ``precision`` (``graded_bank_front``).

    Args:
      buf: planar (Nb,) RF including the (T-1)-sample history.
      tap_bank: (2C, 2, T) float32 (make_complex_tap_bank).
      lo_table: (C, 4) float32 digit-fraction table (phase_digit_table).
      n0_rot: int32 scalar tensor, global raw-sample index of window 0 mod Fs.
      decimation, gain: chain constants.
      deemph: (3,) float32 tensor (b0, cc, a) of the TDF-II de-emphasis
        z[j] = cc*d[j] + a*z[j-1], out[j] = b0*d[j] + z[j-1].
      carry_f: planar (C, 1) previous rotated sample.
      carry_z: (C, 1) de-emphasis state.
      precision: 'f32', 'bf16x3' or 'bf16x2'.
    """
    y = graded_bank_front(buf, tap_bank, decimation, precision)
    return _fm_back_end(y, lo_table, n0_rot, decimation, gain, deemph,
                        carry_f, carry_z)


def pfb_fm_chain_reference(buf, poly_taps, dft_bank, num_taps, lo_table,
                           n0_rot, decimation, gain, deemph, carry_f,
                           carry_z, precision="f32"):
    """The unfused chain with the PFB front at the grade ``precision``
    (``graded_uniform_front``; at 'f32' mix_fir_decimate_bank_uniform on
    its tables), then the rotor, discriminator and de-emphasis exactly as
    ``fm_chain_reference``.

    ``poly_taps`` is the (Q, K) table of ``ops.pfb._poly_taps``,
    ``dft_bank`` the (2C, 2K) table of ``ops.pfb._dft_bank_stacked``,
    ``num_taps`` the prototype's T (M = (Nb - T)//D + 1). Other arguments
    as fm_chain_reference.
    """
    y = graded_uniform_front(buf, poly_taps, dft_bank, num_taps, decimation,
                             precision)
    return _fm_back_end(y, lo_table, n0_rot, decimation, gain, deemph,
                        carry_f, carry_z)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    """The built fm_chain library, its launch signatures declared."""
    lib = load_chain_library("fm_chain")
    p, i, lng = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.fm_chain_launch.argtypes = ([p] * 15 + [lng] + [i] * 8
                                    + [ctypes.c_float, p])
    lib.fm_chain_launch.restype = i
    lib.pfb_fm_chain_launch.argtypes = ([p] * 15 + [lng] + [i] * 11
                                        + [ctypes.c_float, p, p])
    lib.pfb_fm_chain_launch.restype = i
    lib.fm_chain_tile_outputs.argtypes = [i]
    lib.fm_chain_tile_outputs.restype = i
    lib.fm_chain_scratch_bytes.argtypes = [lng]
    lib.fm_chain_scratch_bytes.restype = lng
    return lib


# The de-emphasis look-back's scratch of each (device index, stream): one
# slot a tile and channel of a call (csrc/fm_chain.cu), shared by both
# fronts
_scratches = LookBackScratch(
    "fm_chain", lambda slots: _library().fm_chain_scratch_bytes(slots),
    1 << 15)

# The counted PFB kernel's counters (kernels/chain.py, CHAIN_CLOCKS)
pfb_counters = KernelCounters("pfb_fm_chain", CHAIN_CLOCKS)


def _launch(fn, front_args, buf, lo_table, n0_rot, c, t, d, gain, deemph,
            carry_f, carry_z, counted=(), rows=PFB_ROWS[0]):
    """Check the back end's operands, allocate the outputs, and launch
    ``fn`` of the fm_chain library, one grid launch, on the stream's
    look-back scratch (a slot a channel and row tile of the block's
    ``rows`` rows). ``front_args`` are the pointers that come between the
    buffer planes and the table, the ints between C and D, and those
    between M and the gain; ``counted`` the PFB launch's counter buffer
    (its address, or None: no counted kernel)."""
    dev = buf.re.device
    nb = buf.re.shape[-1]
    check_operands(fn, {
        "buf.re": (buf.re, (nb,)), "buf.im": (buf.im, (nb,)),
        "lo_table": (lo_table, (c, 4)), "deemph": (deemph, (3,)),
        "carry_f.re": (carry_f.re, (c, 1)), "carry_f.im": (carry_f.im, (c, 1)),
        "carry_z": (carry_z, (c, 1))}, dev)
    if (n0_rot.device != dev or n0_rot.dtype != torch.int32
            or n0_rot.numel() != 1):
        raise ValueError(f"{fn}: n0_rot must be one int32 on buf's device")
    if d < 1 or nb < t:
        raise ValueError(f"{fn}: Nb={nb} < T={t} or D={d} < 1")
    lib = _library()
    m = (nb - t) // d + 1
    ntiles = -(-m // lib.fm_chain_tile_outputs(rows))
    audio = torch.empty((c, m), dtype=torch.float32, device=dev)
    f_re = torch.empty((c, 1), dtype=torch.float32, device=dev)
    f_im = torch.empty((c, 1), dtype=torch.float32, device=dev)
    z_out = torch.empty((c, 1), dtype=torch.float32, device=dev)
    ptrs, ints, tail_ints = front_args
    n0 = n0_rot.reshape(1).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scr = _scratches.get(dev, stream, ntiles * c)
    with torch.cuda.device(dev):
        err = getattr(lib, fn + "_launch")(
            buf.re.data_ptr(), buf.im.data_ptr(), *ptrs,
            lo_table.data_ptr(), n0.data_ptr(), deemph.data_ptr(),
            carry_f.re.data_ptr(), carry_f.im.data_ptr(), carry_z.data_ptr(),
            audio.data_ptr(), f_re.data_ptr(), f_im.data_ptr(),
            z_out.data_ptr(), scr.buf.data_ptr(), scr.slots,
            nb, c, *ints, d, m, *tail_ints, float(gain), stream, *counted)
    cuda_error("fm_chain", f"{fn} kernel launch", err)
    return audio, ComplexArray(f_re, f_im), z_out


def _launch_dense(buf, tap_bank, lo_table, n0_rot, decimation, gain, deemph,
                  carry_f, carry_z, precision="bf16x3", chunk=None,
                  channels=None):
    """The dense-front kernel; ``chunk`` as ``chain.ChainKernel`` says, and
    ``channels`` the channels of a bf16 block (4, 8 or 16; default the
    library's plan, ``chain.dense_block``), a card test's knob: each
    output column's sum is independent of the block's others, so every
    block gives the same outputs."""
    dev = buf.re.device
    grade = grade_code("fm_chain", precision)
    c2, two, t = tap_bank.shape
    if two != 2 or c2 % 2:
        raise ValueError(f"fm_chain: tap_bank shape {tuple(tap_bank.shape)}")
    check_operands("fm_chain", {"tap_bank": (tap_bank, (c2, 2, t))}, dev)
    m = (buf.re.shape[-1] - t) // max(int(decimation), 1) + 1
    tc = dense_chunk("fm_chain", dev, t, decimation, precision, c2 // 2,
                     m) if chunk is None else int(chunk)
    table = dense_mma_tables(tap_bank) if grade \
        else dense_f32_tables(tap_bank)
    ptrs = (None, table.data_ptr()) if grade else (table.data_ptr(), None)
    return _launch("fm_chain", (ptrs, (t, tc), (int(channels or 0), grade)),
                   buf, lo_table, n0_rot, c2 // 2, t, int(decimation), gain,
                   deemph, carry_f, carry_z)


def _launch_pfb(buf, poly_taps, dft_bank, num_taps, lo_table, n0_rot,
                decimation, gain, deemph, carry_f, carry_z,
                precision="bf16x3", plan=None, rows=None):
    """The PFB-front kernel; ``plan`` and ``rows`` as ``chain.ChainKernel``
    says."""
    dev = buf.re.device
    grade = grade_code("pfb_fm_chain", precision)
    c, k, q = check_pfb_tables("pfb_fm_chain", poly_taps, dft_bank,
                               num_taps, decimation)
    check_operands("pfb_fm_chain", {
        "poly_taps": (poly_taps, (q, k)),
        "dft_bank": (dft_bank, (2 * c, 2 * k))}, dev)
    t = int(num_taps)
    m = (buf.re.shape[-1] - t) // max(int(decimation), 1) + 1
    lanes, uc, rows = pfb_launch_plan("fm_chain", dev, k, q, decimation,
                                      precision, plan, c, m, rows)
    taps, btab = pfb_operands(poly_taps, dft_bank, decimation, grade,
                              (lanes, uc))
    counted = counted_launch(pfb_counters, dev, grade, (lanes, uc), k, q)
    out = _launch(
        "pfb_fm_chain",
        ((taps.data_ptr(), btab.data_ptr()), (t, k, q),
         (lanes, uc, rows, grade)), buf, lo_table, n0_rot, c, t,
        int(decimation), gain, deemph, carry_f, carry_z, (counted,), rows)
    if grade and (lanes < k or uc < q):
        pfb_fm_chain.row_tiles[rows] += 1
    return out


fm_chain = ChainKernel("fm_chain", fm_chain_reference, _launch_dense)
pfb_fm_chain = ChainKernel("pfb_fm_chain", pfb_fm_chain_reference,
                           _launch_pfb, row_tiles=PFB_ROWS)
