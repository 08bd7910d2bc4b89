"""QPSK modulation and demodulation with packed-bit I/O.

Counterpart of ``gsdr_tpu/ops/qpsk.py``. Gray constellation

    00 -> (+A, +A)   01 -> (-A, +A)   11 -> (-A, -A)   10 -> (+A, -A)

and four 2-bit symbols per byte, LSB-first. Every function works on the
last axis and broadcasts over leading channel axes, on the device of its
input. Bytes default to ``torch.uint8`` (``out_dtype=torch.int32`` on
request); symbol values are int32.
"""

import torch

from gsdr_tpu_torch.carray import ComplexArray, as_planar


def _int32(a):
    return torch.as_tensor(a).to(torch.int32)


def qpsk_constellation(amplitude=1.0, dtype=torch.complex64):
    """The 4-point table indexed by 2-bit symbol value."""
    re = torch.tensor([1.0, -1.0, 1.0, -1.0]) * amplitude
    im = torch.tensor([1.0, 1.0, -1.0, -1.0]) * amplitude
    return torch.complex(re, im).to(dtype)


def unpack_2bit_symbols(packed, num_symbols=None):
    """Byte values (..., nB) -> int32 2-bit symbol values (..., 4*nB),
    LSB-first, cut to ``num_symbols`` when given."""
    packed = _int32(packed)
    shifts = torch.arange(4, dtype=torch.int32, device=packed.device) * 2
    sym = torch.bitwise_right_shift(packed[..., None], shifts) & 0x3
    sym = sym.reshape(tuple(packed.shape[:-1]) + (packed.shape[-1] * 4,))
    if num_symbols is not None:
        sym = sym[..., :num_symbols]
    return sym


def pack_2bit_symbols(symbols, out_dtype=torch.uint8):
    """2-bit symbol values (..., N) -> byte values (..., ceil(N/4)); a
    partial last byte is filled with zero symbols."""
    symbols = _int32(symbols)
    n = symbols.shape[-1]
    pad = (-n) % 4
    if pad:
        symbols = torch.nn.functional.pad(symbols, (0, pad))
    grp = symbols.reshape(tuple(symbols.shape[:-1]) + ((n + pad) // 4, 4))
    weights = torch.tensor([1, 4, 16, 64], dtype=torch.int32,
                           device=symbols.device)
    return torch.sum(grp * weights, dim=-1).to(out_dtype)


def qpsk_modulate_symbols(symbols, amplitude=1.0):
    """2-bit symbol values (..., N) -> planar QPSK samples: re flips sign on
    bit 0, im on bit 1 (sign arithmetic, exactly +-A)."""
    sym = _int32(symbols)
    a = float(amplitude)
    re = a * (1.0 - 2.0 * torch.bitwise_and(sym, 1).to(torch.float32))
    im = a * (1.0 - 2.0 * (torch.bitwise_right_shift(sym, 1) & 1)
              .to(torch.float32))
    return ComplexArray(re, im)


def qpsk_modulate(packed_bits, amplitude=1.0, num_symbols=None, planar=False):
    """Packed bytes -> QPSK samples, complex64 or planar (``planar=True``)."""
    out = qpsk_modulate_symbols(unpack_2bit_symbols(packed_bits, num_symbols),
                                amplitude)
    return out if planar else out.to_complex()


def qpsk_demodulate_symbols(x):
    """Complex samples -> int32 2-bit symbol values by quadrant: bit 0 set
    iff Re < 0, bit 1 iff Im < 0 (a zero component decides toward 0)."""
    xp = as_planar(x)
    b0 = (xp.re < 0).to(torch.int32)
    b1 = (xp.im < 0).to(torch.int32)
    return b0 | (b1 << 1)


def qpsk_demodulate(x, out_dtype=torch.uint8):
    """Complex samples (..., N) -> packed byte values (..., ceil(N/4))."""
    return pack_2bit_symbols(qpsk_demodulate_symbols(x), out_dtype=out_dtype)
