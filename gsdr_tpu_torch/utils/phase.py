"""Exact long-stream oscillator phase in float32.

Counterpart of ``gsdr_tpu/utils/phase.py``. frac(f * n / Fs) for a large
integer sample index n splits over the base-256 digits of n:

    frac(f*n/Fs) = frac( sum_d digit_d * frac(f * 256^d / Fs) )

The per-digit fractions are exact host-side rationals; on the device each
term is digit (< 256) times a fraction (< 1), so every float32
intermediate stays below 256 and the error stays bounded (~6e-5 cycles)
however long the stream runs.
"""

from fractions import Fraction

import numpy as np
import torch

_NUM_DIGITS = 4  # covers sample indices < 2^32 within a block
_BASE_BITS = 8
_BASE = 1 << _BASE_BITS


def digit_fractions(freq_hz, sample_rate):
    """Host-side per-digit phase fractions frac(freq * 256^d / Fs), d=0..3.

    Exact rational arithmetic on the binary values of the float inputs;
    negative frequencies reduce into [0, 1). Returns Python floats.
    """
    ratio = Fraction(float(freq_hz)) / Fraction(float(sample_rate))
    fr = []
    for d in range(_NUM_DIGITS):
        x = ratio * (_BASE ** d)
        x -= x.numerator // x.denominator  # frac(), exact
        fr.append(x.numerator / x.denominator)
    return fr


def phase_fraction(n, freq_hz, sample_rate):
    """frac(freq * n / Fs) in [0, 1) for an int32 tensor of sample indices.

    ``n`` must be non-negative and < 2^31; ``freq_hz`` and ``sample_rate``
    are Python scalars. A negative frequency takes frac(-x) = 1 - frac(x).
    Same operation order as the JAX function.
    """
    neg = float(freq_hz) < 0
    fr = digit_fractions(abs(float(freq_hz)), sample_rate)
    n = torch.as_tensor(n, dtype=torch.int32)
    acc = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    for d in range(_NUM_DIGITS):
        digit = ((n >> (_BASE_BITS * d)) & (_BASE - 1)).to(torch.float32)
        acc = acc + digit * float(np.float32(fr[d]))
    frac = acc - torch.floor(acc)
    if neg:
        frac = torch.where(frac > 0, 1.0 - frac, torch.zeros_like(frac))
    return frac


def phase_fraction_offset(first_sample_index, freq_hz, sample_rate):
    """Exact host-side frac(freq * n0 / Fs) for an integer offset n0, as a
    Python float: folds an arbitrarily large global stream offset into one
    starting fraction, frac(f*(n0+i)/Fs) = frac(frac(f*n0/Fs) + frac(f*i/Fs))."""
    x = (Fraction(float(freq_hz)) / Fraction(float(sample_rate))
         * int(first_sample_index))
    x -= x.numerator // x.denominator  # frac(), exact for any float f/Fs
    return x.numerator / x.denominator


def phase_digit_table(freqs_hz, sample_rate):
    """Host-side (len(freqs), 4) float32 digit-fraction table; row c holds
    frac(f_c * 256^d / Fs) for d = 0..3."""
    rows = [digit_fractions(f, sample_rate) for f in freqs_hz]
    return np.asarray(rows, dtype=np.float32)


def phase_fraction_from_table(n, table):
    """frac(f * n / Fs) for int32 indices ``n`` and a digit table.

    ``n``: int32 tensor, any shape, values in [0, 2^31). ``table``:
    (..., 4) float32 digit fractions whose leading axes broadcast against
    ``n``. Same operation order as the JAX function.
    """
    n = torch.as_tensor(n, dtype=torch.int32)
    table = torch.as_tensor(table, dtype=torch.float32, device=n.device)
    acc = torch.zeros(torch.broadcast_shapes(n.shape, table.shape[:-1]),
                      dtype=torch.float32, device=n.device)
    for d in range(_NUM_DIGITS):
        digit = ((n >> (_BASE_BITS * d)) & (_BASE - 1)).to(torch.float32)
        acc = acc + digit * table[..., d]
    return acc - torch.floor(acc)
