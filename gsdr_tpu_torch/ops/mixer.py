"""Frequency shifting (complex mixing / local oscillator).

Counterpart of ``gsdr_tpu/ops/mixer.py``:

    out[n] = x[n] * exp(+j * 2*pi * freq_shift * (n0 + n) / Fs)

Phase continuity across calls comes from the global sample offset n0,
folded exactly into one starting fraction on the host
(``utils/phase.py::phase_fraction_offset``), so the device only sees
block-local indices. A planar ComplexArray in gives a planar one out; a
complex64 tensor in gives complex64 out.
"""

import numpy as np
import torch

from gsdr_tpu_torch.carray import ComplexArray, expj
from gsdr_tpu_torch.utils.phase import phase_fraction, phase_fraction_offset

_TWO_PI = 6.283185307179586


def lo_phase(num_elements, freq_hz, sample_rate, first_sample_index=0,
             device="cuda"):
    """Oscillator phase theta_i = 2*pi*frac(f*(n0+i)/Fs), float32, with an
    error bounded for arbitrarily long streams (see utils/phase.py)."""
    i = torch.arange(num_elements, dtype=torch.int32, device=device)
    # the float32 value of the exact fraction, added in float32 as JAX does
    frac0 = float(np.float32(
        phase_fraction_offset(first_sample_index, freq_hz, sample_rate)))
    frac = phase_fraction(i, freq_hz, sample_rate) + frac0
    frac = frac - torch.floor(frac)
    return _TWO_PI * frac


def lo_signal(num_elements, freq_hz, sample_rate, first_sample_index=0,
              planar=False, device="cuda"):
    """Complex local oscillator e^{j*2*pi*f*(n0+i)/Fs}, i = 0..N-1."""
    lo = expj(lo_phase(num_elements, freq_hz, sample_rate,
                       first_sample_index, device))
    return lo if planar else lo.to_complex()


def freq_shift(x, freq_shift_hz, sample_rate, first_sample_index=0):
    """Mix ``x`` by e^{j*2*pi*freq_shift*(n0+n)/Fs} along the last axis, on
    the device of ``x``."""
    if isinstance(x, ComplexArray):
        return x * lo_signal(x.shape[-1], freq_shift_hz, sample_rate,
                             first_sample_index, planar=True,
                             device=x.device)
    return x * lo_signal(x.shape[-1], freq_shift_hz, sample_rate,
                         first_sample_index, device=x.device)
