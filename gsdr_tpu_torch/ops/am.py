"""AM demodulation of one channel: mix -> FIR low-pass + decimate ->
envelope.

Counterpart of ``gsdr_tpu/ops/am.py``. ``impl='auto'`` on a CUDA tensor
runs the chain as one call of the fused AM-chain kernel with its dense
front (B3-dense, ``kernels/am_chain.py``) and one channel, where the JAX
package runs its Pallas kernel on a TPU: for a 1-D signal with at least
one filtered sample, at any T and D. The LO cancels under
the magnitude, so ``first_sample_index`` does not reach the kernel. Every
other case runs the composed chain; ``impl='cuda'`` forces the kernel and
raises where it cannot run.
"""

import numpy as np
import torch

from gsdr_tpu_torch.carray import as_planar
from gsdr_tpu_torch.kernels.am_chain import am_chain
from gsdr_tpu_torch.ops.channelize import make_complex_tap_bank
from gsdr_tpu_torch.ops.fir import fir
from gsdr_tpu_torch.ops.fm import as_signal, route_to_kernel, rotor_start
from gsdr_tpu_torch.ops.mixer import freq_shift
from gsdr_tpu_torch.ops.quad_demod import quad_am_demod
from gsdr_tpu_torch.utils.phase import phase_digit_table


def am_chain_args(x, low_pass_taps, rf_sample_rate, shift_hz, decimation,
                  first_sample_index=0):
    """The arguments of ``am_chain`` (and of ``am_chain_reference``) for
    the kernel route over the planar (N,) x, one channel."""
    xp = as_planar(x)
    dev = xp.device
    bank = torch.as_tensor(make_complex_tap_bank(
        np.asarray(low_pass_taps, np.float64), [shift_hz], rf_sample_rate),
        device=dev)
    table = torch.as_tensor(phase_digit_table([shift_hz], rf_sample_rate),
                            device=dev)
    rot0 = rotor_start(first_sample_index, rf_sample_rate, dev)
    return xp, bank, table, rot0, int(decimation)


def am_demod_fused(x, low_pass_taps, rf_sample_rate, shift_hz, decimation,
                   first_sample_index=0, precision="bf16x3"):
    """The kernel route: one call of ``am_chain`` on ``am_chain_args``, its
    row 0. On a CPU tensor ``am_chain`` runs its plain version (which
    applies the rotor the kernel leaves out)."""
    return am_chain(*am_chain_args(x, low_pass_taps, rf_sample_rate,
                                   shift_hz, decimation, first_sample_index),
                    precision=precision)[0]


def am_demod(x, low_pass_taps, rf_sample_rate, tuning_frequency,
             channel_frequency, decimation=1, first_sample_index=0,
             impl="auto", precision="bf16x3"):
    """Demodulate one AM channel out of a tuned complex RF stream.

    Arguments as ``fm_demod``'s, without the deviation. Returns
    (..., (N - T)//D + 1) float32 envelope samples 2*clip(|lpf|, 0, 1) - 1
    on the device of ``x``.
    """
    x = as_signal(x)
    shift_hz = float(tuning_frequency) - float(channel_frequency)
    t, d = len(low_pass_taps), int(decimation)
    if route_to_kernel("am_demod", impl, x, t, d, 1):
        return am_demod_fused(x, low_pass_taps, rf_sample_rate, shift_hz, d,
                              first_sample_index, precision)
    mixed = freq_shift(x, shift_hz, rf_sample_rate, int(first_sample_index))
    filtered = fir(mixed, low_pass_taps, d)
    return quad_am_demod(filtered)
