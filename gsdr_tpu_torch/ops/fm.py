"""FM demodulation of one channel: mix -> FIR low-pass + decimate ->
quadrature discriminator.

Counterpart of ``gsdr_tpu/ops/fm.py``. ``impl='auto'`` on a CUDA tensor
runs the whole chain as one call of the fused FM-chain kernel (B1,
``kernels/fm_chain.py``) with one channel and the identity de-emphasis,
where the JAX package runs its Pallas kernel on a TPU: for a 1-D signal,
at least two filtered samples and an integral sample rate. There a block
that does not fit the card raises, as ``FmChannelizer`` does: the op on
the card takes the kernel or raises. The cases the JAX package also
leaves to its composed chain ('torch', a tensor on the CPU, a batched
signal, fewer than two filtered samples, a non-integral sample rate) run
the composed chain. ``impl='cuda'`` forces the kernel and raises where
it cannot run. JAX's 'xla' is the port's 'torch', its 'pallas' the
port's 'cuda'.
"""

import numpy as np
import torch

from gsdr_tpu_torch.carray import ComplexArray, as_planar
from gsdr_tpu_torch.kernels.chain import front_supported
from gsdr_tpu_torch.kernels.fm_chain import deemphasis_triple, fm_chain
from gsdr_tpu_torch.ops.channelize import make_complex_tap_bank
from gsdr_tpu_torch.ops.fir import fir
from gsdr_tpu_torch.ops.mixer import freq_shift
from gsdr_tpu_torch.ops.quad_demod import quad_fm_demod
from gsdr_tpu_torch.utils.phase import phase_digit_table

_TWO_PI = 6.283185307179586
_IMPLS = ("auto", "torch", "cuda")


def fm_demod_gain(rf_sample_rate, frequency_deviation):
    """Discriminator gain Fs / (2*pi*deviation)."""
    return float(rf_sample_rate) / (_TWO_PI * float(frequency_deviation))


def as_signal(x):
    """``x`` as a planar ComplexArray or a tensor (numpy arrays become CPU
    tensors)."""
    return x if isinstance(x, (ComplexArray, torch.Tensor)) \
        else torch.as_tensor(x)


def route_to_kernel(fn, library, impl, x, num_taps, decimation,
                    min_outputs, precision, rate_integral=True):
    """True when the single-channel op ``fn`` runs the fused kernel of
    ``library``: for 'cuda', and for 'auto' on a CUDA tensor of one
    dimension with at least ``min_outputs`` filtered samples and
    ``rate_integral`` (the FM kernel's rotor needs an integral sample
    rate). Raises where the kernel is chosen and cannot run: a tensor off
    the card, a shape it does not take, or a block that does not fit the
    card's shared memory at ``precision``."""
    if impl not in _IMPLS:
        raise ValueError(f"{fn}: impl must be one of {_IMPLS}, got {impl!r}")
    if impl == "torch":
        return False
    dev = x.device
    m = (x.shape[-1] - num_taps) // decimation + 1
    shape_ok = x.ndim == 1 and m >= min_outputs and rate_integral
    if impl == "auto" and not (dev.type == "cuda" and shape_ok):
        return False
    if dev.type != "cuda":
        raise ValueError(f"{fn}: impl='cuda' runs the CUDA kernel; the "
                         f"signal lies on {dev}")
    if not shape_ok:
        raise ValueError(
            f"{fn}: impl='cuda' needs a 1-D signal of at least "
            f"{min_outputs} filtered samples and, for FM, an integral "
            f"sample rate; got shape {tuple(x.shape)}")
    if not front_supported(library, dev, num_taps, decimation,
                           precision=precision):
        raise ValueError(
            f"{fn}: a block of the {library} kernel for T={num_taps}, "
            f"D={decimation} at precision={precision!r} does not fit the "
            f"card's shared memory; use impl='torch'")
    return True


def rotor_start(first_sample_index, sample_rate, device):
    """The kernel's rotor index of x[0], first_sample_index mod Fs, as one
    int32 on ``device``; first_sample_index is a Python int or an integer
    tensor."""
    fs = int(round(sample_rate))
    if isinstance(first_sample_index, torch.Tensor):
        n = first_sample_index.to(device=device, dtype=torch.int64)
        return torch.remainder(n, fs).to(torch.int32).reshape(())
    return torch.tensor(int(first_sample_index) % fs, dtype=torch.int32,
                        device=device)


def fm_chain_args(x, low_pass_taps, rf_sample_rate, shift_hz, gain,
                  decimation, first_sample_index=0):
    """The arguments of ``fm_chain`` (and of its plain version
    ``fm_chain_reference``) for the kernel route over the planar (N,) x:
    one channel, the identity de-emphasis (1, 0, 0) and zero carries."""
    xp = as_planar(x)
    dev = xp.device
    taps = np.asarray(low_pass_taps, np.float64)
    bank = torch.as_tensor(
        make_complex_tap_bank(taps, [shift_hz], rf_sample_rate), device=dev)
    table = torch.as_tensor(phase_digit_table([shift_hz], rf_sample_rate),
                            device=dev)
    # the buffer starts at x[0], so no -(T-1) offset, unlike
    # FmChannelizer.step, whose buffer starts T-1 samples earlier
    rot0 = rotor_start(first_sample_index, rf_sample_rate, dev)
    deemph = torch.tensor(deemphasis_triple((1.0, 0.0), (1.0, 0.0)),
                          dtype=torch.float32, device=dev)
    return (xp, bank, table, rot0, int(decimation), gain, deemph,
            ComplexArray.zeros((1, 1), device=dev),
            torch.zeros((1, 1), dtype=torch.float32, device=dev))


def fm_demod_fused(x, low_pass_taps, rf_sample_rate, shift_hz, gain,
                   decimation, first_sample_index=0, precision="bf16x3"):
    """The kernel route: one call of ``fm_chain`` on ``fm_chain_args``;
    returns its outputs 1..M-1. Output 0 pairs the first filtered sample
    with the zero carry; the rest are the op's M-1 discriminator pairs.
    On a CPU tensor ``fm_chain`` runs its plain version, which is how the
    tests reach this arithmetic."""
    audio, _, _ = fm_chain(
        *fm_chain_args(x, low_pass_taps, rf_sample_rate, shift_hz, gain,
                       decimation, first_sample_index), precision=precision)
    return audio[0, 1:]


def fm_demod(x, low_pass_taps, rf_sample_rate, tuning_frequency,
             channel_frequency, frequency_deviation, decimation=1,
             first_sample_index=0, impl="auto", precision="bf16x3"):
    """Demodulate one FM channel out of a tuned complex RF stream.

    Args:
      x: planar ComplexArray or complex tensor, (..., N).
      low_pass_taps: real FIR taps (T,), applied as written.
      rf_sample_rate, tuning_frequency, channel_frequency: the channel is
        mixed to DC by tuning - channel.
      frequency_deviation: sets the discriminator gain (fm_demod_gain).
      decimation: FIR output stride D.
      first_sample_index: global index of x[..., 0], for the oscillator's
        phase; a Python int or an integer tensor.
      impl: 'auto', 'torch' or 'cuda' (module docstring).
      precision: the kernel's grade, 'bf16x3' (default), 'bf16x2' or
        'f32'; the composed chain runs float32.

    Returns (..., M - 1) float32 audio, M = (N - T)//D + 1 filtered
    samples, on the device of ``x``.
    """
    x = as_signal(x)
    shift_hz = float(tuning_frequency) - float(channel_frequency)
    gain = fm_demod_gain(rf_sample_rate, frequency_deviation)
    t, d = len(low_pass_taps), int(decimation)
    if route_to_kernel("fm_demod", "fm_chain", impl, x, t, d, 2, precision,
                       float(rf_sample_rate).is_integer()):
        return fm_demod_fused(x, low_pass_taps, rf_sample_rate, shift_hz,
                              gain, d, first_sample_index, precision)
    mixed = freq_shift(x, shift_hz, rf_sample_rate, int(first_sample_index))
    filtered = fir(mixed, low_pass_taps, d)
    return quad_fm_demod(filtered, gain)
