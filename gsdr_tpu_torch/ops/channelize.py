"""Fused mix -> FIR -> decimate for a bank of channels as one conv.

Counterpart of ``gsdr_tpu/ops/channelize.py``. The LO phase splits
exactly out of the FIR window, e^{j*phi_c(jD+t)} = e^{j*phi_c(jD)} *
e^{j*2*pi*f_c*t/Fs}; folding the second factor into channel-specific
complex taps g_c[t] = h[t] * e^{j*2*pi*f_c*t/Fs} turns the C-channel
mix + FIR + decimate into one real strided convolution with input
features (xr, xi) and 2C output features, followed by one LO phasor per
decimated output (``rotate_bank``).
"""

import numpy as np
import torch
import torch.nn.functional as F

from gsdr_tpu_torch.carray import ComplexArray, expj
from gsdr_tpu_torch.utils.phase import phase_digit_table, phase_fraction_from_table
from gsdr_tpu_torch.utils.precision import full_f32

_TWO_PI = 6.283185307179586


def make_complex_tap_bank(taps, shifts_hz, sample_rate):
    """Host-side (2C, 2, T) float32 conv kernel of channelized complex taps.

    Rows 2c / 2c+1 produce the real / imag planes of channel c:
      kernel[2c]   = [ gr_c, -gi_c ]   (applied to input features [xr, xi])
      kernel[2c+1] = [ gi_c,  gr_c ]
    with g_c[t] = taps[t] * e^{j*2*pi*frac(f_c*t/Fs)}, phase fractions exact
    (integer arithmetic) for integral f/Fs, float64 otherwise.
    """
    taps = np.asarray(taps, np.float64)
    t_len = taps.shape[0]
    t_idx = np.arange(t_len)
    kernel = np.zeros((2 * len(shifts_hz), 2, t_len), np.float64)
    for c, f in enumerate(shifts_hz):
        f, fs = float(f), float(sample_rate)
        if f.is_integer() and fs.is_integer():
            frac = ((int(f) % int(fs)) * t_idx % int(fs)) / int(fs)
        else:
            frac = np.mod(f * t_idx, fs) / fs
        g = taps * np.exp(2j * np.pi * frac)
        kernel[2 * c, 0] = g.real
        kernel[2 * c, 1] = -g.imag
        kernel[2 * c + 1, 0] = g.imag
        kernel[2 * c + 1, 1] = g.real
    return kernel.astype(np.float32)


def mix_fir_decimate_bank(x, kernel, decimation, impl="auto"):
    """Apply a complex tap bank to planar x (..., N) -> planar (..., C, M).

    ``kernel`` is a (2C, 2, T) tap bank from make_complex_tap_bank;
    M = (N - T)//D + 1. The output is un-rotated: apply ``rotate_bank``
    for the mixed semantics.

    impl: 'auto' and 'torch' run the strided ``F.conv1d`` in full float32
    (TF32 off), as the JAX package's 'auto' runs its XLA convolution;
    'cuda' runs the channelizer kernel (``kernels/channelize.py``), which
    takes a 1-D x on the card and raises for a tensor elsewhere.
    """
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"impl must be 'auto', 'torch' or 'cuda', got {impl!r}")
    if impl == "cuda":
        if x.device.type != "cuda":
            raise ValueError("impl='cuda' runs the channelizer kernel: it "
                             f"needs a CUDA tensor, got one on {x.device}")
        from gsdr_tpu_torch.kernels.channelize import channelize_kernel

        return channelize_kernel(x, torch.as_tensor(
            kernel, dtype=torch.float32, device=x.device), decimation)
    lead = tuple(x.shape[:-1])
    n = x.shape[-1]
    kernel = torch.as_tensor(kernel, dtype=torch.float32, device=x.device)
    lhs = torch.stack([x.re, x.im], dim=-2).reshape(-1, 2, n)  # (B, 2, N)
    with full_f32():
        out = F.conv1d(lhs, kernel, stride=decimation)  # (B, 2C, M)
    m = out.shape[-1]
    c = kernel.shape[0] // 2
    out = out.reshape(lead + (c, 2, m))
    return ComplexArray(out[..., 0, :], out[..., 1, :])


def rotate_bank(y, table, n0, decimation):
    """Multiply y (..., C, M) by e^{j*phi_c(n0 + j*D)} per channel/output.

    ``table`` is the (C, 4) digit-fraction table of the shift frequencies;
    ``n0`` is an int32 scalar tensor (the carried stream offset).
    """
    m = y.shape[-1]
    n0 = torch.as_tensor(n0, dtype=torch.int32, device=y.device)
    idx = n0 + decimation * torch.arange(m, dtype=torch.int32, device=y.device)
    table = torch.as_tensor(table, dtype=torch.float32, device=y.device)
    frac = phase_fraction_from_table(idx[None, :], table[:, None, :])
    lo = expj(_TWO_PI * frac)
    return ComplexArray(
        y.re * lo.re - y.im * lo.im,
        y.re * lo.im + y.im * lo.re,
    )


def channelize(x, taps, shifts_hz, sample_rate, decimation=1,
               first_sample_index=0):
    """One-call channelizer: planar x (N,) -> planar (C, (N-T)//D+1)."""
    kernel = make_complex_tap_bank(taps, shifts_hz, sample_rate)
    table = phase_digit_table(shifts_hz, sample_rate)
    y = mix_fir_decimate_bank(x, kernel, decimation)
    n0 = torch.tensor(int(first_sample_index) % int(round(sample_rate)),
                      dtype=torch.int32, device=x.device)
    return rotate_bank(y, table, n0, decimation)
