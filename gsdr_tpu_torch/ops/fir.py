"""FIR filtering with decimation.

Counterpart of ``gsdr_tpu/ops/fir.py``. The contract:

    out[i] = sum_{t=0}^{T-1} x[i*D + t] * taps[t]

a "valid" cross-correlation with caller-supplied taps (pass reversed taps
for a true convolution), no normalization. The JAX package computes it with
``lax.conv_general_dilated`` outside any Pallas kernel; here it is
``F.conv1d`` in full float32 (TF32 off, ``utils/precision.py``). Complex
data runs as split re/im real convolutions, the four dtype combos of real
or complex signal and taps in one function.
"""

import numpy as np
import torch
import torch.nn.functional as F

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.utils.precision import full_f32


def fir_output_length(num_inputs, num_taps, decimation=1):
    """Number of outputs producible from ``num_inputs`` samples."""
    if num_inputs < num_taps:
        return 0
    return (num_inputs - num_taps) // decimation + 1


def _real_conv(x, taps, decimation):
    """Valid cross-correlation of real (B, N) x with real (T,) taps."""
    taps = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    with full_f32():
        out = F.conv1d(x[:, None, :], taps[None, None, :], stride=decimation)
    return out[:, 0, :]


def _batched(x):
    """Leading axes flattened: (x2d, restore)."""
    lead = tuple(x.shape[:-1])
    return (x.reshape(-1, x.shape[-1]),
            lambda o: o.reshape(lead + (o.shape[-1],)))


def _is_complex_taps(taps):
    if isinstance(taps, torch.Tensor):
        return taps.is_complex()
    return np.iscomplexobj(taps)


def fir_planar(x, taps, decimation=1):
    """FIR core on a planar ComplexArray with real or planar taps."""
    re2, restore = _batched(x.re)
    im2, _ = _batched(x.im)
    b = re2.shape[0]
    stacked = torch.cat([re2.to(torch.float32), im2.to(torch.float32)])
    if isinstance(taps, ComplexArray):
        with_r = _real_conv(stacked, taps.re, decimation)
        with_i = _real_conv(stacked, taps.im, decimation)
        out_re = with_r[:b] - with_i[b:]
        out_im = with_r[b:] + with_i[:b]
    else:
        res = _real_conv(stacked, taps, decimation)
        out_re, out_im = res[:b], res[b:]
    return ComplexArray(restore(out_re), restore(out_im))


def fir(x, taps, decimation=1):
    """Apply a FIR filter with optional decimation along the last axis.

    Args:
      x: real tensor, complex tensor or planar ComplexArray, (..., N).
      taps: real or complex (T,) (tuple, numpy array, tensor) or a planar
        ComplexArray, applied as written (cross-correlation).
      decimation: output stride D >= 1.

    Returns:
      (..., (N - T)//D + 1) samples in the representation of ``x``, on its
      device.
    """
    decimation = int(decimation)
    if decimation < 1:
        raise ValueError("decimation must be >= 1")
    tap_len = taps.shape[0] if isinstance(taps, ComplexArray) \
        else len(taps)
    n = x.shape[-1]
    if n < tap_len:
        raise ValueError(f"need at least {tap_len} input samples, got {n}")

    if not isinstance(taps, ComplexArray) and _is_complex_taps(taps):
        # complex taps as planar ones, whatever the signal (JAX's planar
        # path would drop their imaginary part: ROADMAP C)
        taps = ComplexArray.from_complex(
            taps if isinstance(taps, torch.Tensor) else np.asarray(taps),
            device=x.device)
    if isinstance(x, ComplexArray):
        return fir_planar(x, taps, decimation)

    x = torch.as_tensor(x)
    if x.is_complex() or isinstance(taps, ComplexArray):
        xp = ComplexArray.from_complex(x)
        return fir_planar(xp, taps, decimation).to_complex()

    x2, restore = _batched(x.to(torch.float32))
    return restore(_real_conv(x2, taps, decimation))
