"""Elementwise arithmetic (counterpart of ``gsdr_tpu/ops/arithmetic.py``).

Each op takes a real or complex64 tensor (or anything ``torch.as_tensor``
takes) or a planar ComplexArray, and runs on the device of its input. The
reference's per-dtype variants collapse into torch's type promotion, as
they collapse into JAX's.
"""

import torch

from gsdr_tpu_torch.carray import ComplexArray


def add_const(x, c):
    """out[i] = x[i] + c. A real constant added to a complex input adds to
    the real part only; on a planar input a complex ``c`` adds per plane."""
    if isinstance(x, ComplexArray):
        c = complex(c)
        return ComplexArray(x.re + c.real, x.im + c.imag)
    return torch.as_tensor(x) + c


def add_to_magnitude(x, k):
    """out[i] = (|x[i]| + k) * x[i] / |x[i]|: ``k`` added to the magnitude,
    the phase kept. Where |x[i]| == 0 the result is k + 0j, as in the JAX
    package."""
    if isinstance(x, ComplexArray):
        mag = torch.hypot(x.re, x.im)
        nz = mag > 0
        scale = (mag + k) / torch.where(nz, mag, torch.ones_like(mag))
        return ComplexArray(
            torch.where(nz, x.re * scale, torch.full_like(mag, float(k))),
            torch.where(nz, x.im * scale, torch.zeros_like(mag)))
    x = torch.as_tensor(x)
    mag = torch.abs(x)
    nz = mag > 0
    scaled = x * ((mag + k) / torch.where(nz, mag, torch.ones_like(mag)))
    return torch.where(nz, scaled, torch.full_like(x, k))


def multiply(x, y):
    """out[i] = x[i] * y[i]; planar operands take the planar product."""
    if isinstance(x, ComplexArray):
        return x * (y if isinstance(y, ComplexArray)
                    else torch.as_tensor(y, device=x.device))
    if isinstance(y, ComplexArray):
        return y * torch.as_tensor(x, device=y.device)
    x = torch.as_tensor(x)
    return x * torch.as_tensor(y, device=x.device)


def magnitude(x):
    """out[i] = |x[i]| = hypot(re, im), float32."""
    if isinstance(x, ComplexArray):
        return torch.hypot(x.re, x.im)
    return torch.abs(torch.as_tensor(x)).to(torch.float32)


def absolute(x):
    """out[i] = |x[i]| for a real input."""
    return torch.abs(torch.as_tensor(x))
