"""Quadrature demodulators on planar input (counterpart of
``gsdr_tpu/ops/quad_demod.py``)."""

import torch


def quad_fm_demod(x, gain):
    """Quadrature FM discriminator on a planar ComplexArray or a complex
    tensor.

    out[i] = gain * atan2(Im, Re) of x[i+1] * conj(x[i]); N-1 outputs from
    N inputs. ``gain`` is conventionally Fs / (2*pi*frequency_deviation).
    """
    if isinstance(x, torch.Tensor):
        m = x[..., 1:] * torch.conj(x[..., :-1])
        return gain * torch.atan2(m.imag, m.real)
    r0, i0 = x.re[..., :-1], x.im[..., :-1]
    r1, i1 = x.re[..., 1:], x.im[..., 1:]
    m_re = r1 * r0 + i1 * i0
    m_im = i1 * r0 - r1 * i0
    return gain * torch.atan2(m_im, m_re)


def quad_am_demod(x):
    """AM envelope detector: out[i] = 2 * clamp(|x[i]|, 0, 1) - 1."""
    mag = torch.hypot(x.re, x.im)
    return 2.0 * torch.clamp(mag, 0.0, 1.0) - 1.0
