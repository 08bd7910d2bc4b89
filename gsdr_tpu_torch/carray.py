"""Planar complex representation over torch tensors: split re/im float32.

Counterpart of ``gsdr_tpu/carray.py``. Every public boundary of the port
carries complex signals as two float32 planes, the same layout as the JAX
package, so arrays and streaming states move between the two packages
through numpy unchanged. A plain dataclass: torch needs no pytree
registration.
"""

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class ComplexArray:
    """A complex tensor as two same-shaped float32 planes."""

    re: torch.Tensor
    im: torch.Tensor

    # -- construction ------------------------------------------------------
    @classmethod
    def from_complex(cls, x, device=None):
        """Split a numpy array or complex tensor into float32 planes."""
        if isinstance(x, np.ndarray):
            return cls(
                torch.as_tensor(np.ascontiguousarray(x.real), dtype=torch.float32,
                                device=device),
                torch.as_tensor(np.ascontiguousarray(x.imag), dtype=torch.float32,
                                device=device),
            )
        x = torch.as_tensor(x, device=device)
        if not x.is_complex():
            return cls(x.to(torch.float32), torch.zeros_like(x, dtype=torch.float32))
        return cls(x.real.to(torch.float32).contiguous(),
                   x.imag.to(torch.float32).contiguous())

    @classmethod
    def zeros(cls, shape, device=None):
        return cls(torch.zeros(shape, dtype=torch.float32, device=device),
                   torch.zeros(shape, dtype=torch.float32, device=device))

    # -- conversion --------------------------------------------------------
    def to_complex(self):
        """Recombine into one complex64 tensor."""
        return torch.complex(self.re, self.im)

    def to_numpy(self):
        return (self.re.detach().cpu().numpy()
                + 1j * self.im.detach().cpu().numpy())

    # -- shape plumbing ------------------------------------------------------
    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def device(self):
        return self.re.device

    def __getitem__(self, idx):
        return ComplexArray(self.re[idx], self.im[idx])

    # -- arithmetic ----------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, ComplexArray):
            return ComplexArray(
                self.re * other.re - self.im * other.im,
                self.re * other.im + self.im * other.re,
            )
        return ComplexArray(self.re * other, self.im * other)

    def conj(self):
        return ComplexArray(self.re, -self.im)


def as_planar(x, device=None):
    """``x`` as it is when it is already planar; else a numpy array or a
    (complex or real) tensor split into float32 planes."""
    if isinstance(x, ComplexArray):
        return x
    return ComplexArray.from_complex(x, device=device)


def expj(theta):
    """e^{j*theta} as a ComplexArray."""
    return ComplexArray(torch.cos(theta), torch.sin(theta))
