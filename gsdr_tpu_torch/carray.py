"""Planar complex representation over torch tensors: split re/im float32.

Counterpart of ``gsdr_tpu/carray.py``. Every public boundary of the port
carries complex signals as two float32 planes, the same layout as the JAX
package, so arrays and streaming states move between the two packages
through numpy unchanged. A plain dataclass with the JAX class's pytree
methods (``tree_flatten``, ``tree_unflatten``), which
``utils/tree.py`` walks where the JAX package's pytree registration does.
"""

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class ComplexArray:
    """A complex tensor as two same-shaped float32 planes."""

    re: torch.Tensor
    im: torch.Tensor

    def tree_flatten(self):
        return (self.re, self.im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

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
    def zeros(cls, shape, dtype=torch.float32, device=None):
        """Zero planes of ``shape`` and ``dtype``, JAX's ``zeros(shape,
        dtype=jnp.float32)`` with the port's ``device`` after it."""
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

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

    def reshape(self, *shape):
        return ComplexArray(self.re.reshape(*shape), self.im.reshape(*shape))

    # -- arithmetic ----------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, ComplexArray):
            return ComplexArray(self.re + other.re, self.im + other.im)
        return ComplexArray(self.re + other, self.im)

    def __sub__(self, other):
        if isinstance(other, ComplexArray):
            return ComplexArray(self.re - other.re, self.im - other.im)
        return ComplexArray(self.re - other, self.im)

    def __mul__(self, other):
        if isinstance(other, ComplexArray):
            return ComplexArray(
                self.re * other.re - self.im * other.im,
                self.re * other.im + self.im * other.re,
            )
        return ComplexArray(self.re * other, self.im * other)

    def conj(self):
        return ComplexArray(self.re, -self.im)

    def abs2(self):
        return self.re * self.re + self.im * self.im

    def abs(self):
        """|z| as the JAX class forms it (``jnp.hypot``): with h and l the
        larger and smaller of |re| and |im|, h*sqrt(1 + (l/h)^2), 0 where
        h is 0 and inf where a plane is infinite. 1 + (l/h)^2 is rounded
        once (``_one_plus_square``), as XLA's CPU code forms it with a
        fused multiply-add, and its square root correctly (in float64,
        then to float32), as XLA's is."""
        a, b = self.re.abs(), self.im.abs()
        hi, lo = torch.maximum(a, b), torch.minimum(a, b)
        zero = hi == 0
        q = lo / torch.where(zero, torch.ones_like(hi), hi)
        root = torch.sqrt(_one_plus_square(q).double()).float()
        r = torch.where(zero, hi, hi * root)
        return torch.where(torch.isposinf(a) | torch.isposinf(b),
                           torch.full_like(r, float("inf")), r)


def _one_plus_square(q):
    """1 + q*q for float32 q in [0, 1], rounded once to float32 (to nearest,
    ties to even). q*q is exact in float64 and Fast2Sum gives the sum's
    float64 rounding s and its error e exactly; where s lies halfway
    between two float32 values, e says on which side the exact sum lies."""
    p = q.double() * q.double()
    s = 1.0 + p
    e = p - (s - 1.0)
    f = s.float()
    up = torch.nextafter(f, torch.full_like(f, float("inf")))
    down = torch.nextafter(f, torch.zeros_like(f))
    half_up = (s - f.double()) * 2 == up.double() - f.double()
    half_down = (f.double() - s) * 2 == f.double() - down.double()
    f = torch.where(half_up & (e > 0), up, f)
    return torch.where(half_down & (e < 0), down, f)


def is_planar(x):
    return isinstance(x, ComplexArray)


def as_planar(x, device=None):
    """``x`` as it is when it is already planar; else a numpy array or a
    (complex or real) tensor split into float32 planes."""
    if isinstance(x, ComplexArray):
        return x
    return ComplexArray.from_complex(x, device=device)


def expj(theta):
    """e^{j*theta} as a ComplexArray."""
    return ComplexArray(torch.cos(theta), torch.sin(theta))
