"""256-ary QPSK (QPSK256) modulation and demodulation.

Counterpart of ``gsdr_tpu/ops/qpsk256.py``, with its two constellation
geometries:

* rectangular: a 16x16 grid indexed i*16+q with I = (i-7.5)/7.5*A,
  Q = (q-7.5)/7.5*A;
* circular: rings of {1, 8, 16, 24, 32, 40, 48, 56} points at radii
  {0, .3, .6, .85, 1.1, 1.35, 1.6, 1.85}*A, point p of ring k at angle
  2*pi*p/points + 0.5*k, then 31 points at radius 0.95*A and angle
  2*pi*index/256.

A constellation is a table built once with ``qpsk256_constellation``. The
exhaustive demodulator takes any 256-point table: on the card it runs the
nearest-neighbour kernel (``kernels/qpsk256.py``), elsewhere its plain
matmul-and-argmin form. The arithmetic modulators and the rectangular and
ring demodulators are the fast paths of the two geometries. Operations run
in float32 in the JAX package's order; the circular paths use the same
polynomials (``kernels/kmath.py``).
"""

import numpy as np
import torch

from gsdr_tpu_torch.carray import ComplexArray, as_planar
from gsdr_tpu_torch.kernels.kmath import atan2_poly, sincos_poly
from gsdr_tpu_torch.kernels.qpsk256 import qpsk256_kernel, qpsk256_reference

RECTANGULAR = 0
CIRCULAR = 1


def qpsk256_constellation(constellation_type=RECTANGULAR, amplitude=1.0,
                          planar=False, device=None):
    """The 256-point table, indexed by symbol value: a complex64 numpy
    array, or with ``planar=True`` a ComplexArray of float32 tensors on
    ``device``. Built on the host exactly as the JAX package builds it."""
    a = float(amplitude)
    pts = np.zeros(256, dtype=np.complex64)
    if constellation_type == RECTANGULAR:
        i = np.arange(16)
        ii, qq = np.meshgrid(i, i, indexing="ij")
        vals = ((ii - 7.5) / 7.5 * a + 1j * (qq - 7.5) / 7.5 * a)
        pts[:] = vals.reshape(-1).astype(np.complex64)
    elif constellation_type == CIRCULAR:
        idx = 0
        for circle, (points, radius) in enumerate(zip(_CIRC_POINTS,
                                                      _CIRC_RADII)):
            points = min(points, 256 - idx)
            r = radius * a
            for p in range(points):
                ang = 2.0 * np.pi * p / points + circle * 0.5
                pts[idx] = np.complex64(r * np.cos(ang) + 1j * r * np.sin(ang))
                idx += 1
        while idx < 256:
            ang = 2.0 * np.pi * idx / 256.0
            r = 0.95 * a
            pts[idx] = np.complex64(r * np.cos(ang) + 1j * r * np.sin(ang))
            idx += 1
    else:
        raise ValueError(f"unknown constellation type {constellation_type}")
    if planar:
        return ComplexArray(
            torch.tensor(pts.real, dtype=torch.float32, device=device),
            torch.tensor(pts.imag, dtype=torch.float32, device=device))
    return pts


def _check_table(constellation):
    shape = tuple(as_planar(constellation).shape)
    if shape != (256,):
        raise ValueError(
            f"constellation must have exactly 256 points, got shape {shape} "
            "(build one with qpsk256_constellation)")


def _symbols(symbols):
    return torch.as_tensor(symbols).to(torch.int32)


def qpsk256_modulate(symbols, constellation):
    """Symbol values (..., N) -> samples by table lookup, on the symbols'
    device: complex64 for a complex table, planar for a planar one."""
    _check_table(constellation)
    s = _symbols(symbols).long()
    if isinstance(constellation, ComplexArray):
        return ComplexArray(constellation.re.to(s.device)[s],
                            constellation.im.to(s.device)[s])
    return torch.as_tensor(constellation, device=s.device)[s]


def qpsk256_modulate_rect(symbols, amplitude=1.0):
    """Arithmetic modulation for the RECTANGULAR constellation, equal to
    the table lookup: two integer ops and a multiply-add per symbol."""
    s = _symbols(symbols)
    scale = float(amplitude) / 7.5
    i = torch.bitwise_right_shift(s, 4).to(torch.float32)
    q = torch.bitwise_and(s, 15).to(torch.float32)
    return ComplexArray((i - 7.5) * scale, (q - 7.5) * scale)


_CIRC_POINTS = (1, 8, 16, 24, 32, 40, 48, 56)
_CIRC_RADII = (0.0, 0.3, 0.6, 0.85, 1.1, 1.35, 1.6, 1.85)
_CIRC_STARTS = (0, 1, 9, 25, 49, 81, 121, 169)  # cumulative; remainder at 225
_TWO_PI = 6.283185307179586


def qpsk256_modulate_circular(symbols, amplitude=1.0):
    """Arithmetic modulation for the CIRCULAR constellation: ring by eight
    compares, angle 2*pi*(s - start)/points + 0.5*ring (remainder: 2*pi*s
    /256 at 0.95A), then ``sincos_poly``. Agrees with the table to float32
    sin/cos accuracy (~1e-7), far below the ~0.1A point spacing."""
    a = float(amplitude)
    s = _symbols(symbols)
    ring = torch.zeros(s.shape, dtype=torch.int32, device=s.device)
    for t in list(_CIRC_STARTS[1:]) + [225]:
        ring = ring + (s >= t).to(torch.int32)       # 0..8 (8 = remainder)

    def sel(table, default):
        out = torch.full(s.shape, float(default), dtype=torch.float32,
                         device=s.device)
        for k in range(7, -1, -1):
            out = torch.where(ring == k, float(table[k]), out)
        return out

    radius = sel([r * a for r in _CIRC_RADII], 0.95 * a)
    start = sel(_CIRC_STARTS, 0.0)
    invp = sel([1.0 / p for p in _CIRC_POINTS], 1.0 / 256.0)
    offs = torch.where(ring == 8, 0.0, 0.5 * ring.to(torch.float32))
    ang = _TWO_PI * (s.to(torch.float32) - start) * invp + offs
    c, sn = sincos_poly(ang)
    return ComplexArray(radius * c, radius * sn)


def _ring_distance(rho2, r, cos_eps):
    """|x - p|^2 for a point p at radius r, |eps| off x's angle."""
    return rho2 + r * r - 2.0 * r * torch.sqrt(rho2) * cos_eps


def qpsk256_demodulate_circular(x, amplitude=1.0, out_dtype=torch.uint8):
    """Ring-decomposed nearest neighbour for CIRCULAR: 11 candidates
    instead of 256 (the origin, the angularly nearest point of each full
    ring, and for the 31-point remainder arc its nearest point and both
    endpoints). Agrees with the exhaustive search except on exact Voronoi
    boundaries, where both candidates are nearest."""
    a = float(amplitude)
    xp = as_planar(x)
    re, im = xp.re, xp.im
    rho2 = re * re + im * im
    theta = atan2_poly(im, re)                        # [-pi, pi]

    best_d = rho2                                     # ring 0: the origin
    best_i = torch.zeros(re.shape, dtype=torch.int32, device=re.device)
    for k in range(1, 8):
        pts = _CIRC_POINTS[k]
        r = _CIRC_RADII[k] * a
        u = (theta - 0.5 * k) * (pts / _TWO_PI)
        p = torch.round(u)
        eps = (u - p) * (_TWO_PI / pts)               # |eps| <= pi/8
        # cos(eps) to < 3e-8 abs at |eps| <= pi/8
        cos_eps = 1.0 + eps * eps * (-0.5 + eps * eps * (1.0 / 24.0))
        d = _ring_distance(rho2, r, cos_eps)
        idx = _CIRC_STARTS[k] + torch.remainder(p.to(torch.int32), pts)
        better = d < best_d
        best_d = torch.where(better, d, best_d)
        best_i = torch.where(better, idx, best_i)

    # remainder arc: 31 points at 0.95A, angles 2*pi*s/256, s in 225..255
    r = 0.95 * a
    th = torch.where(theta < 0, theta + _TWO_PI, theta)   # [0, 2*pi)
    c = torch.round(th * (256.0 / _TWO_PI))
    in_arc = (c >= 225) & (c <= 255)
    eps = th - c * (_TWO_PI / 256.0)
    cos_eps = 1.0 + eps * eps * (-0.5 + eps * eps * (1.0 / 24.0))
    d = torch.where(in_arc, _ring_distance(rho2, r, cos_eps),
                    torch.full_like(rho2, float("inf")))
    better = d < best_d
    best_d = torch.where(better, d, best_d)
    best_i = torch.where(better, c.to(torch.int32), best_i)
    for end in (225, 255):                            # arc endpoints
        ang = _TWO_PI * end / 256.0
        d = rho2 + r * r - 2.0 * (re * (r * np.cos(ang))
                                  + im * (r * np.sin(ang)))
        better = d < best_d
        best_d = torch.where(better, d, best_d)
        best_i = torch.where(better, end, best_i)
    return best_i.to(out_dtype)


def qpsk256_demodulate_rect(x, amplitude=1.0, out_dtype=torch.uint8):
    """Nearest neighbour for RECTANGULAR by per-axis quantization,
    clip(round(v/A*7.5 + 7.5), 0, 15): equal to the exhaustive search away
    from exact cell boundaries."""
    xp = as_planar(x)
    scale = 7.5 / float(amplitude)

    def quant(v):
        return torch.clamp(torch.round(v * scale + 7.5), 0, 15).to(torch.int32)

    return (quant(xp.re) * 16 + quant(xp.im)).to(out_dtype)


def qpsk256_demodulate(x, constellation, out_dtype=torch.uint8, impl="auto"):
    """Complex samples (..., N) -> the index of the nearest of the 256
    table points, the lowest index winning ties.

    impl: 'auto' runs the nearest-neighbour kernel for samples on the card
    and the plain form elsewhere; 'cuda' forces the kernel (CUDA tensors
    only); 'torch' forces the plain form, c2 - 2 (x @ ct) then argmin. For
    the rectangular geometry ``qpsk256_demodulate_rect`` is exact and
    O(1) per sample.
    """
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"impl must be 'auto', 'torch' or 'cuda', got {impl!r}")
    _check_table(constellation)
    xp = as_planar(x)
    cp = as_planar(constellation)
    cp = ComplexArray(cp.re.to(xp.device).contiguous(),
                      cp.im.to(xp.device).contiguous())
    on_card = xp.device.type == "cuda"
    if impl == "cuda" and not on_card:
        raise ValueError("impl='cuda' runs the QPSK256 kernel: it needs a "
                         f"CUDA tensor, got one on {xp.device}")
    if impl == "torch" or not on_card:
        return qpsk256_reference(xp, cp).to(out_dtype)
    if out_dtype in (torch.uint8, torch.int32):
        # the kernel writes the decisions in that type itself
        return qpsk256_kernel(ComplexArray(xp.re.contiguous(),
                                           xp.im.contiguous()), cp,
                              out_dtype=out_dtype)
    return qpsk256_kernel(ComplexArray(xp.re.contiguous(),
                                       xp.im.contiguous()), cp).to(out_dtype)
