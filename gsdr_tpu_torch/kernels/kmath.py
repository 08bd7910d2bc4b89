"""Polynomial atan, sincos and atan2 on float32 tensors.

Counterpart of ``gsdr_tpu/kernels/kmath.py``, whose polynomials the JAX
package uses where a TPU kernel has no libm lowering. Here they are plain
tensor functions, not kernels: the circular QPSK256 modulator and ring
demodulator (``ops/qpsk256.py``) call them, so that both packages round
alike near ring boundaries. The coefficients and the order of operations
are the JAX ones; ``torch.round``, like ``jnp.round``, rounds half to even.
"""

import torch

_PI = 3.141592653589793
_PI_2 = 1.5707963267948966

# Minimax odd polynomial for atan(r), r in [0, 1]: max error ~6e-7 rad.
_C1 = 0.99997726
_C3 = -0.33262347
_C5 = 0.19354346
_C7 = -0.11643287
_C9 = 0.05265332
_C11 = -0.01172120

# 7th-order minimax fit for atan(r), r in [0, 1]: max error ~8.2e-5 rad.
_D1 = 0.999213972
_D3 = -0.321176637
_D5 = 0.146268577
_D7 = -0.038989304

# Cephes single-precision minimax coefficients on [-pi/4, pi/4]:
# sin: r (1 + s1 r^2 + s2 r^4 + s3 r^6), cos: 1 + c1 r^2 + ... + c4 r^8
_S1 = -1.6666654611e-1
_S2 = 8.3321608736e-3
_S3 = -1.9515295891e-4
_K1 = -0.5
_K2 = 4.166664568298827e-2
_K3 = -1.388731625493765e-3
_K4 = 2.443315711809948e-5

_TWO_OVER_PI = 0.6366197723675814
# Cody-Waite split of pi/2: k*HI is exact in float32 for small integer k
_PI2_HI = 1.5707962512969971
_PI2_LO = 7.549789948768648e-08


def atan_poly01(r, order=11):
    """atan(r) for r in [0, 1]. ``order`` must be 7 or 11."""
    if order not in (7, 11):
        raise ValueError(f"unsupported atan polynomial order {order}")
    r2 = r * r
    if order >= 11:
        p = _C11 * r2 + _C9
        p = p * r2 + _C7
        p = p * r2 + _C5
        p = p * r2 + _C3
        p = p * r2 + _C1
    else:
        p = _D7 * r2 + _D5
        p = p * r2 + _D3
        p = p * r2 + _D1
    return r * p


def sincos_poly(ang):
    """(cos(ang), sin(ang)) by quarter-period range reduction and the
    Cephes float32 polynomials: ~1e-7 absolute for |ang| up to a few
    hundred radians."""
    k = torch.round(ang * _TWO_OVER_PI)
    r = (ang - k * _PI2_HI) - k * _PI2_LO
    r2 = r * r
    sin_r = r * (1.0 + r2 * (_S1 + r2 * (_S2 + r2 * _S3)))
    cos_r = 1.0 + r2 * (_K1 + r2 * (_K2 + r2 * (_K3 + r2 * _K4)))
    q = k - 4.0 * torch.floor(k * 0.25)          # k mod 4 in {0, 1, 2, 3}
    odd = (q == 1.0) | (q == 3.0)
    s = torch.where(odd, cos_r, sin_r)
    c = torch.where(odd, sin_r, cos_r)
    s_neg = (q == 2.0) | (q == 3.0)
    c_neg = (q == 1.0) | (q == 2.0)
    return torch.where(c_neg, -c, c), torch.where(s_neg, -s, s)


def atan2_poly(y, x, order=11):
    """Four-quadrant atan2 by range reduction and the [0, 1] polynomial:
    max error ~1e-6 rad (order 11) or ~8.2e-5 rad (order 7);
    atan2(0, 0) = 0."""
    abs_y = torch.abs(y)
    abs_x = torch.abs(x)
    mx = torch.maximum(abs_x, abs_y)
    mn = torch.minimum(abs_x, abs_y)
    r = mn / torch.clamp_min(mx, 1e-37)
    r = torch.where(mx == 0.0, torch.zeros_like(r), r)
    a = atan_poly01(r, order=order)
    a = torch.where(abs_y > abs_x, _PI_2 - a, a)
    a = torch.where(x < 0.0, _PI - a, a)
    return torch.where(y < 0.0, -a, a)
