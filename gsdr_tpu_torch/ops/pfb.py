"""Polyphase filter-bank (PFB) front for channels on a uniform grid.

Counterpart of the analysis half of ``gsdr_tpu/ops/pfb.py`` that the
wideband receivers run. When every channel shift sits on the grid
f_c = g_c * Fs / K and the decimation D divides K, the complex tap bank
factors into a polyphase fold shared by all channels and one small DFT
bank:

    filt[c, j] = sum_t x[jD + t] h[t] e^{+2i pi g_c t / K}
               = sum_v e^{+2i pi g_c v / K} a[v, j]             (t = v + Ku)
        a[v, j] = sum_u h[v + Ku] x[jD + v + Ku]                (fold)

so the filter costs T multiply-adds per output shared by every channel
instead of C*T, and the channels cost one (2C, 2K) product. The output is
un-rotated, exactly as ``mix_fir_decimate_bank``'s: the caller applies
``rotate_bank``.
"""

from fractions import Fraction
from math import lcm

import numpy as np
import torch
import torch.nn.functional as F

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.utils.precision import full_f32


def uniform_grid(shifts_hz, sample_rate, max_k=4096, multiple_of=1):
    """(k, bins) with every shift f_c = bins[c] * Fs / k (bins mod k), for
    the smallest such k that is a multiple of ``multiple_of``; None when
    the shifts sit on no such grid with k <= max_k.

    Callers pass the decimation as ``multiple_of`` so that D | K holds
    whenever any valid K exists. Exact rational arithmetic on the binary
    values of the float inputs: no tolerance.
    """
    fs = Fraction(float(sample_rate))
    if fs == 0:
        return None
    ratios = [Fraction(float(f)) / fs for f in shifts_hz]
    k = lcm(*[r.denominator for r in ratios]) if ratios else 1
    k = lcm(k, max(1, int(multiple_of)))
    if k > int(max_k):
        return None
    bins = [int((r * k) % k) for r in ratios]
    return k, bins


def pfb_taps_to_polyphase(taps, num_channels):
    """(T,) prototype low-pass -> (K, Q) polyphase matrix, T zero-padded up
    to a multiple of K. Row r holds h[r], h[K+r], h[2K+r], ..."""
    taps = np.asarray(taps, np.float64)
    k = int(num_channels)
    q = -(-len(taps) // k)
    padded = np.zeros(k * q)
    padded[:len(taps)] = taps
    return padded.reshape(q, k).T.astype(np.float32)


def _poly_taps(taps, k):
    """(Q, K) polyphase tap matrix hp[u, v] = h[v + K u], zero-padded: the
    transpose of ``pfb_taps_to_polyphase``, the layout the PFB front reads."""
    return np.ascontiguousarray(pfb_taps_to_polyphase(taps, k).T)


def pfb_preferred(shifts_hz, sample_rate, decimation, num_taps,
                  max_p=8, min_q=4):
    """(k, bins) when the PFB front is preferred for this configuration,
    else None: a uniform Fs/k grid with D | k, k >= 8, Q = ceil(T/k) fold
    taps in [min_q, 127], P = k/D a power of two <= max_p, and at least
    half the grid's channels in use.

    The rule is the JAX package's, copied unchanged so that both packages
    route the same configurations. Its boundary was measured on a TPU, not
    on this port's GPU: it says nothing about where the H100 kernels cross
    over. Drives the models' impl='auto' choice of front on the card.
    """
    grid = uniform_grid(shifts_hz, sample_rate, multiple_of=int(decimation))
    if grid is None:
        return None
    k, bins = grid
    d = int(decimation)
    p = k // d
    if k < 8 or k % d != 0 or p > int(max_p) or (p & (p - 1)) != 0:
        return None
    if 2 * len(bins) < k:
        return None
    q = -(-int(num_taps) // k)
    if q < int(min_q) or q > 127:
        return None
    return k, bins


def _dft_bank_matrix(grid_bins, k):
    """Planar (2C, 2K) DFT-bank matrix: row pair (2c, 2c+1) evaluates
    sum_v a[v] e^{+2i pi g_c v / K} from the stacked planar fold
    [a_re; a_im]. The positive sign matches make_complex_tap_bank's
    g_c[t] = h[t] e^{+2i pi f_c t / Fs} with f_c = g_c Fs / K."""
    g = np.zeros((2 * len(grid_bins), 2 * k), np.float64)
    v = np.arange(k)
    for c, gc in enumerate(grid_bins):
        ang = 2.0 * np.pi * ((int(gc) * v) % k) / k
        wr, wi = np.cos(ang), np.sin(ang)
        g[2 * c, :k] = wr
        g[2 * c, k:] = -wi
        g[2 * c + 1, :k] = wi
        g[2 * c + 1, k:] = wr
    return g.astype(np.float32)


def _dft_bank_stacked(grid_bins, k):
    """The bank of ``_dft_bank_matrix`` with its rows planes-major, the
    layout the PFB front reads: rows [0, C) give the re planes and
    [C, 2C) the im planes from [a_re | a_im]."""
    g = _dft_bank_matrix(grid_bins, k)
    return np.concatenate([g[0::2], g[1::2]])


def uniform_bank_front(x, poly_taps, dft_bank, num_taps, decimation):
    """The PFB front on tensors: planar x (N,) -> planar un-rotated (C, M),
    M = (N - T)//D + 1.

    ``poly_taps`` is the (Q, K) zero-padded polyphase matrix
    hp[u, v] = h[v + K u]; ``dft_bank`` the planes-major (2C, 2K) bank
    (rows [0, C) give the re planes, [C, 2C) the im planes). For output
    j = w*P + p (P = K/D phases) the fold reads x[(w+u)K + pD + v], so each
    phase is a grouped convolution over the (rows, K) sample grid shifted
    by pD; the phases then share one product with the bank. Full float32.
    """
    q, k = poly_taps.shape
    d = int(decimation)
    if k % d != 0:
        raise ValueError(f"uniform PFB needs D | K (D={d}, K={k})")
    p_cnt = k // d
    n = x.shape[-1]
    m = (n - int(num_taps)) // d + 1
    if m <= 0:
        raise ValueError(f"need at least {num_taps} samples, got {n}")
    nw = -(-m // p_cnt)                 # windows per phase
    rows = nw + q + 1                   # sample-grid rows the fold reads
    weight = poly_taps.t().contiguous()[:, None, :]      # (K, 1, Q)

    def fold(plane):
        xg = F.pad(plane, (0, max(0, rows * k - n)))[:rows * k].reshape(rows, k)
        flat = xg.reshape(-1)
        outs = []
        for p in range(p_cnt):
            # xp[w, v] = x[w*K + p*D + v]
            xp = flat[p * d:p * d + (rows - 1) * k].reshape(rows - 1, k)
            a = F.conv1d(xp.t()[None], weight, groups=k)[0]   # (K, rows - q)
            outs.append(a[:, :nw])
        return torch.stack(outs)                              # (P, K, NW)

    with full_f32():
        a_all = torch.cat([fold(x.re), fold(x.im)], dim=1)    # (P, 2K, NW)
        f = torch.matmul(dft_bank, a_all)                     # (P, 2C, NW)
    c = dft_bank.shape[0] // 2
    # interleave j = w*P + p and trim the ragged tail
    f = f.permute(1, 2, 0).reshape(2 * c, nw * p_cnt)[:, :m]
    return ComplexArray(f[:c], f[c:])


def mix_fir_decimate_bank_uniform(x, taps, grid_bins, k_grid, decimation):
    """Uniform-grid drop-in for ``mix_fir_decimate_bank``: planar x (N,) ->
    planar un-rotated (C, M) for shifts f_c = grid_bins[c] * Fs / k_grid.
    Needs D | k_grid."""
    k = int(k_grid)
    if k % int(decimation) != 0:
        raise ValueError(f"uniform PFB needs D | K (D={decimation}, K={k})")
    return uniform_bank_front(
        x, torch.as_tensor(_poly_taps(taps, k), device=x.device),
        torch.as_tensor(_dft_bank_stacked(grid_bins, k), device=x.device),
        len(np.asarray(taps)), decimation)
