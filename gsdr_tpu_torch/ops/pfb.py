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

The rest of the module is the channelized digital link's pair of banks:
``pfb_channelize`` (critically sampled analysis, channel c at +c*Fs/K) and
``pfb_synthesize`` (its transmit-side inverse, critical or with a hop
D | K), each with a streaming block form whose carried tail lets a block
split reproduce the one-shot output.
"""

import functools
from fractions import Fraction
from math import lcm

import numpy as np
import torch
import torch.nn.functional as F

from gsdr_tpu_torch.carray import ComplexArray, as_planar
from gsdr_tpu_torch.ops.channelize import (
    make_complex_tap_bank,
    mix_fir_decimate_bank,
)
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


def _dft_matrices(k):
    """Real and imaginary parts of the K-point DFT matrix
    W[c, r] = e^{-2i pi cr/K}, float64-accurate, as float32."""
    c = np.arange(k)[:, None]
    r = np.arange(k)[None, :]
    ang = -2.0 * np.pi * c * r / k
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


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


# ---------------------------------------------------------------------------
# The channelized link's banks
# ---------------------------------------------------------------------------

def _taps_key(taps):
    """The prototype as a tuple of Python floats: a cache key that holds
    its values exactly."""
    return tuple(np.asarray(taps, np.float64).reshape(-1).tolist())


@functools.lru_cache(maxsize=32)
def _analysis_tables(taps, k, device):
    """Device tables of ``pfb_channelize`` for the prototype ``taps`` (a
    tuple, see ``_taps_key``), built once per (taps, K, device): the
    kernel's (2K, 2, Q*K) tap bank and the fold path's (K, 1, Q) polyphase
    weight and the two (K, K) DFT planes. Callers must not write to them."""
    q = -(-len(taps) // k)
    padded = np.zeros(k * q)
    padded[:len(taps)] = taps
    # shift ratio f_c/Fs = -c/K with integral (f, Fs), so the bank's phases
    # are exact rationals (gsdr_tpu/ops/pfb.py:456-462)
    bank = make_complex_tap_bank(padded, [-c for c in range(k)], k)
    wr, wi = _dft_matrices(k)
    poly = pfb_taps_to_polyphase(np.asarray(taps), k)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (bank, poly[:, None, :], wr, wi))


def pfb_channelize(x, taps, num_channels, impl="auto"):
    """Critically sampled PFB analysis: planar (..., N) -> planar
    (..., K, N//K - Q + 1), Q = ceil(T/K).

    Channel c carries the band centred at c*Fs/K (channels above K/2 are
    negative frequencies), filtered by the prototype ``taps`` and decimated
    by K, with output windows starting at j*K: the same as ``channelize``
    with shifts -c*Fs/K and decimation K.

    impl: 'torch' runs the polyphase fold as a grouped ``F.conv1d`` and the
    K-point DFT as ``torch.matmul``, in full float32. 'cuda' runs the
    uniform grid as a complex tap bank, g_c[t] = h[t] e^{-2i pi ct/K}
    (the rotor is 1 at critical decimation), through the channelizer
    kernel, at any Q (a long prototype's taps are staged in chunks); it
    takes 1-D signals on the card and raises otherwise. 'auto' (the
    default) takes the kernel for a 1-D signal on the card with K <= 32,
    else the fold path, as the JAX package's 'auto' does on a TPU.
    """
    k = int(num_channels)
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"impl must be 'auto', 'torch' or 'cuda', got {impl!r}")
    x = as_planar(x)
    if impl == "auto":
        impl = ("cuda" if k <= 32 and x.ndim == 1 and x.device.type == "cuda"
                else "torch")
    bank, weight, wr, wi = _analysis_tables(_taps_key(taps), k, x.device)
    if impl == "cuda":
        return mix_fir_decimate_bank(x, bank, k, impl="cuda")
    q = weight.shape[-1]
    n = x.shape[-1]
    m = n // k - q + 1                  # output frames
    if m <= 0:
        raise ValueError(f"need at least {k * q} samples, got {n}")
    lead = tuple(x.shape[:-1])

    def fold(plane):
        # (..., N) -> (B, K phases, N//K) -> one Q-tap FIR per phase
        ph = plane[..., :(n // k) * k].reshape(-1, n // k, k).transpose(1, 2)
        return F.conv1d(ph, weight, groups=k)                # (B, K, M)

    with full_f32():
        u_re, u_im = fold(x.re), fold(x.im)
        # filt[c, j] = sum_r W[c, r] u[j, r], complex W times complex u
        f_re = torch.matmul(wr, u_re) - torch.matmul(wi, u_im)
        f_im = torch.matmul(wi, u_re) + torch.matmul(wr, u_im)
    return ComplexArray(f_re.reshape(lead + (k, m)), f_im.reshape(lead + (k, m)))


def pfb_channelize_block(x, taps, num_channels, tail=None, impl="auto"):
    """Streaming ``pfb_channelize``: (filt (..., K, N//K), new_tail).

    ``tail`` is the previous block's last (Q-1)*K raw samples, planar
    (zeros at stream start). N must be a multiple of K: a block of another
    length would restart every later frame at a wrong offset. A block
    split gives the one-shot output."""
    k = int(num_channels)
    xp = as_planar(x)
    if xp.shape[-1] % k != 0:
        raise ValueError(
            f"block length {xp.shape[-1]} must be a multiple of "
            f"num_channels={k} (frame alignment across blocks)")
    q = -(-len(np.asarray(taps)) // k)
    hist = (q - 1) * k
    if tail is None:
        tail = ComplexArray.zeros(tuple(xp.shape[:-1]) + (hist,),
                                  device=xp.device)
    buf = ComplexArray(torch.cat([tail.re, xp.re], dim=-1),
                       torch.cat([tail.im, xp.im], dim=-1))
    out = pfb_channelize(buf, taps, k, impl=impl)
    # the tail of the joined stream: a block shorter than the tail keeps
    # part of the previous one
    return out, buf[..., buf.shape[-1] - hist:]


def _idft_channels(yr, yi, k):
    """u[b, r, m] = sum_c y[b, c, m] e^{+2i pi cr/K}: the synthesis banks'
    inverse DFT over the channel axis, two (K, K) products per plane in
    full float32."""
    wr, wi = (torch.as_tensor(a, device=yr.device).t()
              for a in _dft_matrices(k))       # e^{+...} = (wr, -wi)
    with full_f32():
        u_re = torch.matmul(wr, yr) + torch.matmul(wi, yi)
        u_im = torch.matmul(wr, yi) - torch.matmul(wi, yr)
    return u_re, u_im


def pfb_synthesize(channels, taps, num_channels=None, hop=None):
    """PFB synthesis: planar (..., K, M) channel streams -> planar
    (..., M*hop) wideband stream, the transmit-side inverse of
    ``pfb_channelize``. Channel c is placed at +c*Fs/K.

    Critically sampled (hop = K, the default):

        x[jK + r] = sum_q hp[r, q] v[r, j - q],
        v[r, j]   = sum_c y[c, j] e^{+2i pi cr/K}            (inverse DFT)

    with hp the (K, Q) polyphase split of the interpolation prototype and
    gain K folded in. The one-shot form zero-primes the filter; streams use
    ``pfb_synthesize_block``.

    hop = D < K with D | K: oversampled synthesis, each channel's frame
    rate Fs/D,

        x[n] = D sum_j h[n - jD] u_j[n mod K],   u_j = IDFT_K(y[:, j]),

    evaluated per output phase (gain D folded in).
    """
    y = as_planar(channels)
    k = int(num_channels) if num_channels is not None else y.shape[-2]
    if y.shape[-2] != k:
        raise ValueError(f"channels axis {y.shape[-2]} != K={k}")
    if hop is not None and int(hop) != k:
        return _pfb_synthesize_hop(y, taps, k, int(hop))
    poly = torch.as_tensor(pfb_taps_to_polyphase(taps, k),
                           device=y.device) * float(k)       # (K, Q)
    lead = tuple(y.shape[:-2])
    m = y.shape[-1]
    v_re, v_im = _idft_channels(y.re.reshape(-1, k, m), y.im.reshape(-1, k, m),
                                k)

    def interp(v):
        # output phase r at frame j: causal per-lane FIR over j, zero-primed
        with full_f32():
            out = F.conv1d(F.pad(v, (poly.shape[1] - 1, 0)),
                           torch.flip(poly, [1])[:, None, :],
                           groups=k)                         # (B, K, M)
        return out.transpose(1, 2).reshape(lead + (m * k,))

    return ComplexArray(interp(v_re), interp(v_im))


def _pfb_synthesize_hop(y, taps, k, d):
    """Oversampled synthesis (hop D < K, D | K), see ``pfb_synthesize``."""
    if d <= 0 or k % d != 0:
        raise ValueError(f"hop {d} must be a positive divisor of K={k}")
    p_cnt = k // d
    # hd[dph, qq] = h[qq*D + dph] * D: the tap row of output phase dph
    hd = torch.as_tensor(pfb_taps_to_polyphase(taps, d),
                         device=y.device) * float(d)         # (D, Qd)
    lead = tuple(y.shape[:-2])
    m = y.shape[-1]
    # frames padded to a P multiple so every output phase carries the same
    # frame count; the zero frames reach only outputs past M*D, dropped
    m_pad = -(-m // p_cnt) * p_cnt
    ypr = F.pad(y.re, (0, m_pad - m)).reshape(-1, k, m_pad)
    ypi = F.pad(y.im, (0, m_pad - m)).reshape(-1, k, m_pad)
    # the modulator e^{+2i pi cn/K} has period K, so u_j at lane n mod K
    # is the whole modulated sum
    u_re, u_im = _idft_channels(ypr, ypi, k)
    w_cnt = m_pad // p_cnt

    def interp(u):
        # x[mD + dph] = sum_qq hd[dph, qq] u[m - qq, (m mod P) D + dph]:
        # for frame phase p = m mod P, lanes [pD, (p+1)D) of u through a
        # causal stride-P FIR evaluated at m = wP + p
        q_d = hd.shape[1]
        upad = F.pad(u, (q_d - 1, 0))
        outs = []
        for p in range(p_cnt):
            up = upad[:, p * d:(p + 1) * d, p:]
            with full_f32():
                xp = F.conv1d(up, torch.flip(hd, [1])[:, None, :],
                              stride=p_cnt, groups=d)        # (B, D, W_p)
            outs.append(xp[..., :w_cnt])
        x = torch.stack(outs, dim=2).permute(0, 3, 2, 1)     # (B, W, P, D)
        x = x.reshape(x.shape[0], w_cnt * p_cnt * d)[..., :m * d]
        return x.reshape(lead + (m * d,))

    return ComplexArray(interp(u_re), interp(u_im))


def pfb_synthesize_block(channels, taps, num_channels=None, tail=None,
                         hop=None):
    """Streaming ``pfb_synthesize``: (out (..., M*hop), new_tail).

    ``tail`` is the previous block's last channel columns, planar
    (..., K, L) with L = ceil((Qh-1)/P)*P, Qh = ceil(T/hop), P = K/hop
    (zeros at stream start). For hop < K the modulator rides on n mod K of
    the joined stream, so block frame counts must be multiples of P
    (checked) and the carried history is rounded up to a P multiple. A
    block split gives the one-shot output."""
    y = as_planar(channels)
    k = int(num_channels) if num_channels is not None else y.shape[-2]
    d = int(hop) if hop is not None else k
    if d <= 0 or k % d != 0:
        raise ValueError(f"hop {d} must be a positive divisor of K={k}")
    p_cnt = k // d
    if d != k and y.shape[-1] % p_cnt != 0:
        raise ValueError(
            f"block frame count {y.shape[-1]} must be a multiple of "
            f"P = K/hop = {p_cnt} (output-phase alignment across blocks)")
    q = -(-len(np.asarray(taps)) // d)
    t_len = -(-(q - 1) // p_cnt) * p_cnt   # P-aligned carried history
    if tail is None:
        tail = ComplexArray.zeros(tuple(y.shape[:-1]) + (t_len,),
                                  device=y.device)
    buf = ComplexArray(torch.cat([tail.re, y.re], dim=-1),
                       torch.cat([tail.im, y.im], dim=-1))
    out = pfb_synthesize(buf, taps, k, hop=d)
    return out[..., t_len * d:], buf[..., buf.shape[-1] - t_len:]
