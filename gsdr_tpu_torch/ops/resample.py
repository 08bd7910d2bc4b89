"""Rational L/M polyphase resampler.

Counterpart of ``gsdr_tpu/ops/resample.py``. Upsample by L -> FIR ->
downsample by M in polyphase form: with output index j = q*L + r (r < L),

    y[j] = sum_k x[q*M + floor(r*M/L) - k] * h[(r*M) mod L + k*L]

so each of the L output phases is a stride-M FIR over the input with its
own decimated taps. All L phases run as one stride-M ``F.conv1d`` of the
planar pair against a (2L, 2, W) bank (``_phase_bank``, a host table equal
to the JAX package's), in full float32 as JAX's ``lax.conv`` at
``Precision.HIGHEST``, followed by an interleave of the phases.

``taps`` is the prototype low-pass at rate L*Fs_in with cutoff
min(1/L, 1/M)/2 (``design_resampler_taps``); the bank carries the gain L,
so a DC input keeps its level.
"""

import numpy as np
import torch
import torch.nn.functional as F

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.utils.precision import full_f32


def design_resampler_taps(l, m, taps_per_phase=16, window=np.hamming):
    """Windowed-sinc prototype for an L/M resampler: L*taps_per_phase taps,
    cutoff min(1/L, 1/M) of the upsampled Nyquist, unit DC gain at the
    prototype rate (the phase bank applies the gain L)."""
    l, m = int(l), int(m)
    t = l * taps_per_phase
    n = np.arange(t) - (t - 1) / 2.0
    cutoff = min(1.0 / l, 1.0 / m)
    h = np.sinc(cutoff * n) * window(t)
    return (h / h.sum()).astype(np.float32)


def _phase_bank(taps, l, m):
    """((2L, 2, W) float32 bank, window start offset, W): rows 2r and 2r+1
    give the re and im of phase r. Window position p of output window q
    reads input q*M + start + p; phase r weighs input q*M + off[r] - k with
    h[(r*M) mod L + k*L], off[r] = floor(r*M/L)."""
    taps = np.asarray(taps, np.float64)
    l, m = int(l), int(m)
    t = len(taps)
    q_cnt = -(-t // l)  # taps per phase (max)
    off = [int((r * m) // l) for r in range(l)]
    off0 = min(off)
    w = (q_cnt - 1) + (max(off) - off0) + 1
    kern = np.zeros((2 * l, 2, w), np.float64)
    start = off0 - (q_cnt - 1)
    for r in range(l):
        ph = (r * m) % l
        for k in range(q_cnt):
            tap_idx = ph + k * l
            if tap_idx >= t:
                continue
            pos = off[r] - k - start
            if not 0 <= pos < w:
                continue
            kern[2 * r, 0, pos] = taps[tap_idx]
            kern[2 * r + 1, 1, pos] = taps[tap_idx]
    kern *= l  # the upsampling gain
    return kern.astype(np.float32), start, w


def _as_planar(x):
    """(planar ComplexArray, was_planar, was_complex) for a planar, complex
    or real input (numpy arrays become CPU tensors)."""
    if isinstance(x, ComplexArray):
        return x, True, False
    x = torch.as_tensor(x)
    if x.is_complex():
        return ComplexArray.from_complex(x), False, True
    x = x.to(torch.float32)
    return ComplexArray(x, torch.zeros_like(x)), False, False


def _restore(out, was_planar, was_complex):
    if was_planar:
        return out
    return out.to_complex() if was_complex else out.re


def _resample_core(xp, kern, l, m):
    """The stride-M phase-bank conv over a planar (..., N) buffer whose
    position 0 is window position 0; planar (..., Q*L) out with
    Q = (N - W)//M + 1 windows."""
    lead = tuple(xp.shape[:-1])
    lhs = torch.stack([xp.re, xp.im], dim=-2).reshape(-1, 2, xp.shape[-1])
    with full_f32():
        out = F.conv1d(lhs, kern, stride=m)        # (B, 2L, Q)
    q_out = out.shape[-1]
    # interleave the phases: y[q*L + r] = out[r, :, q]
    out = out.reshape(lead + (l, 2, q_out)).movedim(-1, -3)
    out = out.reshape(lead + (q_out * l, 2))
    return ComplexArray(out[..., 0], out[..., 1])


class ResampleStream:
    """Stateful L/M resampler: the input tail carried from block to block.

    Feeding blocks x_0, x_1, ... gives exactly ``resample`` of their
    concatenation, split at block boundaries that vary: each block
    consumes a whole number of M-strided windows and the rest rides in
    the tail, whose length varies by up to M-1 samples. A host-loop
    object, as in the JAX package; the conv runs on the device of the
    blocks. State: (planar tail, input samples still to drop).
    """

    def __init__(self, l, m, taps=None, taps_per_phase=16):
        l, m = int(l), int(m)
        g = np.gcd(l, m)
        self.l, self.m = l // g, m // g
        if taps is None:
            taps = design_resampler_taps(self.l, self.m, taps_per_phase)
        self.kern, start, self.w = _phase_bank(taps, self.l, self.m)
        self._pad_l = max(0, -start)
        self._trim = max(0, start)
        self._banks = {}

    def _bank(self, device):
        if device not in self._banks:
            self._banks[device] = torch.as_tensor(self.kern, device=device)
        return self._banks[device]

    def init(self, x_example):
        """The initial state for blocks shaped and placed like
        ``x_example``: the left-padding zeros as the tail and the leading
        input samples still to drop (one of the two is always zero)."""
        xp, _, _ = _as_planar(x_example)
        tail = ComplexArray.zeros(tuple(xp.shape[:-1]) + (self._pad_l,),
                                  device=xp.device)
        return (tail, self._trim)

    def step(self, state, x):
        """(state', output of this block) in the representation of x."""
        tail, trim = state
        xp, was_planar, was_complex = _as_planar(x)
        if trim:
            drop = min(trim, xp.shape[-1])
            xp = xp[..., drop:]
            trim -= drop
        buf = ComplexArray(torch.cat([tail.re, xp.re], dim=-1),
                           torch.cat([tail.im, xp.im], dim=-1))
        n = buf.shape[-1]
        q = (n - self.w) // self.m + 1 if n >= self.w else 0
        if q <= 0:
            out = ComplexArray.zeros(tuple(buf.shape[:-1]) + (0,),
                                     device=buf.device)
            new_tail = buf
        else:
            out = _resample_core(buf[..., :(q - 1) * self.m + self.w],
                                 self._bank(buf.device), self.l, self.m)
            new_tail = buf[..., q * self.m:]
        return (new_tail, trim), _restore(out, was_planar, was_complex)


def resample(x, l, m, taps=None, taps_per_phase=16):
    """Resample a planar, complex or real (..., N) signal by L/M.

    Returns (..., floor((N - warm-up) * L / M)) samples at rate Fs*L/M,
    delayed by the filter's group delay, in the representation of ``x``
    and on its device. The trailing filter-window remainder is not
    emitted (``ResampleStream`` carries it into the next block).
    """
    l, m = int(l), int(m)
    if l < 1 or m < 1:
        raise ValueError(f"L and M must be >= 1, got {l}/{m}")
    g = np.gcd(l, m)
    l, m = l // g, m // g
    if taps is None:
        taps = design_resampler_taps(l, m, taps_per_phase)
    xp, was_planar, was_complex = _as_planar(x)
    kern, start, _ = _phase_bank(taps, l, m)
    # align window position 0 with the bank's start: pad left or trim
    pad_l, trim = max(0, -start), max(0, start)
    re = F.pad(xp.re, (pad_l, 0))[..., trim:]
    im = F.pad(xp.im, (pad_l, 0))[..., trim:]
    res = _resample_core(ComplexArray(re, im),
                         torch.as_tensor(kern, device=xp.device), l, m)
    return _restore(res, was_planar, was_complex)
