"""Functional streaming layer: explicit (state, block) -> (state, out).

Counterpart of ``gsdr_tpu/stream.py``. Every streaming op is a function
``step(state, block) -> (state, out)`` whose state is the checkpoint: save
it (``utils/convert.py::chain_state_to_numpy``) and the stream resumes bit
for bit, in this package or in the JAX one. Blocks prime with zeros, so the
first ``warmup_outputs`` outputs of a filtered stream are a transient, the
overlap-save convention. Filtered streams need ``block_len % decimation ==
0``, so that every block yields block_len/decimation outputs and the
carried tail keeps its shape.

Each op runs on the device of the block it is given. ``IirStream`` and
``SosStream`` keep their coefficients as host tuples, so a streamed 1-D
block on the card takes kernel B5 (``ops/iir.py``) with no coefficient read
back from the card; their ``impl`` field selects the route as in
``iir_block``.
"""

import functools
import warnings
from dataclasses import dataclass
from fractions import Fraction
from typing import Sequence

import torch

from gsdr_tpu_torch.carray import ComplexArray, expj
from gsdr_tpu_torch.ops.fir import fir
from gsdr_tpu_torch.ops.iir import iir_block, iir_sos_block
from gsdr_tpu_torch.ops.quad_demod import quad_fm_demod
from gsdr_tpu_torch.utils.phase import phase_digit_table, phase_fraction_from_table

_TWO_PI = 6.283185307179586


def _concat_last(a, b):
    if isinstance(a, ComplexArray) or isinstance(b, ComplexArray):
        return ComplexArray(torch.cat([a.re, b.re], dim=-1),
                            torch.cat([a.im, b.im], dim=-1))
    return torch.cat([a, b], dim=-1)


def _zeros_like_block(x, shape):
    if isinstance(x, ComplexArray):
        return ComplexArray.zeros(shape, device=x.device)
    return torch.zeros(shape, dtype=x.dtype, device=x.device)


@functools.lru_cache(maxsize=64)
def _digit_table(freq_hz, sample_rate, device):
    """The (4,) digit-fraction table of one oscillator, on ``device``, built
    once per (f, Fs, device)."""
    return torch.tensor(phase_digit_table([freq_hz], sample_rate)[0],
                        device=device)


@functools.lru_cache(maxsize=64)
def _taps_tensor(taps, device):
    """A FirStream's taps as a float32 tensor on ``device``, built once."""
    return torch.tensor(taps, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Mixer / LO stream
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MixerStream:
    """Streaming frequency shift by ``freq_shift_hz`` with exact phase
    continuity.

    State: the global sample offset reduced mod the LO's true period, an
    int32 scalar tensor. The wrap modulus is round(Fs) when the phase is
    periodic there (integral shifts at integral rates), else the exact
    period q of frac(f*n/Fs) (f/Fs = p/q over the floats' exact binary
    values) when q <= 2^24. A ratio with no such period (freq_shift_hz=0.1:
    the float 0.1 is not 1/10) warns at construction, and the LO phase then
    jumps by frac(f*round(Fs)/Fs) cycles every round(Fs) samples.
    """

    freq_shift_hz: float
    sample_rate: float

    # q above this has no headroom under the int32 digit-table index
    # budget (state + block must stay < 2^31)
    _MAX_PERIOD = 1 << 24

    def __post_init__(self):
        if not self._wrap_is_exact():
            warnings.warn(
                f"MixerStream(freq_shift_hz={self.freq_shift_hz}, "
                f"sample_rate={self.sample_rate}): neither round(Fs) nor "
                f"any period <= {self._MAX_PERIOD} samples is an exact "
                "period of frac(f*n/Fs), so streaming phase continuity "
                "is APPROXIMATE (a frac-cycle LO jump at each state "
                "wrap). Quantize the shift to an exactly representable "
                "ratio (integral Hz at integral Fs, or 1/2^k Hz "
                "multiples).",
                stacklevel=3)

    def _ratio(self):
        fs = Fraction(float(self.sample_rate))
        if fs <= 0:
            return None
        return Fraction(float(self.freq_shift_hz)) / fs

    def _wrap_is_exact(self):
        """True when _wrap_modulus() is a true period of frac(f*n/Fs)."""
        ratio = self._ratio()
        if ratio is None:
            return False
        m = max(1, int(round(self.sample_rate)))
        return (ratio * m).denominator == 1 \
            or ratio.denominator <= self._MAX_PERIOD

    def _wrap_modulus(self):
        m = max(1, int(round(self.sample_rate)))
        ratio = self._ratio()
        if ratio is None:
            return m
        # keep the mod-Fs state whenever it is already exact
        if (ratio * m).denominator == 1:
            return m
        q = ratio.denominator
        if q <= self._MAX_PERIOD:
            return q  # exact true period
        return m  # approximate (warned at construction)

    def init(self, first_sample_index=0, device="cuda"):
        n0 = int(first_sample_index) % self._wrap_modulus()
        return torch.tensor(n0, dtype=torch.int32, device=device)

    def step(self, state, x):
        n = x.shape[-1]
        idx = state + torch.arange(n, dtype=torch.int32, device=state.device)
        table = _digit_table(float(self.freq_shift_hz),
                             float(self.sample_rate), state.device)
        lo = expj(_TWO_PI * phase_fraction_from_table(idx, table))
        m = self._wrap_modulus()
        new_state = (state + n % m) % m
        if isinstance(x, ComplexArray):
            return new_state, x * lo
        return new_state, x * lo.to_complex()


# ---------------------------------------------------------------------------
# FIR stream (overlap-save with a fixed T-1 tail)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FirStream:
    """Streaming FIR + decimation with a carried (T-1)-sample input tail:
    with block_len % D == 0 every block gives block_len/D outputs and the
    decimation phase continues across blocks."""

    taps: tuple
    decimation: int = 1

    @property
    def num_taps(self):
        return len(self.taps)

    @property
    def warmup_outputs(self):
        """Leading outputs polluted by the zero-primed tail."""
        return -(-(self.num_taps - 1) // self.decimation)

    def init(self, x_example):
        lead = tuple(x_example.shape[:-1])
        return _zeros_like_block(x_example, lead + (self.num_taps - 1,))

    def step(self, state, x):
        if x.shape[-1] % self.decimation != 0:
            raise ValueError("block_len must be a multiple of decimation")
        buf = _concat_last(state, x)
        y = fir(buf, _taps_tensor(tuple(self.taps), buf.device),
                self.decimation)
        tail = buf[..., buf.shape[-1] - (self.num_taps - 1):] \
            if self.num_taps > 1 else self.init(x)
        return tail, y


# ---------------------------------------------------------------------------
# IIR streams
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class IirStream:
    """Streaming exact IIR: the transposed-DF-II state vector is the carry.
    ``impl`` as in ``iir_block`` ('auto' takes kernel B5 for a 1-D block on
    the card)."""

    b: tuple
    a: tuple
    block_len: int = 128
    impl: str = "auto"

    def init(self, x_example):
        lead = tuple(x_example.shape[:-1])
        return _zeros_like_block(x_example, lead + (len(self.b) - 1,))

    def step(self, state, x):
        y, zf = iir_block(self.b, self.a, x, zi=state,
                          block_len=self.block_len, impl=self.impl)
        return zf, y


@dataclass(frozen=True)
class SosStream:
    """Streaming cascade of second-order sections. State: each section's
    transposed-DF-II state stacked on a leading axis, shape (S,) + batch +
    (2,). ``impl`` as in ``iir_block``, for every section."""

    sos: tuple  # ((b0, b1, b2, a0, a1, a2), ...) rows
    block_len: int = 128
    impl: str = "auto"

    def init(self, x_example):
        lead = tuple(x_example.shape[:-1])
        return _zeros_like_block(x_example, (len(self.sos),) + lead + (2,))

    def step(self, state, x):
        y, zf = iir_sos_block(self.sos, x, zi=state,
                              block_len=self.block_len, impl=self.impl)
        return zf, y


# ---------------------------------------------------------------------------
# Quadrature FM discriminator stream (one-sample halo carry)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class QuadFmStream:
    """Streaming FM discriminator: carries the previous block's last
    sample, so a block of N samples yields N outputs. The very first output
    is a warm-up artifact (the carry primes at zero: atan2(0, 0) = 0)."""

    gain: float

    warmup_outputs = 1

    def init(self, x_example):
        lead = tuple(x_example.shape[:-1])
        return _zeros_like_block(x_example, lead + (1,))

    def step(self, state, x):
        buf = _concat_last(state, x)
        y = quad_fm_demod(buf, self.gain)
        return buf[..., buf.shape[-1] - 1:], y


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Chain:
    """Streaming ops composed into one (state tuple, block) -> step; the
    state tuple is the checkpoint of the whole pipeline."""

    stages: Sequence

    def init(self, x_example, first_sample_index=0):
        """The zero state of every stage, each shaped by running one step
        on the example block."""
        states = []
        cur = x_example
        for s in self.stages:
            if isinstance(s, MixerStream):
                states.append(s.init(first_sample_index, device=cur.device))
            else:
                states.append(s.init(cur))
            _, cur = s.step(states[-1], cur)
        return tuple(states)

    def step(self, states, x):
        new_states = []
        cur = x
        for s, st in zip(self.stages, states):
            st2, cur = s.step(st, cur)
            new_states.append(st2)
        return tuple(new_states), cur


def run_stream(chain, states, blocks):
    """Apply ``chain`` over a Python list of blocks."""
    outs = []
    for blk in blocks:
        states, y = chain.step(states, blk)
        outs.append(y)
    return states, outs


def scan_stream(step, state, blocks):
    """Run ``step`` over the leading block axis of ``blocks`` (a tensor or
    a planar ComplexArray shaped (num_blocks, ...)) and stack the outputs
    on a leading axis: (final_state, outs). JAX runs this as one
    ``lax.scan``; here it is a loop over the blocks."""
    outs = []
    for i in range(blocks.shape[0]):
        state, out = step(state, blocks[i])
        outs.append(out)
    if isinstance(outs[0], ComplexArray):
        return state, ComplexArray(torch.stack([o.re for o in outs]),
                                   torch.stack([o.im for o in outs]))
    return state, torch.stack(outs)
