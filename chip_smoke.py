"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Runs the receivers of gsdr_tpu_torch through the hand-written kernels, at
full width, 2^20 planar complex samples per step:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds every kernel from gsdr_tpu_torch/kernels/csrc with nvcc, one
     process per source, all at once;
  3. the flagship FmChannelizer (16 channels spaced 60 kHz around 100 MHz,
     64-tap Hamming low-pass, D=4, Fs = 1 MHz): kernel B1 at each grade of
     its dense front (bf16x3, the default, and bf16x2 on the tensor cores,
     f32 on the FP32 FMAs) against its plain version at that grade and
     against the f32 plain chain over two streamed steps, then 8 steps
     through impl='auto' at each grade with the launch counters set to 0
     just before (audio, counts; tones and block invariance at the
     default grade), then timing of each grade (the step's time is the
     host's: it swings with the process's history and does not rank the
     grades, tools/probe_grades.py steps);
  4. FM wideband critical (64 channels on the Fs/64 grid, 512 taps, D=64;
     benchmarks/run_all.py bench_fm_wideband): B2 (PFB front) at each
     grade against its plain version at that grade and against the f32
     plain chain over two steps (f32 also against B1), 8 steps through
     impl='auto' counted (it must take B2 at bf16x3, the default) with all
     64 tones recovered, then timing of B2 at each grade on the main
     path's buffers (bf16x2 and f32 through uncounted wrapper calls), and
     of the step through B2 and through B1;
  5. FM wideband D=8 (P=8 phases): B2 at each grade against its plain
     version and the f32 chain, and timed; B1 at f32;
  6. AM wideband critical (run_all.py bench_am_wideband) and the 8-channel
     AM receiver of __graft_entry__.py (am_d): B3-PFB and B3-dense at
     each grade against their plain versions at that grade and the f32
     plain chain, the two fronts against each other at f32, 8 steps of
     each through impl='auto' at bf16x3 counted (PFB front on the grid,
     dense off it), tones checked, then timing per grade;
  7. the channelized QPSK link (examples/qpsk_transmux.py at K=32, Q=8):
     32 x 32768 symbols per block through pfb_synthesize_block, AWGN at
     25 dB, then 8 blocks of 2^20 samples through
     pfb_channelize_block(impl='auto') counted (it must take B4), the
     one-tap LS equalizer and EVM < 0.3 on every channel; decisions equal
     to the fold path's on the same blocks but for ties, and error-free
     without the noise; B4 at each grade on those blocks (bf16x3 the
     route's launches; bf16x2 and f32, which no main path runs, through
     uncounted wrapper calls), against its plain version at that grade and
     the fold path; B4 timing of each grade there and at run_all.py
     bench_pfb's shape;
  8. the table-exact QPSK256 receiver, Qpsk256Modem(CIRCULAR,
     exact_tables=True), 8 blocks of 2^19 noisy symbols (sigma 0.05)
     through rx counted (it must take B6, which writes the uint8
     decisions itself), decisions against the plain version and a float64
     nearest neighbour on the host, the samples outside the candidate
     grid's box counted, the ideal loopback of all 256 symbols for both
     geometries, then B6 timing (grid launches per call by the profiler);
  9. iir_standalone: IirStream at bench_iir's size, 8 blocks of 2^20
     samples, for bench_iir's biquad, hw_parity.py's order 4, an order-8
     filter of four complex pole pairs and the biquad on a planar signal,
     counted (each block one B5 launch); y and the final state against
     the plain blocked scan and scipy's float64 lfilter; B5 timing (grid
     launches per call by the profiler), also at stream_fm's 2^18-sample
     block for its de-emphasis and one of its SOS sections; then a
     double-pole biquad, which 'auto' must send to the plain scan (no
     launch) and impl='cuda' must refuse;
 10. stream_fm: a single-station FM receiver as a streaming Chain (mixer,
     the flagship's 64-tap low-pass at D=4, discriminator, de-emphasis,
     an order-8 Butterworth audio low-pass as 4 biquads), 8 steps of 2^20
     samples of an FM carrier (1-kHz tone, 75-kHz deviation) counted
     after Chain.init (40 B5 launches and nothing else), against the same
     chain with plain IIR stages, the tone checked, step time and idle
     share;
 11. the single-channel ops on the verify recipe's signal (one FM
     carrier at +100 kHz, a 1-kHz tone at 5-kHz deviation, 65 taps, D=4,
     2^20 samples): fm_demod(impl='auto') counted (one B1 launch at C=1
     with the identity de-emphasis) at each grade against the kernel's
     plain version, the f32 plain chain and the composed chain (within the
     digit-table phase bound), the tone and its level; am_demod counted
     (one B3-dense launch at C=1) against its plain version at each grade;
     ResampleStream in four uneven blocks against one-shot resample; each
     kernel timed against its bound;
 12. the fm_rx command line in this process, at its defaults (129 taps,
     D=8, bf16x3), over an int8 capture of 2^24 samples at 2.048 MHz with
     five FM stations (75-kHz deviation), blocks of 2^20: counted (16 B1
     launches and nothing else), audio against FmChannelizer
     impl='torch' on the same staged blocks, the five tones, the halves
     through --save-state/--load-state bit-equal to the whole run, the
     tones of --audio-rate 48000, the native host library in use, the step
     time and the device's idle share, B1 at this shape timed;
 13. the four ported examples' main() on the card, counted (B1 for
     fm_broadcast_rx, B2 at K=32 for wideband_rx and wideband_duplex, no
     kernel for qpsk_link), B2 at K=32 timed;
 14. prints one JSON `kernels` line (B1, B2, B3-PFB, B3-dense and B4 once
     per grade, B6, B5) and, last, {"ok": true, "device": {...}}.

Timing: CUDA events around bursts of back-to-back calls (median of
bursts) and device time per kernel from torch.profiler. Launches made to
compare or time a kernel are not counted: every counter is set to 0 just
before a main path and read just after it. Any failed check, build or
launch exits non-zero before the last line.
Usage: python3 chip_smoke.py  (from the repository root, one GPU).
"""

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.examples.qpsk_transmux import (
    awgn,
    decide,
    equalize,
    link_quality,
    receive,
    transmit,
)
from gsdr_tpu_torch.examples.qpsk_transmux import lowpass as lowpass64
from gsdr_tpu_torch.kernels import _build
from gsdr_tpu_torch.kernels.am_chain import (
    am_chain,
    am_chain_reference,
    pfb_am_chain,
    pfb_am_chain_reference,
)
from gsdr_tpu_torch.kernels.channelize import (
    channelize_kernel,
    channelize_reference,
)
from gsdr_tpu_torch.kernels.fm_chain import (
    fm_chain,
    fm_chain_reference,
    pfb_fm_chain,
    pfb_fm_chain_reference,
)
from gsdr_tpu_torch.kernels.iir import iir_filter, iir_kernel
from gsdr_tpu_torch.kernels.qpsk256 import (
    qpsk256_kernel,
    qpsk256_reference,
    score_table,
    table_grid,
)
from gsdr_tpu_torch.ops.am import am_chain_args, am_demod
from gsdr_tpu_torch.ops.fm import fm_chain_args, fm_demod, fm_demod_gain
from gsdr_tpu_torch.ops.iir import iir_block
from gsdr_tpu_torch.ops.pfb import (
    _analysis_tables,
    _taps_key,
    pfb_channelize,
    pfb_channelize_block,
    uniform_bank_front,
    uniform_grid,
)
from gsdr_tpu_torch.ops.qpsk import qpsk_modulate_symbols
from gsdr_tpu_torch.ops.qpsk256 import CIRCULAR, RECTANGULAR
from gsdr_tpu_torch.ops.resample import ResampleStream, resample
from gsdr_tpu_torch.pipelines import (
    AmReceiver,
    FmChannelizer,
    Qpsk256Modem,
    fm_deemphasis_coeffs,
)
from gsdr_tpu_torch.runtime import (
    RingBuffer,
    int8_iq_to_planar,
    native_available,
)
from gsdr_tpu_torch.stream import (
    Chain,
    FirStream,
    IirStream,
    MixerStream,
    QuadFmStream,
    SosStream,
    run_stream,
)
from gsdr_tpu_torch.tools import fm_rx
from gsdr_tpu_torch.utils.precision import full_f32

N = 1 << 20            # complex input samples per step
STEPS = 8              # main-path steps
SKIP = 256             # zero-primed warm-up outputs left out of comparisons
AUDIO_REL_TOL = 1e-4   # FM kernel vs plain, max-abs error / max|audio|
CARRY_ATOL = 1e-4
ENV_ATOL = 1e-5        # AM envelope, absolute
FS = 1_000_000.0
TUNING = 100_000_000.0
GRID = 64              # the wideband receivers' Fs/64 grid
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12        # dense, tensor cores
PEAK_HBM_BYTES = 3.35e12
# The dense front's grades (B1, B4): tensor-core passes of the product
GRADES = ("bf16x3", "bf16x2", "f32")
PASSES = {"bf16x3": 3, "bf16x2": 2, "f32": 0}
# A grade against the f32 plain chain: FM audio, of max|audio| after the
# warm-up, the carries scaled alike (bf16x3 as the f32 kernel, JAX's
# on-TPU gate measured 4.2e-5; bf16x2 quantizes the signal to bf16, whose
# noise the discriminator turns into audio: 2e-2, JAX's own gate for the
# grade, tests/test_kernels.py test_fast_precision_grade); B4 against the
# fold path, of max|y| (bf16x3 as tests/test_torch_pfb_banks.py holds
# JAX's kernel route)
FM_GRADE_TOL = {"bf16x3": 1e-4, "bf16x2": 2e-2, "f32": 1e-4}
B4_FOLD_TOL = {"bf16x3": 3e-4, "bf16x2": 1e-2, "f32": 2e-5}
# B3 at a grade against the f32 plain chain, envelopes absolute: bf16x3 at
# JAX's test_pfb_front_matches_xla gate, bf16x2 at its grade's 2e-2
AM_GRADE_TOL = {"bf16x3": 2e-3, "bf16x2": 2e-2, "f32": ENV_ATOL}
COUNTERS = {"fm_chain": fm_chain, "pfb_fm_chain": pfb_fm_chain,
            "am_chain": am_chain, "pfb_am_chain": pfb_am_chain,
            "channelize": channelize_kernel, "qpsk256": qpsk256_kernel,
            "iir": iir_kernel}
# the channelized link: examples/qpsk_transmux.py at the largest K that
# 'auto' sends to B4 (the K of examples/wideband_duplex.py)
TMX_K, TMX_Q, TMX_SNR_DB = 32, 8, 25.0
TMX_FRAMES = N // TMX_K      # symbols per channel per 2^20-sample block
# B4 vs its plain version at the same grade: float32 sums of T = 256
# products (exact at the bf16 grades) in other orders
B4_REL_TOL = 1e-5
# At 25 dB the critical cascade's own inter-symbol interference (noiseless
# worst decision margin ~0.03 of 1) lets the noise flip a few of the 8.4M
# symbols, through any implementation: the noisy link is held to the fold
# path's decisions (equal but for ties closer than TMX_TIE to a quadrant
# edge) and to TMX_SER_MAX; the noiseless link must be error-free.
TMX_TIE, TMX_SER_MAX = 1e-3, 1e-5
Q256_N, Q256_SIGMA = 1 << 19, 0.05     # benchmarks/run_all.py's qpsk256 size
# a decision may differ from another's only where the two points' float64
# squared distances lie within float32 rounding of the scores (|score|
# <= ~12 here, a few ulps of it): an exact tie
Q256_TIE = 1e-5
DENSE_LIBRARY = "F.conv1d of the tap bank (front only), TF32 off"
TF32_LIBRARY = "F.conv1d of the tap bank (front only), TF32 on"
PFB_LIBRARY = ("grouped F.conv1d fold + torch.matmul DFT bank "
               "(front only), TF32 off")
PFB_TF32_LIBRARY = ("grouped F.conv1d fold + torch.matmul DFT bank "
                    "(front only), TF32 on")


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def reset_counts():
    for k in COUNTERS.values():
        k.launches = 0


def counts():
    return {name: k.launches for name, k in COUNTERS.items()}


def lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def flagship(impl, **kw):
    return FmChannelizer(
        sample_rate=FS, tuning_frequency=TUNING,
        channel_frequencies=tuple(TUNING - 480_000.0 + 60_000.0 * i
                                  for i in range(16)),
        frequency_deviation=75_000.0, decimation=4,
        low_pass_taps=lowpass(64, 0.03), impl=impl, device="cuda", **kw)


def fm_wideband(impl, decimation=GRID, **kw):
    """benchmarks/run_all.py bench_fm_wideband: 64 channels -(Fs/64)*i,
    512-tap prototype with cutoff 0.4/64, D=64 (critical) or 8."""
    return FmChannelizer(
        sample_rate=FS, tuning_frequency=0.0,
        channel_frequencies=tuple(-(FS / GRID) * i for i in range(GRID)),
        frequency_deviation=75_000.0, decimation=decimation,
        low_pass_taps=lowpass(8 * GRID, 0.4 / GRID), impl=impl,
        device="cuda", **kw)


class PlainAtGrade:
    """A model's stream through the plain chain with its front at the
    model's grade (fm_chain_reference, pfb_fm_chain_reference,
    am_chain_reference or pfb_am_chain_reference with precision=...),
    stepped as the model steps: the kernel's plain version on a stream."""

    def __init__(self, model):
        self.model = model
        self.impl = f"plain at {model.precision}"

    def __getattr__(self, name):
        return getattr(self.model, name)

    def step(self, state, rf):
        m = self.model
        n0, tail, *carries = state
        fs, t = int(round(m.sample_rate)), m.num_taps
        buf = ComplexArray(torch.cat([tail.re, rf.re]),
                           torch.cat([tail.im, rf.im]))
        rot0 = torch.remainder(n0 + (fs - (t - 1) % fs), fs).to(torch.int32)
        pfb = m.front == "pfb"
        front = (m.poly_taps, m.dft_bank, t) if pfb else (m.tap_bank,)
        if isinstance(m, FmChannelizer):
            ref = pfb_fm_chain_reference if pfb else fm_chain_reference
            audio, *carries = ref(buf, *front, m.lo_table, rot0, m.decimation,
                                  m.gain, m.deemph, *carries,
                                  precision=m.precision)
        else:
            ref = pfb_am_chain_reference if pfb else am_chain_reference
            audio = ref(buf, *front, m.lo_table, rot0, m.decimation,
                        precision=m.precision)
        n0 = torch.remainder(n0 + rf.shape[-1] % fs, fs).to(torch.int32)
        return (n0, buf[..., buf.shape[-1] - (t - 1):], *carries), audio


def am_wideband(impl, **kw):
    """benchmarks/run_all.py bench_am_wideband: the same grid and filter,
    D=64."""
    return AmReceiver(
        sample_rate=FS, tuning_frequency=0.0,
        channel_frequencies=tuple(-(FS / GRID) * i for i in range(GRID)),
        decimation=GRID, low_pass_taps=lowpass(8 * GRID, 0.4 / GRID),
        impl=impl, device="cuda", **kw)


def am_d(impl, **kw):
    """The 8-channel AM receiver of __graft_entry__.py (am_d)."""
    return AmReceiver(
        sample_rate=FS, tuning_frequency=TUNING,
        channel_frequencies=tuple(TUNING - 200_000.0 + 50_000.0 * i
                                  for i in range(8)),
        decimation=4, low_pass_taps=lowpass(32, 0.04), impl=impl,
        device="cuda", **kw)


def _time_axis(start, n, fs=FS):
    return torch.arange(start, start + n, dtype=torch.float64,
                        device="cuda") / fs


def fm_signal(model, start, n, seed=7):
    """Flagship FM carriers, made on the card in float64. Not white noise:
    noise puts samples on the atan2 branch cut, where two correct
    implementations differ by 2*pi*gain."""
    phases = np.random.default_rng(seed).uniform(0, 6, model.num_channels)
    t = _time_axis(start, n)
    re = torch.zeros(n, dtype=torch.float64, device="cuda")
    im = torch.zeros_like(re)
    amp = 0.5 / model.num_channels
    for k, f in enumerate(model.channel_frequencies):
        msg = torch.sin(2 * np.pi * (700.0 + 370.0 * k) * t + phases[k])
        ph = 2 * np.pi * (f - TUNING) * t + 0.35 * msg
        re += amp * torch.cos(ph)
        im += amp * torch.sin(ph)
    return ComplexArray(re.float(), im.float())


def grid_tone(k):
    return 200.0 + 40.0 * k


def wideband_fm_signal(model, start, n, seed=7, deviation=1_000.0):
    """An FM carrier on every channel of the model, at the model's rate,
    tone 200 + 40*k Hz (examples/wideband_rx.py's construction; at the
    default 1-kHz deviation each carrier stays inside a 15.6-kHz channel)."""
    phases = np.random.default_rng(seed).uniform(0, 6, model.num_channels)
    t = _time_axis(start, n, model.sample_rate)
    re = torch.zeros(n, dtype=torch.float64, device="cuda")
    im = torch.zeros_like(re)
    amp = 1.0 / model.num_channels
    for k, f in enumerate(model.channel_frequencies):
        tone = grid_tone(k)
        ph = (2 * np.pi * (f - model.tuning_frequency) * t
              + (deviation / tone) * torch.sin(2 * np.pi * tone * t
                                               + phases[k]))
        re += amp * torch.cos(ph)
        im += amp * torch.sin(ph)
    return ComplexArray(re.float(), im.float())


def am_signal(model, start, n, seed=7):
    """An AM carrier on every channel, 50% modulated by tone 200 + 40*k Hz,
    envelope within (0, 1)."""
    phases = np.random.default_rng(seed).uniform(0, 6, (model.num_channels, 2))
    t = _time_axis(start, n)
    re = torch.zeros(n, dtype=torch.float64, device="cuda")
    im = torch.zeros_like(re)
    for k, f in enumerate(model.channel_frequencies):
        env = 0.6 * (1.0 + 0.5 * torch.sin(2 * np.pi * grid_tone(k) * t
                                           + phases[k, 0]))
        ph = 2 * np.pi * (f - model.tuning_frequency) * t + phases[k, 1]
        re += env * torch.cos(ph)
        im += env * torch.sin(ph)
    return ComplexArray(re.float(), im.float())


def cuda_ms(fn, reps, bursts=5, warmup=3):
    """Milliseconds per call of fn(): CUDA events around a burst of reps
    back-to-back calls, median over bursts."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(bursts):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / reps)
    return statistics.median(per_call)


def device_us(fn, reps, tries=3):
    """Device time per call of fn() by kernel name (torch.profiler): the
    mean over the kernel's records, times its launches per call (its
    records over reps, rounded), so a record the trace drops (in this
    process a trace can come back one record short) does not lower the
    time. A trace that records no device activity is taken again, up to
    ``tries`` times; an empty result means not measured."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if (str(e.device_type).endswith("CUDA")
                    and e.self_device_time_total > 0):
                out[e.key[:60]] = (e.self_device_time_total / e.count
                                   * max(1, round(e.count / reps)))
        if out:
            break
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def grid_launches(fn, reps=20, tries=3):
    """(device kernels per call of fn() as torch.profiler counts them,
    rounded; the records it counted over ``reps`` calls), (None, 0) when
    the trace holds none; launch counters are restored. A trace that
    records no device activity is taken again, up to ``tries`` times, as
    in device_us."""
    from torch.profiler import ProfilerActivity, profile

    before = counts()
    fn()
    torch.cuda.synchronize()
    n = 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events()
                if str(e.device_type).endswith("CUDA"))
        if n:
            break
    for name, k in COUNTERS.items():
        k.launches = before[name]
    return (round(n / reps) if n else None), f"{n} in {reps} calls"


def rel_err(got, want, skip=0):
    got, want = got[:, skip:], want[:, skip:]
    return float((got - want).abs().max() / want.abs().max())


def bound(flops, nbytes, tensor=None):
    """(bound ms, what bounds it) on the H100's peaks: the least time over
    the algorithms for the work, `flops` FP32 operations outside the
    tensor cores or, at a bf16 grade, `tensor` = (tensor-core FLOP at the
    dense bf16 peak, FP32 FLOP beside them), against `nbytes` of HBM
    traffic."""
    t_ops = flops / PEAK_FP32_FLOPS
    if tensor is not None:
        t_ops = min(t_ops, tensor[0] / PEAK_BF16_FLOPS
                    + tensor[1] / PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_tones(audio, rate, tone_of, what, hi_hz=None):
    """Each channel's audio (or envelope) peaks at its own tone, searched
    from 100 Hz up to hi_hz (Nyquist by default)."""
    a = audio.double()
    spec = torch.fft.rfft((a - a.mean(-1, keepdim=True))
                          * torch.hann_window(a.shape[-1], dtype=torch.float64,
                                              device=a.device)).abs()
    bin_hz = rate / a.shape[-1]
    lo = int(100.0 / bin_hz) + 1
    hi = spec.shape[-1] if hi_hz is None else int(hi_hz / bin_hz)
    for k in range(a.shape[0]):
        peak = (int(spec[k, lo:hi].argmax()) + lo) * bin_hz
        check(abs(peak - tone_of(k)) <= 2 * bin_hz + 5.0,
              f"{what}: channel {k} tone at {peak:.1f} Hz, "
              f"want {tone_of(k):.1f}")


def buffer(model, rf):
    """The tail-prepended buffer of a fresh stream's first step."""
    tail = model.init()[1]
    return ComplexArray(torch.cat([tail.re, rf.re]),
                        torch.cat([tail.im, rf.im]))


def compare_fm(kern, others, signal, steps=2, tol=AUDIO_REL_TOL):
    """Stream `steps` blocks through kern and each model of others; every
    other must agree with kern within tol of max|audio| after the warm-up
    and CARRY_ATOL, scaled by tol / AUDIO_REL_TOL, on the carries. Returns
    the worst max-abs and rel error."""
    carry_atol = CARRY_ATOL * tol / AUDIO_REL_TOL
    models = [kern] + others
    states = [m.init() for m in models]
    max_abs = worst = 0.0
    m_out = N // kern.decimation
    for i in range(steps):
        rf = signal(kern, i * N, N)
        outs = []
        for j, m in enumerate(models):
            states[j], y = m.step(states[j], rf)
            outs.append(y)
        torch.cuda.synchronize()
        skip = SKIP if i == 0 else 0
        for j in range(1, len(models)):
            yk, yo = outs[0], outs[j]
            check(tuple(yk.shape) == tuple(yo.shape) ==
                  (kern.num_channels, m_out), f"shape {tuple(yk.shape)}")
            err = rel_err(yk, yo, skip)
            max_abs = max(max_abs, float((yk - yo)[:, skip:].abs().max()))
            worst = max(worst, err)
            check(err <= tol,
                  f"{kern.impl} vs {models[j].impl} step {i}: audio rel err "
                  f"{err:.3g}")
            sk, so = states[0], states[j]
            for a, b, what in ((sk[2].re, so[2].re, "disc_carry.re"),
                               (sk[2].im, so[2].im, "disc_carry.im"),
                               (sk[3], so[3], "deemph_zi")):
                d = float((a - b).abs().max())
                check(d <= carry_atol, f"{kern.impl} vs {models[j].impl} "
                      f"step {i}: {what} differs by {d:.3g}")
            check(int(sk[0]) == int(so[0]), "n0 differs")
    return max_abs, worst


def compare_am(models, signal, steps=2, tol=ENV_ATOL):
    """Stream `steps` blocks through every model; all envelopes within
    tol (absolute) of the first's. Returns the worst max-abs error."""
    states = [m.init() for m in models]
    worst = 0.0
    for i in range(steps):
        rf = signal(models[0], i * N, N)
        outs = []
        for j, m in enumerate(models):
            states[j], y = m.step(states[j], rf)
            outs.append(y)
        torch.cuda.synchronize()
        for j in range(1, len(models)):
            d = float((outs[0] - outs[j]).abs().max())
            worst = max(worst, d)
            check(d <= tol, f"AM {models[0].impl} vs {models[j].impl} "
                  f"step {i}: envelope differs by {d:.3g}")
    return worst


def counted(what, run, want_counts):
    """run() with every counter set to 0 just before and read just after;
    the counts must equal want_counts. Returns (run(), counts)."""
    torch.cuda.synchronize()
    reset_counts()
    out = run()
    torch.cuda.synchronize()
    got = counts()
    want = {name: want_counts.get(name, 0) for name in COUNTERS}
    check(got == want, f"{what} launches {got}, want {want}")
    return out, got


def main_path(model, blocks, want_counts):
    """Stream blocks through the model, counted; the counts must equal
    want_counts."""
    def run():
        state = model.init()
        outs = []
        for rf in blocks:
            state, audio = model.step(state, rf)
            outs.append(audio)
        return outs

    outs, got = counted(f"{type(model).__name__}(impl={model.impl!r})", run,
                        want_counts)
    for a in outs:
        check(tuple(a.shape) == (model.num_channels, N // model.decimation),
              f"audio shape {tuple(a.shape)}")
        check(bool(torch.isfinite(a).all()), "non-finite audio")
    return outs, got


def time_calls(fn):
    """(ms per call back to back, device us per call by kernel, idle
    share); launch counters are restored."""
    before = counts()
    ms = cuda_ms(fn, reps=20)
    dev = device_us(fn, reps=10)
    for name, k in COUNTERS.items():
        k.launches = before[name]
    idle = 1.0 - sum(dev.values()) / (ms * 1e3) if dev else None
    return ms, dev, idle


def time_step(model, rf):
    """time_calls of the model's step, the state carried."""
    state = model.init()

    def one_step():
        nonlocal state
        state, _ = model.step(state, rf)

    return time_calls(one_step)


def time_kernel(kernel, plain, library, args, plain_reps=4, **kw):
    """(kernel ms, kernel device us by name, plain ms, library ms) of
    kernel(*args, **kw) and plain(*args, **kw); the kernel's counter is
    restored, timing launches are no main-path launches."""
    before = kernel.launches
    k_ms = cuda_ms(lambda: kernel(*args, **kw), reps=20)
    k_dev = device_us(lambda: kernel(*args, **kw), reps=10)
    kernel.launches = before
    p_ms = cuda_ms(lambda: plain(*args, **kw), reps=plain_reps, bursts=3)
    lib_ms = cuda_ms(library, reps=20)
    return k_ms, k_dev, p_ms, lib_ms


def front_flops(model):
    """FLOP per decimated output of the cheapest known front for the
    model's channels, whichever front the model runs: the direct complex
    tap bank, 8*C*T; or, where the shifts sit on an Fs/K grid with D | K,
    the polyphase fold, 4*T, plus the channel stage, the dense (2C, 2K)
    product 8*C*K or a K-point FFT, about 5*K*log2(K), whichever is fewer."""
    c, t, d = model.num_channels, model.num_taps, model.decimation
    flops = 8.0 * c * t
    grid = uniform_grid([model.tuning_frequency - f
                         for f in model.channel_frequencies],
                        model.sample_rate, multiple_of=d)
    if grid is not None:
        k = grid[0]
        flops = min(flops, 4.0 * t + min(8.0 * c * k, 5.0 * k * math.log2(k)))
    return flops


def table_bytes(model):
    """Bytes of the front's tables the kernel reads."""
    if model.front == "pfb":
        return 4.0 * (model.poly_taps.numel() + model.dft_bank.numel())
    return 4.0 * model.tap_bank.numel()


def tensor_ops(model, m, grade):
    """(tensor-core FLOP, FP32 FLOP beside them, back end excluded) of the
    model's front at a bf16 grade over m outputs, or None at f32: the
    dense front's passes x 8*C*T per output; the PFB front's passes x
    8*C*K of the DFT-bank product plus its 4*T fold on the FP32 units."""
    if not PASSES[grade]:
        return None
    c, t = model.num_channels, model.num_taps
    if model.front == "pfb":
        return PASSES[grade] * 8.0 * c * model.pfb_grid[0] * m, 4.0 * t * m
    return PASSES[grade] * 8.0 * c * t * m, 0.0


def fm_bound(model, nb, grade="f32"):
    """(FLOPs, bytes, tensor) of one FM chain call over an nb-sample
    buffer: the cheapest FP32 front plus the back end's 16 operations per
    output and channel (rotor and discriminator products, de-emphasis; the
    sincos and atan2 left out), and the buffer, tables and carries in, the
    audio and carries out. At a bf16 grade the front's product on the
    tensor cores is another algorithm (``tensor_ops``), the back end
    beside it (``tensor``)."""
    c, t, d = model.num_channels, model.num_taps, model.decimation
    m = (nb - t) // d + 1
    io = 4 * (2 * nb + 4 * c + 3 + 3 * c + c * m + 3 * c)
    tensor = tensor_ops(model, m, grade)
    if tensor is not None:
        tensor = (tensor[0], tensor[1] + 16.0 * c * m)
    return ((front_flops(model) + 16.0 * c) * m, io + table_bytes(model),
            tensor)


def am_bound(model, nb, grade="f32"):
    """As fm_bound for the AM chain: the cheapest front plus ~8 operations
    of envelope per output and channel; the buffer and tables in, the
    audio out."""
    c, t, d = model.num_channels, model.num_taps, model.decimation
    m = (nb - t) // d + 1
    tensor = tensor_ops(model, m, grade)
    if tensor is not None:
        tensor = (tensor[0], tensor[1] + 8.0 * c * m)
    return ((front_flops(model) + 8.0 * c) * m,
            4.0 * (2 * nb + c * m) + table_bytes(model), tensor)


def pfb_front_library(model, buf, tf32=False):
    """The library yardstick of the PFB front alone: a grouped F.conv1d
    fold per phase and one torch.matmul with the DFT bank, TF32 off (the
    f32 yardstick) or on (the nearest library grade to the bf16 ones)."""
    def run():
        with full_f32():
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            uniform_bank_front(buf, model.poly_taps, model.dft_bank,
                               model.num_taps, model.decimation)
    return run


def conv_library(buf, bank, decimation, tf32=False):
    """The library yardstick of a dense front alone: F.conv1d of the
    complex tap bank, TF32 off (the f32 yardstick) or on (the nearest
    library grade to the bf16 ones)."""
    lhs = torch.stack([buf.re, buf.im])[None]

    def run():
        with full_f32():
            torch.backends.cudnn.allow_tf32 = tf32
            F.conv1d(lhs, bank, stride=decimation)
    return run


def dense_front_library(model, buf, tf32=False):
    return conv_library(buf, model.tap_bank, model.decimation, tf32)


def kernel_entry(name, source, replaces, launches, max_abs, timing, bnd,
                 grade="f32", main_path=True, **extra):
    """One entry of the kernels line; ``main_path`` false marks a grade
    that no main path launches (its launches are 0)."""
    k_ms, _, p_ms, lib_ms = timing
    return {"name": name, "grade": grade, "main_path": main_path,
            "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms,
            **extra}


def flagship_phase():
    """Phase 3: B1 at the flagship at each grade; returns its kernels-line
    entries, one per grade."""
    plain = flagship("torch")
    blocks = [fm_signal(plain, i * N, N, seed=11) for i in range(STEPS)]
    entries = []
    for grade in GRADES:
        kern = flagship("cuda", precision=grade)
        max_abs, rel_plain = compare_fm(kern, [PlainAtGrade(kern)], fm_signal)
        _, rel_f32 = compare_fm(kern, [plain], fm_signal,
                                tol=FM_GRADE_TOL[grade])
        print(f"fm_chain at {grade} vs its plain version: audio max-abs "
              f"{max_abs:.3g}, rel {rel_plain:.3g} (tol {AUDIO_REL_TOL}); vs "
              f"the f32 plain chain: rel {rel_f32:.3g} (tol "
              f"{FM_GRADE_TOL[grade]}), carries atol {CARRY_ATOL} scaled "
              f"alike")

        # the user's path: the default grade is bf16x3, as the JAX model's
        model = (flagship("auto") if grade == "bf16x3"
                 else flagship("auto", precision=grade))
        check(model.front == "toeplitz" and model.precision == grade,
              f"flagship at {grade}: dense front, grade {model.precision}")
        outs, got = main_path(model, blocks, {"fm_chain": STEPS})
        check_tones(outs[-1], model.audio_rate, lambda k: 700.0 + 370.0 * k,
                    f"flagship at {grade}")
        if grade == "bf16x3":
            _, whole = model.step(model.init(), blocks[0])
            st, h1 = model.step(model.init(), blocks[0][..., :N // 2])
            _, h2 = model.step(st, blocks[0][..., N // 2:])
            # The halves reach the same global samples through another
            # reduced stream index, so the float32 digit-table LO phase
            # rounds differently (bounded at ~6e-5 cycles, utils/phase.py);
            # held to the JAX package's block-invariance tolerance, rtol =
            # atol = 1e-4 (tests/test_pipelines.py).
            halves = torch.cat([h1, h2], dim=-1)
            inv = float(((halves - whole).abs() - 1e-4 * whole.abs()).max())
            check(inv <= 1e-4, f"block invariance excess {inv:.3g}")
            print(f"block invariance at {grade}: max-abs "
                  f"{float((halves - whole).abs().max()):.3g}")
        print(f"main path: flagship at {grade}, {STEPS} steps of {N} "
              f"samples, fm_chain launches {got['fm_chain']}, tones "
              f"recovered")

        step_ms, step_dev, idle = time_step(model, blocks[0])
        buf = buffer(model, blocks[0])
        n0, _, cf, cz = model.init()
        args = (buf, model.tap_bank, model.lo_table, n0, model.decimation,
                model.gain, model.deemph, cf, cz)
        timing = time_kernel(fm_chain, fm_chain_reference,
                             dense_front_library(model, buf), args,
                             precision=grade)
        tf32_ms = (cuda_ms(conv_library(buf, model.tap_bank, model.decimation,
                                        tf32=True), reps=20)
                   if PASSES[grade] else None)
        # where B1's time goes: its dense front alone at this grade, run by
        # B4 on the flagship's bank (the same device function, the planar
        # y stored in place of the back end)
        before = channelize_kernel.launches
        front_us = device_us(lambda: channelize_kernel(
            buf, model.tap_bank, model.decimation, precision=grade), reps=10)
        channelize_kernel.launches = before
        flops, nbytes, tensor = fm_bound(model, buf.re.shape[-1], grade)
        bnd = bound(flops, nbytes, tensor)
        line = {
            "phase": f"flagship_{grade}", "grade": grade,
            "msps": N / (step_ms * 1e-3) / 1e6, "step_ms": step_ms,
            "device_us_per_step": step_dev, "device_idle_share": idle,
            "kernel_ms": timing[0], "kernel_device_us": timing[1],
            "kernel_device_ms": sum(timing[1].values()) / 1e3,
            "front_alone_device_us": front_us,
            "plain_ms": timing[2], "library_ms": timing[3],
            "library": DENSE_LIBRARY, "library_tf32_ms": tf32_ms,
            "library_tf32": TF32_LIBRARY, "bound_us": bnd[0] * 1e3,
            "bound_by": bnd[1], "fp32_gflop_per_step": flops / 1e9,
            "tensor_gflop_per_step": tensor[0] / 1e9 if tensor else 0.0,
            "mbytes_per_step": nbytes / 1e6, "vs_plain_rel": rel_plain,
            "vs_f32_rel": rel_f32,
            "launches_per_step": got["fm_chain"] / STEPS, "card": CARD}
        if grade == "bf16x3":
            line.update({"metric": "fm_channelizer_16ch_64tap_dec4_input_msps",
                         "value": line["msps"], "unit": "Msamples/s"})
        print(json.dumps(line))
        entries.append(kernel_entry(
            "fm_chain", "gsdr_tpu_torch/kernels/csrc/fm_chain.cu",
            "gsdr_tpu/kernels/fm_chain_pallas.py:888", got["fm_chain"],
            max_abs, timing, bnd, grade=grade, library_tf32_ms=tf32_ms))
    return entries


def pfb_fm_grades(decimation):
    """B2 at each grade at the wideband grid with D = decimation: against
    its plain version at the grade and the f32 plain chain over two steps
    (and at f32 against B1); returns ({grade: (max-abs, rel plain, rel
    f32)}, the dense f32 model)."""
    plain = fm_wideband("pfb_torch", decimation)
    dense = fm_wideband("cuda", decimation, precision="f32")
    out = {}
    for grade in GRADES:
        kern = fm_wideband("pfb", decimation, precision=grade)
        check(kern.front == "pfb" and kern.pfb_grid[0] == GRID, "B2 grid")
        max_abs, rel_plain = compare_fm(kern, [PlainAtGrade(kern)],
                                        wideband_fm_signal)
        _, rel_f32 = compare_fm(kern, [plain], wideband_fm_signal,
                                tol=FM_GRADE_TOL[grade])
        if grade == "f32":
            _, rel_dense = compare_fm(kern, [dense], wideband_fm_signal)
            print(f"pfb_fm_chain (K=64, D={decimation}) at f32 vs dense "
                  f"fm_chain: rel {rel_dense:.3g} (tol {AUDIO_REL_TOL})")
        print(f"pfb_fm_chain (K=64, D={decimation}) at {grade} vs its plain "
              f"version: max-abs {max_abs:.3g}, rel {rel_plain:.3g} (tol "
              f"{AUDIO_REL_TOL}); vs the f32 plain chain: rel {rel_f32:.3g} "
              f"(tol {FM_GRADE_TOL[grade]}), carries scaled alike")
        out[grade] = (max_abs, rel_plain, rel_f32)
    return out, dense


def fm_wideband_phase():
    """Phase 4: B2 at FM wideband critical at each grade; returns its
    entries, one per grade (bf16x3 the main path's)."""
    errs, dense = pfb_fm_grades(GRID)
    model = fm_wideband("auto")
    check(model.front == "pfb" and model.precision == "bf16x3",
          "'auto' must take the PFB front at bf16x3 here")
    blocks = [wideband_fm_signal(model, i * N, N, seed=11)
              for i in range(STEPS)]
    outs, got = main_path(model, blocks, {"pfb_fm_chain": STEPS})
    check_tones(outs[-1], model.audio_rate, grid_tone, "FM wideband")
    print(f"main path: FM wideband critical at bf16x3, {STEPS} steps, "
          f"launches {got}, all {GRID} tones recovered")

    buf = buffer(model, blocks[0])
    n0, _, cf, cz = model.init()
    args = (buf, model.poly_taps, model.dft_bank, model.num_taps,
            model.lo_table, n0, model.decimation, model.gain, model.deemph,
            cf, cz)
    steps = {}
    for impl, m in (("auto", model), ("cuda", dense)):
        step_ms, step_dev, idle = time_step(m, blocks[0])
        steps[impl] = {"msps": N / (step_ms * 1e-3) / 1e6, "step_ms": step_ms,
                       "device_us_per_step": step_dev,
                       "device_idle_share": idle}
    d_args = (buf, dense.tap_bank, dense.lo_table, n0, dense.decimation,
              dense.gain, dense.deemph, cf, cz)
    before = fm_chain.launches
    dense_ms = {g: cuda_ms(lambda: fm_chain(*d_args, precision=g), reps=10)
                for g in GRADES}
    fm_chain.launches = before
    tf32_ms = cuda_ms(pfb_front_library(model, buf, tf32=True), reps=20)
    entries, by_grade = [], {}
    for grade in GRADES:
        timing = time_kernel(pfb_fm_chain, pfb_fm_chain_reference,
                             pfb_front_library(model, buf), args,
                             precision=grade)
        flops, nbytes, tensor = fm_bound(model, buf.re.shape[-1], grade)
        bnd = bound(flops, nbytes, tensor)
        by_grade[grade] = {
            "kernel_ms": timing[0], "kernel_device_us": timing[1],
            "kernel_device_ms": sum(timing[1].values()) / 1e3,
            "plain_ms": timing[2], "bound_us": bnd[0] * 1e3,
            "bound_by": bnd[1],
            "tensor_gflop": tensor[0] / 1e9 if tensor else 0.0,
            "vs_plain_rel": errs[grade][1], "vs_f32_rel": errs[grade][2]}
        main = grade == "bf16x3"
        entries.append(kernel_entry(
            "pfb_fm_chain", "gsdr_tpu_torch/kernels/csrc/fm_chain.cu",
            "gsdr_tpu/kernels/fm_chain_pallas.py:414",
            got["pfb_fm_chain"] if main else 0, errs[grade][0], timing, bnd,
            grade=grade, main_path=main, library_tf32_ms=tf32_ms))
    print(json.dumps({
        "metric": "fm_wideband_64ch_crit_input_msps", "unit": "Msamples/s",
        "value": steps["auto"]["msps"], "step_auto_pfb_bf16x3": steps["auto"],
        "step_cuda_dense_f32": steps["cuda"], "pfb_by_grade": by_grade,
        "dense_kernel_ms_by_grade": dense_ms,
        "dense_bound_by_grade": {
            g: bound(*fm_bound(dense, buf.re.shape[-1], g)) for g in GRADES},
        "library_ms": entries[0]["library_ms"], "library": PFB_LIBRARY,
        "library_tf32_ms": tf32_ms, "library_tf32": PFB_TF32_LIBRARY,
        "card": CARD}))
    return entries


def fm_d8_phase():
    """Phase 5: B2 at each grade at the D=8 variant (P=8) against its plain
    version, the f32 plain chain and (f32) B1, and the kernels' times
    there."""
    errs, dense = pfb_fm_grades(8)
    check(fm_wideband("auto", 8).front == "pfb", "D=8: 'auto' route")
    kern = fm_wideband("pfb", 8)
    rf = wideband_fm_signal(kern, 0, N)
    buf = buffer(kern, rf)
    n0, _, cf, cz = kern.init()
    back = (kern.lo_table, n0, 8, kern.gain, kern.deemph, cf, cz)
    before = counts()
    by_grade = {}
    for grade in GRADES:
        call = lambda: pfb_fm_chain(buf, kern.poly_taps, kern.dft_bank,
                                    kern.num_taps, *back, precision=grade)
        dev = device_us(call, reps=10)
        by_grade[grade] = {
            "kernel_ms": cuda_ms(call, reps=10), "kernel_device_us": dev,
            "kernel_device_ms": sum(dev.values()) / 1e3,
            "bound": bound(*fm_bound(kern, buf.re.shape[-1], grade)),
            "max_abs": errs[grade][0], "vs_plain_rel": errs[grade][1],
            "vs_f32_rel": errs[grade][2]}
    dense_ms = cuda_ms(lambda: fm_chain(buf, dense.tap_bank, *back,
                                        precision="f32"), reps=4)
    for name, k in COUNTERS.items():
        k.launches = before[name]
    print(json.dumps({
        "phase": "fm_wideband_64ch_d8", "pfb_by_grade": by_grade,
        "dense_f32_kernel_ms": dense_ms,
        "dense_f32_bound": bound(*fm_bound(dense, buf.re.shape[-1])),
        "card": CARD}))


def am_grades(make, what):
    """B3 on one front at each grade (make(impl, precision=...)) against its
    plain version at the grade and the f32 plain chain; returns {grade:
    (max-abs vs plain, max-abs vs f32)}."""
    plain = make("pfb_torch" if what == "pfb" else "torch")
    out = {}
    for grade in GRADES:
        kern = make("pfb" if what == "pfb" else "cuda", precision=grade)
        err = compare_am([kern, PlainAtGrade(kern)], am_signal)
        gap = compare_am([kern, plain], am_signal, tol=AM_GRADE_TOL[grade])
        print(f"AM {what} at {grade}: vs its plain version {err:.3g} (tol "
              f"{ENV_ATOL}), vs the f32 plain chain {gap:.3g} (tol "
              f"{AM_GRADE_TOL[grade]}, absolute)")
        out[grade] = (err, gap)
    return out


def am_phase():
    """Phase 6: B3 on both fronts at each grade; returns their entries,
    one per front and grade (bf16x3 the main paths')."""
    err_pfb = am_grades(am_wideband, "pfb")
    err_am_d = am_grades(am_d, "dense")
    pfb, dense = (am_wideband("pfb", precision="f32"),
                  am_wideband("cuda", precision="f32"))
    err_dense = compare_am([dense, am_wideband("torch")], am_signal)
    err_fronts = compare_am([pfb, dense], am_signal)
    print(f"AM wideband at f32: am_chain vs plain {err_dense:.3g}, fronts "
          f"{err_fronts:.3g} (tol {ENV_ATOL} absolute)")
    # the dense front on the wideband grid, the A/B partner of B3-PFB
    buf = buffer(dense, am_signal(dense, 0, N))
    args = (buf, dense.tap_bank, dense.lo_table, dense.init()[0], GRID)
    before = am_chain.launches
    dense_ms = cuda_ms(lambda: am_chain(*args, precision="f32"), reps=10)
    dense_dev = device_us(lambda: am_chain(*args, precision="f32"), reps=5)
    am_chain.launches = before
    print(json.dumps({
        "phase": "am_wideband_dense_f32", "kernel_ms": dense_ms,
        "kernel_device_us": dense_dev,
        "bound": bound(*am_bound(dense, buf.re.shape[-1])),
        "card": CARD}))

    entries = []
    for model, kernel, plain, library, what, name, errs in (
            (am_wideband("auto"), pfb_am_chain, pfb_am_chain_reference,
             pfb_front_library, PFB_LIBRARY, "pfb_am_chain", err_pfb),
            (am_d("auto"), am_chain, am_chain_reference,
             dense_front_library, DENSE_LIBRARY, "am_chain", err_am_d)):
        check(model.precision == "bf16x3", f"AM {name}: default grade")
        blocks = [am_signal(model, i * N, N, seed=11) for i in range(STEPS)]
        outs, got = main_path(model, blocks, {name: STEPS})
        env = outs[-1]
        check(float(env.min()) >= -1.0 and float(env.max()) <= 1.0,
              "envelope outside [-1, 1]")
        # below 5 kHz: am_d's 32-tap filter passes its neighbours, whose
        # carriers beat with the channel's at 50 kHz in the envelope
        check_tones(env, model.audio_rate, grid_tone, f"AM {name}",
                    hi_hz=5_000.0)
        print(f"main path: AM {name} at bf16x3, {STEPS} steps, launches "
              f"{got}, tones recovered")
        buf = buffer(model, blocks[0])
        n0 = model.init()[0]
        if model.front == "pfb":
            args = (buf, model.poly_taps, model.dft_bank, model.num_taps,
                    model.lo_table, n0, model.decimation)
        else:
            args = (buf, model.tap_bank, model.lo_table, n0, model.decimation)
        step_ms, step_dev, idle = time_step(model, blocks[0])
        tf32_ms = cuda_ms(library(model, buf, tf32=True), reps=20)
        by_grade = {}
        for grade in GRADES:
            timing = time_kernel(kernel, plain, library(model, buf), args,
                                 precision=grade)
            flops, nbytes, tensor = am_bound(model, buf.re.shape[-1], grade)
            bnd = bound(flops, nbytes, tensor)
            by_grade[grade] = {
                "kernel_ms": timing[0], "kernel_device_us": timing[1],
                "plain_ms": timing[2], "library_ms": timing[3],
                "bound_us": bnd[0] * 1e3, "bound_by": bnd[1],
                "vs_plain_max_abs": errs[grade][0],
                "vs_f32_max_abs": errs[grade][1]}
            main = grade == "bf16x3"
            entries.append(kernel_entry(
                name, "gsdr_tpu_torch/kernels/csrc/am_chain.cu",
                "gsdr_tpu/kernels/fm_chain_pallas.py:551",
                got[name] if main else 0, errs[grade][0], timing, bnd,
                grade=grade, main_path=main, library_tf32_ms=tf32_ms))
        print(json.dumps({
            "phase": f"am_{name}", "step_ms": step_ms,
            "msps": N / (step_ms * 1e-3) / 1e6, "device_idle_share": idle,
            "device_us_per_step": step_dev, "by_grade": by_grade,
            "library": what, "library_tf32_ms": tf32_ms, "card": CARD}))
    return entries


def planar_err(got, want):
    """(max-abs error over both planes, max|want| over both planes)."""
    err = max(float((got.re - want.re).abs().max()),
              float((got.im - want.im).abs().max()))
    scale = max(float(want.re.abs().max()), float(want.im.abs().max()))
    return err, scale


def b4_bound(k, t, n, c, m, grade="f32"):
    """(FLOPs, bytes, tensor) of one channelizer call on an n-sample
    buffer: the cheapest known algorithm for channels on the Fs/K grid at
    D = K, the 4*T fold plus a K-point FFT (~5*K*log2 K) per frame; at a
    bf16 grade also the dense product on the tensor cores, its passes x
    8*C*T per frame; the buffer and the bank read, the (C, M) planes
    written."""
    flops = (4.0 * t + 5.0 * k * math.log2(k)) * m
    tensor = (PASSES[grade] * 8.0 * c * t * m, 0.0) if PASSES[grade] else None
    return flops, 4.0 * (2 * n + 2 * c * 2 * t + 2 * c * m), tensor


def b4_timing(what, buf, taps, k, grade):
    """Time B4 at a grade, its plain version at that grade, its library
    twin (F.conv1d of the bank, TF32 off; at a bf16 grade also TF32 on)
    and the fold path on one buffer; returns (timing, bound, line)."""
    bank = _analysis_tables(_taps_key(taps), k, buf.device)[0]
    timing = time_kernel(channelize_kernel, channelize_reference,
                         conv_library(buf, bank, k), (buf, bank, k),
                         precision=grade)
    tf32_ms = (cuda_ms(conv_library(buf, bank, k, tf32=True), reps=20)
               if PASSES[grade] else None)
    fold_ms = cuda_ms(lambda: pfb_channelize(buf, taps, k, impl="torch"),
                      reps=10)
    n, t = buf.re.shape[-1], bank.shape[-1]
    m = (n - t) // k + 1
    bnd = bound(*b4_bound(k, t, n, k, m, grade))
    line = {"phase": what, "grade": grade, "K": k, "T": t, "N": n, "M": m,
            "kernel_ms": timing[0], "kernel_device_us": timing[1],
            "plain_ms": timing[2], "library_ms": timing[3],
            "library": "F.conv1d of the (2K, 2, T) bank, TF32 off",
            "library_tf32_ms": tf32_ms, "fold_path_ms": fold_ms,
            "fold_path": "grouped F.conv1d fold + torch.matmul DFT, TF32 off",
            "bound_ms": bnd[0], "bound_by": bnd[1],
            "dense_gflop": 8.0 * k * t * m / 1e9,
            "tensor_gflop": PASSES[grade] * 8.0 * k * t * m / 1e9,
            "card": CARD}
    return timing, bnd, line, tf32_ms


def stitch(outs, q):
    """Per-block (K, M) outputs joined along time, the first Q-1 frames
    (the zero history's) dropped, as pfb_channelize_block's stream."""
    return ComplexArray(torch.cat([o.re for o in outs], -1)[..., q - 1:],
                        torch.cat([o.im for o in outs], -1)[..., q - 1:])


def transmux_phase():
    """Phase 7: the channelized QPSK link through B4 at bf16x3, the route's
    grade, then B4 at each grade on the same blocks; returns its entries,
    one per grade."""
    k, q = TMX_K, TMX_Q
    taps = lowpass64(q * k, 0.5 / k)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    syms = torch.randint(0, 4, (k, STEPS * TMX_FRAMES), generator=gen,
                         device="cuda", dtype=torch.int32)
    tx = qpsk_modulate_symbols(syms, 1.0)
    clean = transmit(tx, taps, k, STEPS)
    blocks = awgn(clean, TMX_SNR_DB, gen)
    check(all(tuple(b.shape) == (N,) for b in blocks), "wideband block shape")

    y, got = counted("pfb_channelize_block(impl='auto') at K=32",
                     lambda: receive(blocks, taps, k, impl="auto"),
                     {"channelize": STEPS})
    frames = STEPS * TMX_FRAMES - (q - 1)
    check(tuple(y.shape) == (k, frames), f"channel outputs {tuple(y.shape)}")
    check(bool(torch.isfinite(y.re).all() and torch.isfinite(y.im).all()),
          "non-finite channel outputs")
    ser, evm, n_sym = link_quality(y, tx, q)
    check(float(ser.max()) <= TMX_SER_MAX, f"transmux SER {ser.max():.3g}")
    check(float(evm.max()) < 0.3, f"transmux EVM {evm.max():.3f}")

    # the same blocks through the fold path, and the buffers B4 read (each
    # block behind the last (Q-1)*K samples before it) through its plain
    # version
    y_fold = receive(blocks, taps, k, impl="torch")
    hist = (q - 1) * k
    bank = _analysis_tables(_taps_key(taps), k, blocks[0].device)[0]
    bufs, prev = [], ComplexArray.zeros((hist,), device="cuda")
    for rf in blocks:
        bufs.append(ComplexArray(torch.cat([prev.re, rf.re]),
                                 torch.cat([prev.im, rf.im])))
        prev = rf[..., N - hist:]
    z, ref = equalize(y, tx, q)
    z_fold, _ = equalize(y_fold, tx, q)
    edge = torch.minimum(z_fold.real.abs(), z_fold.imag.abs())
    differ = decide(z) != decide(z_fold)
    check(bool((edge[differ] < TMX_TIE).all()),
          "B4 and the fold path decide apart away from a tie")
    err_fold_sym = int((decide(z_fold) != decide(ref)).sum())
    # the same symbols without noise, through B4 again (not the main path);
    # the worst decision margin of the cascade alone, in units of the
    # symbols' +-1 components
    y0 = receive(clean, taps, k, impl="auto")
    ser0, evm0, _ = link_quality(y0, tx, q)
    check(float(ser0.max()) == 0.0, f"noiseless transmux SER {ser0.max():.3g}")
    z0, ref0 = equalize(y0, tx, q)
    margin0 = float(torch.minimum(z0.real * ref0.real,
                                  z0.imag * ref0.imag).min())
    print(f"main path: transmux K={k}, {STEPS} blocks of {N} samples, "
          f"launches {got}; {TMX_SNR_DB} dB: {int(round(ser.sum() * n_sym / k))}"
          f" symbol errors in {n_sym} (fold path on the same blocks "
          f"{err_fold_sym}, decisions apart {int(differ.sum())}), SER max "
          f"{ser.max():.3g}, EVM mean {evm.mean():.4f} max {evm.max():.4f}; "
          f"noiseless: SER 0, EVM max {evm0.max():.4f}, worst decision "
          f"margin {margin0:.4f}")

    # B4 at each grade on the main path's buffers: the route's own launches
    # at bf16x3; no main path runs the others, so their calls of the wrapper
    # here are not counted and their entries say launches 0, main_path false
    tail = blocks[0][..., N - hist:]
    step_ms, step_dev, idle = time_calls(
        lambda: pfb_channelize_block(blocks[1], taps, k, tail=tail,
                                     impl="auto"))
    per_grade = {}
    for grade in GRADES:
        if grade == "bf16x3":
            y_g, launches = y, got["channelize"]
        else:
            before = channelize_kernel.launches
            y_g = stitch([channelize_kernel(b, bank, k, precision=grade)
                          for b in bufs], q)
            channelize_kernel.launches, launches = before, 0
        y_plain = stitch([channelize_reference(b, bank, k, grade)
                          for b in bufs], q)
        err, scale = planar_err(y_g, y_plain)
        err_fold, _ = planar_err(y_g, y_fold)
        check(err <= B4_REL_TOL * scale,
              f"B4 at {grade} vs plain: max-abs {err:.3g}, max|y| {scale:.3g}")
        check(err_fold <= B4_FOLD_TOL[grade] * scale,
              f"B4 at {grade} vs fold path: max-abs {err_fold:.3g}, max|y| "
              f"{scale:.3g}")
        print(f"channelize at {grade} (K={k}, T={q * k}, D={k}) vs its plain "
              f"version: max-abs {err:.3g} (tol {B4_REL_TOL} x max|y| = "
              f"{B4_REL_TOL * scale:.3g}); vs fold path {err_fold:.3g} (tol "
              f"{B4_FOLD_TOL[grade]} x max|y|); launches {launches}")
        timing, bnd, line, tf32_ms = b4_timing(f"transmux_b4_{grade}",
                                               bufs[0], taps, k, grade)
        line.update({"max_abs_err": err, "vs_fold_path": err_fold,
                     "launches": launches})
        if grade == "bf16x3":
            line.update({
                "metric": "transmux_32ch_receive_input_msps",
                "value": N / (step_ms * 1e-3) / 1e6, "unit": "Msamples/s",
                "step_ms": step_ms, "device_us_per_step": step_dev,
                "device_idle_share": idle, "ser_max": float(ser.max()),
                "symbol_errors": int(round(ser.sum() * n_sym / k)),
                "fold_path_symbol_errors": err_fold_sym,
                "evm_max": float(evm.max()),
                "noiseless_evm_max": float(evm0.max()),
                "noiseless_worst_margin": margin0})
        print(json.dumps(line))
        per_grade[grade] = (launches, err, timing, bnd, tf32_ms)

    # benchmarks/run_all.py bench_pfb: K=16, 128 taps, 2^20 samples, one shot
    # through 'auto' (bf16x3), then each grade
    k16 = 16
    taps16 = lowpass64(8 * k16, 0.4 / k16)
    x = ComplexArray(torch.randn(N, generator=gen, device="cuda"),
                     torch.randn(N, generator=gen, device="cuda"))
    bank16 = _analysis_tables(_taps_key(taps16), k16, x.device)[0]
    got16, _ = counted("pfb_channelize(impl='auto') at K=16",
                       lambda: pfb_channelize(x, taps16, k16),
                       {"channelize": 1})
    err16, scale16 = planar_err(
        got16, channelize_reference(x, bank16, k16, "bf16x3"))
    check(err16 <= B4_REL_TOL * scale16, f"B4 at K=16 vs plain: {err16:.3g}")
    for grade in GRADES:
        _, _, line16, _ = b4_timing(f"bench_pfb_b4_{grade}", x, taps16, k16,
                                    grade)
        if grade == "bf16x3":
            line16["max_abs_err"] = err16
        print(json.dumps(line16))
    entries = []
    for grade, (launches, err, timing, bnd, tf32_ms) in per_grade.items():
        entries.append(kernel_entry(
            "channelize", "gsdr_tpu_torch/kernels/csrc/channelize.cu",
            "gsdr_tpu/kernels/channelize_pallas.py:57", launches,
            max(err, err16) if grade == "bf16x3" else err, timing, bnd,
            grade=grade, library_tf32_ms=tf32_ms,
            main_path=grade == "bf16x3"))
    return entries


def nearest64(x, table):
    """Float64 nearest neighbour on the host: (index of the first minimum,
    its squared distance, the squared distance of every table point)
    for planar x (n,) on the card, in chunks."""
    xr = x.re.double().cpu().numpy()
    xi = x.im.double().cpu().numpy()
    cr = table.re.double().cpu().numpy()
    ci = table.im.double().cpu().numpy()
    idx = np.empty(xr.shape[0], np.int64)
    best = np.empty(xr.shape[0])
    for s in range(0, xr.shape[0], 1 << 16):
        d2 = ((xr[s:s + (1 << 16), None] - cr) ** 2
              + (xi[s:s + (1 << 16), None] - ci) ** 2)
        idx[s:s + (1 << 16)] = np.argmin(d2, axis=1)
        best[s:s + (1 << 16)] = np.min(d2, axis=1)
    return idx, best, (xr, xi, cr, ci)


def d64(pts, choice):
    """Float64 squared distance of each sample to its chosen point."""
    xr, xi, cr, ci = pts
    return (xr - cr[choice]) ** 2 + (xi - ci[choice]) ** 2


def qpsk256_phase():
    """Phase 8: the table-exact QPSK256 receiver through B6; returns its
    entry."""
    modem = Qpsk256Modem(CIRCULAR, 1.0, exact_tables=True, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    syms = torch.randint(0, 256, (STEPS, Q256_N), generator=gen,
                         device="cuda", dtype=torch.int32)
    rx_in = []
    for i in range(STEPS):
        x = modem.tx(syms[i])
        noise = Q256_SIGMA * torch.randn((2, Q256_N), generator=gen,
                                         device="cuda")
        rx_in.append(ComplexArray(x.re + noise[0], x.im + noise[1]))
    outs, got = counted("Qpsk256Modem(CIRCULAR, exact_tables=True).rx",
                        lambda: [modem.rx(x) for x in rx_in],
                        {"qpsk256": STEPS})
    grid, blob = table_grid(modem.table)
    ties_plain = ties_ref = outside = 0
    max_abs = tie_gap = 0.0
    for x, out in zip(rx_in, outs):
        check(out.dtype == torch.uint8 and tuple(out.shape) == (Q256_N,),
              f"decisions {out.dtype} {tuple(out.shape)}")
        outside += int((grid.cells(x.re, x.im) < 0).sum())
        k_idx = out.long().cpu().numpy()
        p_idx = qpsk256_reference(x, modem.table).long().cpu().numpy()
        nn, best, pts = nearest64(x, modem.table)
        dk, dp = d64(pts, k_idx), d64(pts, p_idx)
        # decisions that differ must be exact ties of the two points
        diff = k_idx != p_idx
        check(bool(np.all(np.abs(dk - dp)[diff] <= Q256_TIE)),
              "B6 and its plain version disagree away from a tie")
        off = k_idx != nn
        check(bool(np.all((dk - best)[off] <= Q256_TIE)),
              "B6 disagrees with the float64 nearest neighbour off a tie")
        ties_plain += int(diff.sum())
        ties_ref += int(off.sum())
        if off.any():
            tie_gap = max(tie_gap, float(np.max((dk - best)[off])))
        max_abs = max(max_abs, float(np.max(np.abs(np.sqrt(dk)
                                                   - np.sqrt(dp)))))
    ser = float(np.mean(torch.stack(outs).long().cpu().numpy()
                        != syms.long().cpu().numpy()))
    print(f"main path: Qpsk256Modem(CIRCULAR, exact_tables=True), {STEPS} "
          f"blocks of {Q256_N} symbols at sigma {Q256_SIGMA}, launches {got}; "
          f"decisions differing from the plain version {ties_plain}, from the "
          f"float64 nearest neighbour {ties_ref}, all ties within {Q256_TIE} "
          f"(largest {tie_gap:.3g}); outside the candidate grid's box "
          f"{outside} of {STEPS * Q256_N}; symbol error rate {ser:.4g}")
    for ctype in (RECTANGULAR, CIRCULAR):
        m = Qpsk256Modem(ctype, 1.0, exact_tables=True, device="cuda")
        s = torch.arange(256, device="cuda", dtype=torch.int32)
        check(torch.equal(m.rx(m.tx(s), out_dtype=torch.int32), s),
              f"ideal loopback, geometry {ctype}")

    x0 = rx_in[0]
    ct, c2 = score_table(modem.table)
    xf = torch.stack([x0.re, x0.im], dim=-1)

    def library():
        with full_f32():
            torch.argmin(c2 - 2 * (xf @ ct), -1)

    def plain_u8(x, table, out_dtype):
        return qpsk256_reference(x, table).to(out_dtype)

    timing = time_kernel(qpsk256_kernel, plain_u8, library, (x0, modem.table),
                         out_dtype=torch.uint8)
    launches = grid_launches(lambda: qpsk256_kernel(x0, modem.table,
                                                    out_dtype=torch.uint8))
    check(launches[0] == 1, f"B6: {launches[1]} device kernels, want one "
          "a call")
    # the least over the known algorithms: the candidate search scores what
    # this block's samples need (4 FLOP a score: its cell's list in the
    # box, all 256 points outside it) and is bound by its bytes, x read
    # (8 B a sample), the table and the grid read once, uint8 out (1 B);
    # the exhaustive search, 4 FLOP for each of 256 points, beside it
    cells = grid.cells(x0.re, x0.im)
    lens = torch.as_tensor(np.diff(grid.offsets), device="cuda")
    scores = float(torch.where(cells >= 0, lens[cells.clamp(min=0)],
                               256).sum())
    nbytes = 9.0 * Q256_N + 8 * 256 + blob.numel()
    bnd = bound(4.0 * scores, nbytes)
    exhaustive = bound(4.0 * 256 * Q256_N, 12.0 * Q256_N + 8 * 256)
    step_ms, step_dev, idle = time_calls(lambda: modem.rx(x0))
    print(json.dumps({
        "metric": "qpsk256_exact_rx_msym_per_s",
        "value": Q256_N / (step_ms * 1e-3) / 1e6, "unit": "Msym/s",
        "step_ms": step_ms, "device_us_per_step": step_dev,
        "device_idle_share": idle, "kernel_ms": timing[0],
        "kernel_device_us": timing[1], "grid_launches_per_call": launches[0],
        "profiler_kernel_records": launches[1],
        "plain_ms": timing[2], "library_ms": timing[3],
        "library": "torch.argmin(c2 - 2 * (x @ ct), -1), TF32 off",
        "bound_ms": bnd[0], "bound_by": bnd[1],
        "exhaustive_bound_ms": exhaustive[0],
        "exhaustive_bound_by": exhaustive[1], "grid": grid.g,
        "scores_per_sample": scores / Q256_N, "outside_box": outside,
        "ties_vs_plain": ties_plain, "ties_vs_float64": ties_ref,
        "largest_tie_gap": tie_gap, "card": CARD}))
    return kernel_entry(
        "qpsk256", "gsdr_tpu_torch/kernels/csrc/qpsk256.cu",
        "gsdr_tpu/kernels/qpsk256_pallas.py:46", got["qpsk256"], max_abs,
        timing, bnd)


def butter2(fc):
    """A second-order Butterworth low-pass at fc (cycles per sample)."""
    c = 1.0 / math.tan(math.pi * fc)
    a0 = c * c + math.sqrt(2.0) * c + 1.0
    return ((1.0 / a0, 2.0 / a0, 1.0 / a0),
            (1.0, 2.0 * (1.0 - c * c) / a0, (c * c - math.sqrt(2.0) * c + 1.0) / a0))


def cascade(*fcs):
    """The monolithic (b, a) of Butterworth biquads in series."""
    b, a = np.array([1.0]), np.array([1.0])
    for fc in fcs:
        bb, aa = butter2(fc)
        b, a = np.convolve(b, bb), np.convolve(a, aa)
    return tuple(b.tolist()), tuple(a.tolist())


# the iir_standalone filters: bench_iir's biquad (benchmarks/run_all.py),
# hw_parity.py's order 4, an order-8 filter with four distinct complex
# pole pairs (the kernel's limit), and bench_iir's biquad on a planar
# complex signal
IIR_FILTERS = (
    ("biquad", (0.0675, 0.135, 0.0675), (1.0, -1.143, 0.413), False),
    ("order4", (0.05, 0.1, 0.12, 0.1, 0.05),
     (1.0, -1.2, 0.9, -0.33, 0.06), False),
    ("order8", *cascade(0.06, 0.14, 0.24, 0.36), False),
    ("biquad_planar", (0.0675, 0.135, 0.0675), (1.0, -1.143, 0.413), True),
)
# a critically damped biquad: a double real pole at 0.5
DOUBLE_POLE = ((0.25, 0.5, 0.25), (1.0, -1.0, 0.25))
# B5 vs the plain blocked scan and vs scipy's float64 lfilter: float32
# scans in other orders, max-abs error over max|y| (hw_parity.py's gate)
IIR_REL_TOL = 1e-5
IIR_LIBRARY = ("none: no single torch call computes a recursive filter "
               "(torchaudio's lfilter is not installed)")


def iir_bound(rows, n, filt):
    """(FLOPs, bytes) of one B5 call: per sample b0*x (2), and per pole
    pair the complex update (10) and its output term (4), per real pole 3
    and 2; x read and y written once per row, the table read once."""
    pairs = sum(1 for p in filt.diag.poles if p.imag != 0.0)
    real = len(filt.diag.poles) - pairs
    flops = rows * n * (2.0 + 14.0 * pairs + 5.0 * real)
    return flops, 4.0 * (2 * rows * n + filt.table.numel())


def scipy_stream(b, a, blocks, zi=None):
    """scipy.signal.lfilter in float64 on the host over the blocks, the
    state carried from zi (default zero): the concatenated output and the
    final TDF-II state."""
    import scipy.signal as ss

    x = torch.cat(blocks).double().cpu().numpy()
    zi = np.zeros(len(b) - 1) if zi is None else zi.double().cpu().numpy()
    y, zf = ss.lfilter(np.float64(np.float32(b)), np.float64(np.float32(a)),
                       x, zi=zi)
    return y, zf


def iir_standalone_phase():
    """Phase 9: B5 through IirStream at bench_iir's size, 8 blocks of 2^20
    samples per filter, against the plain blocked scan and scipy float64;
    then the double-pole routing. Returns (launches, worst max-abs error,
    per-filter timing lines)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)
    launches, worst, lines = 0, 0.0, {}
    for name, b, a, planar in IIR_FILTERS:
        rows = 2 if planar else 1
        planes = [[torch.randn(N, generator=gen, device="cuda")
                   for _ in range(rows)] for _ in range(STEPS)]
        blocks = [ComplexArray(*p) if planar else p[0] for p in planes]
        kern, plain = IirStream(b, a), IirStream(b, a, impl="torch")

        def run(op):
            st, outs = op.init(blocks[0]), []
            for x in blocks:
                st, y = op.step(st, x)
                outs.append(y)
            return outs, st

        (outs, st), got = counted(f"IirStream({name})", lambda: run(kern),
                                  {"iir": STEPS})
        launches += got["iir"]
        outs_p, st_p = run(plain)
        split = (lambda v: [v.re, v.im]) if planar else (lambda v: [v])
        err = ref_err = max_abs = 0.0
        for r in range(rows):
            y = torch.cat([split(o)[r] for o in outs])
            yp = torch.cat([split(o)[r] for o in outs_p])
            check(bool(torch.isfinite(y).all()), f"{name}: non-finite y")
            scale = float(yp.abs().max())
            zf, zfp = split(st)[r], split(st_p)[r]
            d = max(float((y - yp).abs().max()),
                    float((zf - zfp).abs().max()))
            max_abs = max(max_abs, d)
            err = max(err, d / scale)
            y64, zf64 = scipy_stream(b, a, [p[r] for p in planes])
            ref_err = max(ref_err,
                          float(np.abs(y.double().cpu().numpy() - y64).max())
                          / scale,
                          float(np.abs(zf.double().cpu().numpy() - zf64).max())
                          / scale)
        check(err <= IIR_REL_TOL, f"B5 {name} vs plain: rel {err:.3g}")
        check(ref_err <= IIR_REL_TOL, f"B5 {name} vs float64: rel "
              f"{ref_err:.3g}")
        worst = max(worst, max_abs)

        # one call at 2^20 samples per row, the state of the stream as zi
        filt = iir_filter(b, a, blocks[0].device)
        args = (blocks[0], filt, st)
        before = iir_kernel.launches
        k_ms = cuda_ms(lambda: iir_kernel(*args), reps=50)
        k_dev = device_us(lambda: iir_kernel(*args), reps=20)
        per_call = grid_launches(lambda: iir_kernel(*args))
        check(per_call[0] == 1, f"B5 {name}: {per_call[1]} device kernels, "
              "want one a call")
        iir_kernel.launches = before
        p_ms = cuda_ms(lambda: plain.step(st, blocks[0]), reps=2, bursts=3)
        bnd = bound(*iir_bound(rows, N, filt))
        lines[name] = {
            "phase": f"iir_standalone_{name}", "rows": rows, "n": N,
            "order": len(b) - 1, "poles": len(filt.diag.poles),
            "launches": got["iir"], "max_abs_err": max_abs,
            "vs_plain_rel": err, "vs_float64_rel": ref_err,
            "kernel_ms": k_ms, "kernel_device_us": k_dev,
            "grid_launches_per_call": per_call[0],
            "profiler_kernel_records": per_call[1], "plain_ms": p_ms,
            "library_ms": None, "library": IIR_LIBRARY, "bound_ms": bnd[0],
            "bound_by": bnd[1], "card": CARD}
        print(json.dumps(lines[name]))

    # stream_fm's IIR blocks: 2^18 samples, where most of B5's main-path
    # launches run; one call each from a nonzero state (uncounted)
    (b_de, a_de), sos = stream_fm_iir()
    for name, b, a in (("deemph", b_de, a_de),
                       ("sos0", tuple(sos[0, :3].tolist()),
                        tuple(sos[0, 3:].tolist()))):
        x = torch.randn(N // 4, generator=gen, device="cuda")
        zi = torch.randn(len(b) - 1, generator=gen, device="cuda")
        filt = iir_filter(b, a, x.device)
        before = iir_kernel.launches
        y, zf = iir_kernel(x, filt, zi)
        yp, zp = iir_block(b, a, x, zi=zi, impl="torch")
        y64, z64 = scipy_stream(b, a, [x], zi)
        scale = float(yp.abs().max())
        err = max(float((y - yp).abs().max()),
                  float((zf - zp).abs().max())) / scale
        ref_err = max(float(np.abs(y.double().cpu().numpy() - y64).max()),
                      float(np.abs(zf.double().cpu().numpy() - z64).max())
                      ) / scale
        check(err <= IIR_REL_TOL, f"B5 {name} vs plain: rel {err:.3g}")
        check(ref_err <= IIR_REL_TOL, f"B5 {name} vs float64: rel "
              f"{ref_err:.3g}")
        k_ms = cuda_ms(lambda: iir_kernel(x, filt, zi), reps=50)
        k_dev = device_us(lambda: iir_kernel(x, filt, zi), reps=20)
        per_call = grid_launches(lambda: iir_kernel(x, filt, zi))
        check(per_call[0] == 1, f"B5 {name}: {per_call[1]} device kernels, "
              "want one a call")
        iir_kernel.launches = before
        p_ms = cuda_ms(lambda: iir_block(b, a, x, zi=zi, impl="torch"),
                       reps=2, bursts=3)
        bnd = bound(*iir_bound(1, N // 4, filt))
        print(json.dumps({
            "phase": f"iir_stream_fm_{name}", "rows": 1, "n": N // 4,
            "order": len(b) - 1, "poles": len(filt.diag.poles),
            "vs_plain_rel": err, "vs_float64_rel": ref_err,
            "kernel_ms": k_ms, "kernel_device_us": k_dev,
            "grid_launches_per_call": per_call[0],
            "profiler_kernel_records": per_call[1], "plain_ms": p_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "card": CARD}))

    # the double real pole: 'auto' takes the plain scan, 'cuda' raises
    x = torch.randn(N, generator=gen, device="cuda")
    b, a = DOUBLE_POLE
    check(iir_filter(b, a, x.device) is None, "double pole: B5 must refuse")
    (y, _), _ = counted("iir_block(double pole, 'auto')",
                        lambda: iir_block(b, a, x), {})
    y_plain, _ = iir_block(b, a, x, impl="torch")
    check(torch.equal(y, y_plain), "double pole: 'auto' is not the plain scan")
    try:
        iir_block(b, a, x, impl="cuda")
    except ValueError:
        pass
    else:
        check(False, "double pole: impl='cuda' did not raise")
    print(f"main path: iir_standalone, {len(IIR_FILTERS)} filters x {STEPS} "
          f"blocks of {N} samples, iir launches {launches}, worst B5 vs "
          f"plain {worst:.3g} (tol {IIR_REL_TOL}); double pole: 'auto' "
          "plain, 'cuda' raises, no launch")
    return launches, worst, lines


def stream_fm_iir():
    """stream_fm's IIR stages at its 250-kHz audio rate: the 75-us
    de-emphasis (b, a) and the order-8 Butterworth audio low-pass at 15 kHz
    as second-order sections."""
    import scipy.signal as ss

    rate = FS / 4
    return (fm_deemphasis_coeffs(75e-6, rate),
            ss.butter(8, 15e3, fs=rate, output="sos"))


def stream_fm_chain(iir_impl):
    """The single-station FM receiver as a streaming Chain: shift the
    station at +100 kHz to DC, the flagship's 64-tap low-pass with D=4,
    the discriminator at 75 kHz deviation, and stream_fm_iir's two IIR
    stages with impl=iir_impl."""
    audio_rate = FS / 4
    (b, a), sos = stream_fm_iir()
    return Chain((
        MixerStream(freq_shift_hz=-100_000.0, sample_rate=FS),
        FirStream(taps=lowpass(64, 0.03), decimation=4),
        QuadFmStream(gain=audio_rate / (2 * math.pi * 75_000.0)),
        IirStream(b, a, impl=iir_impl),
        SosStream(tuple(tuple(r) for r in sos.tolist()), impl=iir_impl),
    ))


def stream_fm_phase():
    """Phase 10: the streaming FM receiver, 8 steps of 2^20 samples,
    counted (every IIR stage on B5: 1 + 4 launches a step), against the
    same chain with plain IIR stages; tone, step time and idle share.
    Returns (launches, audio max-abs difference)."""
    t = _time_axis(0, STEPS * N)
    ph = (2 * np.pi * 100_000.0 * t
          + (75_000.0 / 1_000.0) * torch.sin(2 * np.pi * 1_000.0 * t))
    rf = ComplexArray(torch.cos(ph).float(), torch.sin(ph).float())
    blocks = [rf[i * N:(i + 1) * N] for i in range(STEPS)]
    chain, plain = stream_fm_chain("auto"), stream_fm_chain("torch")
    st0 = chain.init(blocks[0])
    (st, outs), got = counted("stream_fm Chain.step",
                              lambda: run_stream(chain, st0, blocks),
                              {"iir": 5 * STEPS})
    st_p, outs_p = run_stream(plain, plain.init(blocks[0]), blocks)
    audio, audio_p = torch.cat(outs), torch.cat(outs_p)
    check(tuple(audio.shape) == (STEPS * N // 4,), f"audio {audio.shape}")
    check(bool(torch.isfinite(audio).all()), "non-finite audio")
    max_abs = float((audio - audio_p)[SKIP:].abs().max())
    err = max_abs / float(audio_p[SKIP:].abs().max())
    check(err <= AUDIO_REL_TOL, f"stream_fm audio vs plain IIR: {err:.3g}")
    zerr = max(float((st[3] - st_p[3]).abs().max()),
               float((st[4] - st_p[4]).abs().max()))
    check(zerr <= CARRY_ATOL, f"stream_fm IIR states differ by {zerr:.3g}")
    check_tones(audio[None, -N // 4:], FS / 4, lambda k: 1_000.0,
                "stream_fm")

    def one_step():
        nonlocal st
        st, _ = chain.step(st, blocks[0])

    step_ms, step_dev, idle = time_calls(one_step)
    print(f"main path: stream_fm, {STEPS} steps of {N} samples, launches "
          f"{got}; audio vs plain IIR stages {err:.3g} of max|audio| (tol "
          f"{AUDIO_REL_TOL}), IIR states {zerr:.3g}; 1-kHz tone recovered")
    print(json.dumps({
        "metric": "stream_fm_input_msps", "unit": "Msamples/s",
        "value": N / (step_ms * 1e-3) / 1e6, "step_ms": step_ms,
        "device_us_per_step": step_dev, "device_idle_share": idle,
        "iir_launches_per_step": got["iir"] / STEPS, "audio_vs_plain_rel": err,
        "card": CARD}))
    return got["iir"], max_abs


def iir_entry(launches, max_abs, lines):
    """The kernels-line entry of B5: its launches on both main paths, the
    worst max-abs error against the plain scan, times at bench_iir's
    biquad."""
    line = lines["biquad"]
    return {"name": "iir", "grade": "f32", "main_path": True, "route": "cuda",
            "source": "gsdr_tpu_torch/kernels/csrc/iir.cu",
            "replaces": "gsdr_tpu/kernels/iir_pallas.py:154",
            "launches": launches, "max_abs_err": max_abs,
            "ms": line["kernel_ms"], "plain_ms": line["plain_ms"],
            "bound_ms": line["bound_ms"], "bound_by": line["bound_by"],
            "library_ms": None}


# ---------------------------------------------------------------------------
# 12-14) the single-channel ops, the fm_rx command line and the examples
# ---------------------------------------------------------------------------

# The verify recipe's FM signal: one carrier at +100 kHz, a 1-kHz tone at
# 5-kHz deviation, a 65-tap low-pass, D = 4, 2^20 samples at 1 MHz.
OPS_FC, OPS_TONE, OPS_DEV, OPS_D = 100_000.0, 1_000.0, 5_000.0, 4
OPS_TAPS = lowpass(65, 0.02)
# B1 routes each output through the float32 digit-table phase, exact to
# PHASE_BOUND cycles (utils/phase.py); the composed chain mixes by its own
# float32 phase, so a discriminator output of the two routes may differ by
# gain*2*pi*2*PHASE_BOUND, 0.024 at this gain of 31.8: the kernel is held
# to its plain version (the same phase) at AUDIO_REL_TOL and to the
# composed chain at that bound.
PHASE_BOUND = 6e-5
RESAMPLE_REL_TOL = 1e-6
# fm_rx on an RTL-SDR capture: 2^24 int8 samples at 2.048 MHz, five FM
# stations at 75-kHz deviation
RX_FS, RX_N, RX_BLOCK = 2_048_000.0, 1 << 24, 1 << 20
RX_STATIONS = (-800e3, -400e3, 0.0, 400e3, 800e3)
RX_TONES = (500.0, 1100.0, 1700.0, 2300.0, 2900.0)


def single_channel_model(cls, taps, decimation, **kw):
    """A one-channel receiver on the single-channel op's bank (its
    tap_bank is the op's): the stand-in whose shapes fm_bound and am_bound
    read."""
    return cls(sample_rate=FS, tuning_frequency=0.0,
               channel_frequencies=(OPS_FC,), decimation=decimation,
               low_pass_taps=taps, device="cuda", **kw)


def ops_timing(kernel, plain, args, model, nb, bound_fn, grade):
    """Kernel ms, device us, plain ms and library ms (F.conv1d of the bank,
    the front alone) of one call at ``args``, and its bound."""
    timing = time_kernel(kernel, plain,
                         conv_library(args[0], args[1], args[4]), args,
                         precision=grade)
    flops, nbytes, tensor = bound_fn(model, nb, grade)
    return timing, bound(flops, nbytes, tensor), nbytes


def ops_phase():
    """Phase 12: fm_demod and am_demod through 'auto' (one B1 and one
    B3-dense launch at C = 1, counted), each grade against the kernel's
    plain version, the f32 plain chain and the composed chain, the tone;
    ResampleStream over four uneven blocks against one-shot resample."""
    t = _time_axis(0, N)
    ph = (2 * np.pi * OPS_FC * t
          + (OPS_DEV / OPS_TONE) * torch.sin(2 * np.pi * OPS_TONE * t))
    x = ComplexArray(torch.cos(ph).float(), torch.sin(ph).float())
    gain = fm_demod_gain(FS, OPS_DEV)
    demod = (x, OPS_TAPS, FS, 0.0, OPS_FC, OPS_DEV, OPS_D)
    audio, got = counted("fm_demod(impl='auto')",
                         lambda: fm_demod(*demod), {"fm_chain": 1})
    m = (N - len(OPS_TAPS)) // OPS_D
    check(tuple(audio.shape) == (m,), f"fm_demod audio {tuple(audio.shape)}")
    check(bool(torch.isfinite(audio).all()), "fm_demod: non-finite audio")
    args = fm_chain_args(x, OPS_TAPS, FS, -OPS_FC, gain, OPS_D)
    f32 = fm_chain_reference(*args, precision="f32")[0][0, 1:]
    chain = fm_demod(*demod, impl="torch")
    scale = float(f32[SKIP:].abs().max())
    errs = {}
    for grade in GRADES:
        y = audio if grade == "bf16x3" else fm_demod(*demod, precision=grade)
        plain = fm_chain_reference(*args, precision=grade)[0][0, 1:]
        e_plain = float((y - plain)[SKIP:].abs().max()) / scale
        e_f32 = float((y - f32)[SKIP:].abs().max()) / scale
        e_chain = float((y - chain)[SKIP:].abs().max())
        chain_tol = (FM_GRADE_TOL[grade] * scale
                     + gain * 2 * np.pi * 2 * PHASE_BOUND)
        check(e_plain <= AUDIO_REL_TOL, f"fm_demod at {grade} vs its plain "
              f"version: {e_plain:.3g} of max|audio|")
        check(e_f32 <= FM_GRADE_TOL[grade], f"fm_demod at {grade} vs the "
              f"f32 plain chain: {e_f32:.3g}")
        check(e_chain <= chain_tol, f"fm_demod at {grade} vs impl='torch': "
              f"max-abs {e_chain:.3g} > {chain_tol:.3g}")
        errs[grade] = {"vs_plain_rel": e_plain, "vs_f32_rel": e_f32,
                       "vs_torch_abs": e_chain, "vs_torch_tol": chain_tol}
    check_tones(audio[None, SKIP:], FS / OPS_D, lambda k: OPS_TONE,
                "fm_demod", hi_hz=5_000.0)
    std = float(audio[SKIP:].double().std())
    check(abs(std - OPS_D / math.sqrt(2)) < 0.1, f"fm_demod std {std:.4f}")

    fm_model = single_channel_model(FmChannelizer, OPS_TAPS, OPS_D,
                                    frequency_deviation=OPS_DEV)
    fm_t, fm_b, fm_bytes = ops_timing(fm_chain, fm_chain_reference, args,
                                      fm_model, N, fm_bound, "bf16x3")
    print(f"main path: fm_demod(impl='auto'), {N} samples, launches "
          f"{got['fm_chain']} (B1 at C=1, T={len(OPS_TAPS)}, D={OPS_D}); "
          f"1-kHz tone, std {std:.4f} (want {OPS_D / math.sqrt(2):.4f})")
    print(json.dumps({
        "phase": "ops_fm_demod", "launches": got, "errors": errs,
        "kernel_ms": fm_t[0], "kernel_device_us": fm_t[1],
        "plain_ms": fm_t[2], "library_ms": fm_t[3],
        "bound_us": fm_b[0] * 1e3, "bound_by": fm_b[1],
        "mbytes": fm_bytes / 1e6, "card": CARD}))

    # AM: a 1-kHz tone, 60% modulated, on the same carrier
    env = 0.5 * (1.0 + 0.6 * torch.cos(2 * np.pi * OPS_TONE * t))
    ph = 2 * np.pi * OPS_FC * t
    xa = ComplexArray((env * torch.cos(ph)).float(),
                      (env * torch.sin(ph)).float())
    am_taps = lowpass(33, 0.05)
    am = (xa, am_taps, FS, 0.0, OPS_FC, OPS_D)
    env_out, got_am = counted("am_demod(impl='auto')",
                              lambda: am_demod(*am), {"am_chain": 1})
    am_args = am_chain_args(xa, am_taps, FS, -OPS_FC, OPS_D)
    am_err = {}
    for grade in GRADES:
        y = env_out if grade == "bf16x3" else am_demod(*am, precision=grade)
        d = float((y - am_chain_reference(*am_args, precision=grade)[0])
                  .abs().max())
        check(d <= ENV_ATOL, f"am_demod at {grade} vs its plain version: {d:.3g}")
        am_err[grade] = d
    check_tones(env_out[None, SKIP:], FS / OPS_D, lambda k: OPS_TONE,
                "am_demod", hi_hz=5_000.0)
    am_model = single_channel_model(AmReceiver, am_taps, OPS_D)
    am_t, am_b, am_bytes = ops_timing(am_chain, am_chain_reference, am_args,
                                      am_model, N, am_bound, "bf16x3")
    print(f"main path: am_demod(impl='auto'), {N} samples, launches "
          f"{got_am['am_chain']} (B3-dense at C=1), envelopes within "
          f"{max(am_err.values()):.3g} of the plain version (tol {ENV_ATOL})")
    print(json.dumps({
        "phase": "ops_am_demod", "launches": got_am, "max_abs_err": am_err,
        "kernel_ms": am_t[0], "kernel_device_us": am_t[1],
        "plain_ms": am_t[2], "library_ms": am_t[3],
        "bound_us": am_b[0] * 1e3, "bound_by": am_b[1],
        "mbytes": am_bytes / 1e6, "card": CARD}))

    # ResampleStream: the FM audio at 250 kHz to 48 kHz (L/M = 24/125)
    once = resample(audio, 24, 125)
    rs = ResampleStream(24, 125)
    st, outs = rs.init(audio), []
    for a, b in zip((0, 1, 777, 100_000), (1, 777, 100_000, m)):
        st, y = rs.step(st, audio[a:b])
        outs.append(y)
    joined = torch.cat(outs)[:once.shape[-1]]
    rerr = float((joined - once).abs().max() / once.abs().max())
    check(joined.shape == once.shape and rerr <= RESAMPLE_REL_TOL,
          f"ResampleStream vs resample: {rerr:.3g}")
    print(f"ResampleStream in 4 uneven blocks vs one-shot resample (24/125, "
          f"{once.shape[-1]} outputs): rel {rerr:.3g} (tol "
          f"{RESAMPLE_REL_TOL})")


def rx_capture(path):
    """The fm_rx phase's int8 capture, made on the card in float64 chunks
    and scaled to fit int8."""
    amp = 0.99 / len(RX_STATIONS)
    chunk = 1 << 22
    with open(path, "wb") as f:
        for start in range(0, RX_N, chunk):
            t = torch.arange(start, start + chunk, dtype=torch.float64,
                             device="cuda") / RX_FS
            re = torch.zeros(chunk, dtype=torch.float64, device="cuda")
            im = torch.zeros_like(re)
            for fc, tone in zip(RX_STATIONS, RX_TONES):
                ph = (2 * np.pi * fc * t + (75_000.0 / tone)
                      * torch.sin(2 * np.pi * tone * t))
                re += amp * torch.cos(ph)
                im += amp * torch.sin(ph)
            iq = torch.stack([re, im], dim=-1).reshape(-1) * 127.0
            f.write(torch.clamp(torch.round(iq), -127, 127).to(torch.int8)
                    .cpu().numpy().tobytes())


def rx_args(src, out, *extra):
    # --channels=...: a list that starts with '-' is no option
    return [str(src), "-o", str(out), "--fs", str(RX_FS),
            "--channels=" + ",".join(str(f) for f in RX_STATIONS),
            "--block", str(RX_BLOCK), *extra]


def read_audio(path, channels):
    return torch.from_numpy(np.fromfile(path, np.float32)
                            .reshape(-1, channels).T.copy())


def fm_rx_phase(tmp):
    """Phase 13: the fm_rx command line at its defaults (129 taps, D = 8,
    bf16x3) over a 2^24-sample capture in blocks of 2^20, in this process:
    16 B1 launches and nothing else, audio against FmChannelizer
    impl='torch' over the same staged blocks, the tones, the resume from a
    checkpoint bit-equal, the 48-kHz resampler's tones, the native host
    library, and the step time and idle share of one profiled run."""
    cap = tmp / "capture.iq"
    rx_capture(cap)
    c = len(RX_STATIONS)
    t0 = time.perf_counter()
    _, got = counted("fm_rx", lambda: fm_rx.main(rx_args(cap, tmp / "a.f32")),
                     {"fm_chain": RX_N // RX_BLOCK})
    wall = time.perf_counter() - t0
    check(native_available() and RingBuffer(16).native,
          "fm_rx: the native host library is not in use")
    audio = read_audio(tmp / "a.f32", c)
    rate = RX_FS / 8
    check(tuple(audio.shape) == (c, RX_N // 8), f"fm_rx audio {audio.shape}")
    check(bool(torch.isfinite(audio).all()), "fm_rx: non-finite audio")
    check_tones(audio[:, SKIP:].cuda(), rate, lambda k: RX_TONES[k], "fm_rx",
                hi_hz=5_000.0)

    # the plain chain on the same staged blocks
    plain = FmChannelizer(
        sample_rate=RX_FS, tuning_frequency=0.0,
        channel_frequencies=RX_STATIONS, frequency_deviation=75_000.0,
        decimation=8, low_pass_taps=fm_rx.design_lowpass(129, 0.05),
        impl="torch", device="cuda")
    raw = np.fromfile(cap, np.int8)
    st, outs = plain.init(), []
    for b in range(RX_N // RX_BLOCK):
        re, im = int8_iq_to_planar(raw[2 * b * RX_BLOCK:
                                       2 * (b + 1) * RX_BLOCK])
        st, y = plain.step(st, ComplexArray(torch.from_numpy(re).cuda(),
                                            torch.from_numpy(im).cuda()))
        outs.append(y.cpu())
    want = torch.cat(outs, dim=-1)
    err = rel_err(audio, want, SKIP)
    check(err <= AUDIO_REL_TOL, f"fm_rx vs impl='torch': {err:.3g}")

    # resume: the halves, the state saved and loaded, bit-equal
    half = raw.size // 2
    raw[:half].tofile(tmp / "h1.iq")
    raw[half:].tofile(tmp / "h2.iq")
    state = str(tmp / "state.npz")
    fm_rx.main(rx_args(tmp / "h1.iq", tmp / "b1.f32", "--save-state", state))
    fm_rx.main(rx_args(tmp / "h2.iq", tmp / "b2.f32", "--load-state", state))
    joined = np.concatenate([np.fromfile(tmp / "b1.f32", np.float32),
                             np.fromfile(tmp / "b2.f32", np.float32)])
    whole = np.fromfile(tmp / "a.f32", np.float32)
    check(joined.shape == whole.shape and np.array_equal(joined, whole),
          "fm_rx resume is not bit-equal to the whole run "
          f"({int(np.sum(joined != whole))} samples differ)")

    # 48-kHz audio through the resampler (L/M = 3/16)
    fm_rx.main(rx_args(cap, tmp / "r.f32", "--audio-rate", "48000"))
    a48 = read_audio(tmp / "r.f32", c)[:, SKIP:].double()
    spec = torch.fft.rfft((a48 - a48.mean(-1, keepdim=True))
                          * torch.hann_window(a48.shape[-1],
                                              dtype=torch.float64)).abs()
    bin_hz = 48_000.0 / a48.shape[-1]
    peaks = [float((spec[k, 5:].argmax() + 5) * bin_hz) for k in range(c)]
    for k, tone in enumerate(RX_TONES):
        check(abs(peaks[k] - tone) < 40.0,
              f"fm_rx 48 kHz: station {k} tone at {peaks[k]:.1f} Hz")

    # the step time and the device's idle share, from one run under
    # torch.profiler (tools/probe_grades.py fm_rx times a warm run without
    # it and breaks its host time down by function)
    from torch.profiler import ProfilerActivity, profile

    before = counts()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fm_rx.main(rx_args(cap, tmp / "p.f32"))
        torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t0
    for name, k in COUNTERS.items():
        k.launches = before[name]
    dev_s = sum(e.self_device_time_total for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")) * 1e-6

    # B1 at fm_rx's shape: C = 5, T = 129, D = 8
    model = FmChannelizer(
        sample_rate=RX_FS, tuning_frequency=0.0,
        channel_frequencies=RX_STATIONS, frequency_deviation=75_000.0,
        decimation=8, low_pass_taps=fm_rx.design_lowpass(129, 0.05),
        device="cuda")
    re, im = int8_iq_to_planar(raw[:2 * RX_BLOCK])
    buf = buffer(model, ComplexArray(torch.from_numpy(re).cuda(),
                                     torch.from_numpy(im).cuda()))
    n0, _, cf, cz = model.init()
    margs = (buf, model.tap_bank, model.lo_table, n0, model.decimation,
             model.gain, model.deemph, cf, cz)
    timing = time_kernel(fm_chain, fm_chain_reference,
                         dense_front_library(model, buf), margs,
                         precision="bf16x3")
    flops, nbytes, tensor = fm_bound(model, buf.re.shape[-1], "bf16x3")
    bnd = bound(flops, nbytes, tensor)
    step_ms = prof_wall / (RX_N // RX_BLOCK) * 1e3
    idle = None if dev_s <= 0 else 1.0 - dev_s / prof_wall
    print(f"main path: fm_rx at its defaults (C={c}, T=129, D=8, bf16x3), "
          f"{RX_N} samples in blocks of {RX_BLOCK}, launches {got}; audio vs "
          f"impl='torch' {err:.3g} of max|audio| (tol {AUDIO_REL_TOL}); "
          f"five tones; resume bit-equal; 48-kHz tones {peaks}; native host "
          f"library")
    verdict = ("idle share not measured" if idle is None else
               "host-bound (file read, int8 staging, ring, audio fetch and "
               "file write)" if idle > 0.5 else "device-bound")
    print(f"fm_rx step {step_ms:.3f} ms a block of {RX_BLOCK} samples "
          f"(wall clock, file to file, profiler on), device idle share "
          f"{idle}: {verdict}")
    print(json.dumps({
        "phase": "fm_rx", "launches": got, "first_run_wall_s": wall,
        "profiled_wall_s": prof_wall, "step_ms": step_ms,
        "input_msps": RX_N / prof_wall / 1e6, "device_s": dev_s,
        "device_idle_share": idle, "vs_torch_rel": err,
        "audio_48k_peaks_hz": peaks, "kernel_ms": timing[0],
        "kernel_device_us": timing[1], "plain_ms": timing[2],
        "library_ms": timing[3], "bound_us": bnd[0] * 1e3,
        "bound_by": bnd[1], "mbytes": nbytes / 1e6, "card": CARD}))


EXAMPLE_LAUNCHES = {
    "fm_broadcast_rx": {"fm_chain": 4},
    "wideband_rx": {"pfb_fm_chain": 1},
    "wideband_duplex": {"pfb_fm_chain": 1},
    "qpsk_link": {},
}


def example_shapes():
    """The kernel shapes of the examples' main paths, as models at bf16x3
    with the examples' own arguments: fm_broadcast_rx's B1 (C = 3,
    T = 128, D = 8 at 2 MHz, 75-kHz deviation) and wideband_rx's B2
    (K = 32, Q = 8, D = 32, C = 32 at 2.048 MHz, 12-kHz deviation); each
    with the f32 plain impl it is held against."""
    from gsdr_tpu_torch.examples import fm_broadcast_rx, wideband_rx

    bcast = FmChannelizer(
        sample_rate=2_000_000.0, tuning_frequency=0.0,
        channel_frequencies=(-400_000.0, 0.0, 500_000.0),
        frequency_deviation=75_000.0, decimation=8,
        low_pass_taps=fm_broadcast_rx.lowpass(128, 0.05), device="cuda")
    check(bcast.front == "toeplitz", f"fm_broadcast_rx: front {bcast.front}")
    fs, k = 2_048_000.0, 32
    wide = FmChannelizer(
        sample_rate=fs, tuning_frequency=0.0,
        channel_frequencies=tuple(-fs / 2 + (fs / k) * c for c in range(k)),
        frequency_deviation=12_000.0, decimation=k,
        low_pass_taps=wideband_rx.lowpass(8 * k, 0.4 / k), device="cuda")
    check(wide.front == "pfb" and wide.pfb_grid[0] == k,
          f"wideband_rx: front {wide.front}")
    return (("fm_broadcast_rx_b1", bcast, "torch"),
            ("wideband_rx_b2_k32", wide, "pfb_torch"))


def examples_phase():
    """Phase 14: the four ported examples' main() on the card, counted
    (B1 for fm_broadcast_rx, B2 at K = 32 for the wideband pair; the QPSK
    links take no kernel); then each kernel at its example's shape held,
    over two 2^20-sample steps of FM carriers at the example's deviation,
    against its plain version at bf16x3 (AUDIO_REL_TOL after the warm-up,
    CARRY_ATOL) and the f32 plain chain (FM_GRADE_TOL), and timed."""
    import functools
    import importlib

    for name, want in EXAMPLE_LAUNCHES.items():
        mod = importlib.import_module(f"gsdr_tpu_torch.examples.{name}")
        rc, got = counted(name, lambda: mod.main([]), want)
        check(rc == 0, f"example {name} returned {rc}")
        print(f"example {name}: main() returned 0 on the card, launches "
              f"{ {k: v for k, v in got.items() if v} }")

    for what, model, plain_impl in example_shapes():
        pfb = model.front == "pfb"
        signal = functools.partial(wideband_fm_signal,
                                   deviation=model.frequency_deviation)
        plain = FmChannelizer(
            sample_rate=model.sample_rate, tuning_frequency=0.0,
            channel_frequencies=model.channel_frequencies,
            frequency_deviation=model.frequency_deviation,
            decimation=model.decimation,
            low_pass_taps=tuple(float(v) for v in model.low_pass_taps),
            impl=plain_impl, device="cuda")
        before = counts()
        max_abs, rel_plain = compare_fm(model, [PlainAtGrade(model)], signal)
        _, rel_f32 = compare_fm(model, [plain], signal,
                                tol=FM_GRADE_TOL["bf16x3"])
        for name, k in COUNTERS.items():
            k.launches = before[name]
        rf = signal(model, 0, N)
        buf = buffer(model, rf)
        n0, _, cf, cz = model.init()
        back = (model.lo_table, n0, model.decimation, model.gain,
                model.deemph, cf, cz)
        if pfb:
            args = (buf, model.poly_taps, model.dft_bank, model.num_taps,
                    *back)
            timing = time_kernel(pfb_fm_chain, pfb_fm_chain_reference,
                                 pfb_front_library(model, buf), args,
                                 precision="bf16x3")
        else:
            args = (buf, model.tap_bank, *back)
            timing = time_kernel(fm_chain, fm_chain_reference,
                                 dense_front_library(model, buf), args,
                                 precision="bf16x3")
        flops, nbytes, tensor = fm_bound(model, buf.re.shape[-1], "bf16x3")
        bnd = bound(flops, nbytes, tensor)
        print(f"{'pfb_fm_chain' if pfb else 'fm_chain'} at {what}'s shape "
              f"(C={model.num_channels}, T={model.num_taps}, "
              f"D={model.decimation}) at bf16x3 vs its plain version: "
              f"max-abs {max_abs:.3g}, rel {rel_plain:.3g} (tol "
              f"{AUDIO_REL_TOL}); vs the f32 plain chain: rel {rel_f32:.3g} "
              f"(tol {FM_GRADE_TOL['bf16x3']})")
        print(json.dumps({
            "phase": what, "grade": "bf16x3", "max_abs": max_abs,
            "vs_plain_rel": rel_plain, "vs_f32_rel": rel_f32,
            "kernel_ms": timing[0], "kernel_device_us": timing[1],
            "plain_ms": timing[2], "library_ms": timing[3],
            "bound_us": bnd[0] * 1e3, "bound_by": bnd[1],
            "mbytes": nbytes / 1e6, "card": CARD}))


CARD = None


def main():
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1) the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    # 2) build every kernel from the checkout
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {_build.sources()}")
    for src, rep in reports.items():
        print(f"ptxas {src}:\n{rep.strip()}", file=sys.stderr)

    # 3-8) the receivers, the channelized link and the QPSK256 receiver
    kernels = flagship_phase() + fm_wideband_phase()
    fm_d8_phase()
    kernels += am_phase()
    kernels += transmux_phase() + [qpsk256_phase()]

    # 9-10) the IIR kernel alone and the streaming FM receiver
    n_alone, err_alone, lines = iir_standalone_phase()
    n_fm, err_fm = stream_fm_phase()
    kernels.append(iir_entry(n_alone + n_fm, max(err_alone, err_fm), lines))

    # 12-14) the single-channel ops, the fm_rx command line, the examples
    ops_phase()
    with tempfile.TemporaryDirectory() as tmp:
        fm_rx_phase(Path(tmp))
    examples_phase()
    print(json.dumps({"kernels": kernels}))

    # 11) the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
