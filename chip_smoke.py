"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Runs the receivers of gsdr_tpu_torch through the hand-written kernels, at
full width, 2^20 planar complex samples per step:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds every kernel from gsdr_tpu_torch/kernels/csrc with nvcc, one
     process per source, all at once;
  3. the flagship FmChannelizer (16 channels spaced 60 kHz around 100 MHz,
     64-tap Hamming low-pass, D=4, Fs = 1 MHz): kernel B1 against its plain
     version over two streamed steps, then 8 steps through impl='auto'
     with the launch counters set to 0 just before (audio, counts, tones,
     block invariance), then timing;
  4. FM wideband critical (64 channels on the Fs/64 grid, 512 taps, D=64;
     benchmarks/run_all.py bench_fm_wideband): B2 (PFB front) against its
     plain version and against B1 over two steps, 8 steps through
     impl='auto' counted (it must take B2) with all 64 tones recovered,
     then timing of B2 and of the step through B2 and through B1;
  5. FM wideband D=8 (P=8 phases): B2 against its plain version and B1;
  6. AM wideband critical (run_all.py bench_am_wideband) and the 8-channel
     AM receiver of __graft_entry__.py (am_d): B3 on both fronts against
     the plain versions and each other, 8 steps of each through
     impl='auto' counted (PFB front on the grid, dense off it), tones
     checked, then timing;
  7. prints one JSON `kernels` line (B1, B2, B3-dense, B3-PFB) and, last,
     {"ok": true, "device": {...}}.

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
import time

import numpy as np
import torch
import torch.nn.functional as F

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.kernels import _build
from gsdr_tpu_torch.kernels.am_chain import (
    am_chain,
    am_chain_reference,
    pfb_am_chain,
    pfb_am_chain_reference,
)
from gsdr_tpu_torch.kernels.fm_chain import (
    fm_chain,
    fm_chain_reference,
    pfb_fm_chain,
    pfb_fm_chain_reference,
)
from gsdr_tpu_torch.ops.pfb import uniform_bank_front, uniform_grid
from gsdr_tpu_torch.pipelines import AmReceiver, FmChannelizer
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
PEAK_HBM_BYTES = 3.35e12
COUNTERS = {"fm_chain": fm_chain, "pfb_fm_chain": pfb_fm_chain,
            "am_chain": am_chain, "pfb_am_chain": pfb_am_chain}
DENSE_LIBRARY = "F.conv1d of the tap bank (front only), TF32 off"
PFB_LIBRARY = ("grouped F.conv1d fold + torch.matmul DFT bank "
               "(front only), TF32 off")


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


def flagship(impl):
    return FmChannelizer(
        sample_rate=FS, tuning_frequency=TUNING,
        channel_frequencies=tuple(TUNING - 480_000.0 + 60_000.0 * i
                                  for i in range(16)),
        frequency_deviation=75_000.0, decimation=4,
        low_pass_taps=lowpass(64, 0.03), impl=impl, device="cuda")


def fm_wideband(impl, decimation=GRID):
    """benchmarks/run_all.py bench_fm_wideband: 64 channels -(Fs/64)*i,
    512-tap prototype with cutoff 0.4/64, D=64 (critical) or 8."""
    return FmChannelizer(
        sample_rate=FS, tuning_frequency=0.0,
        channel_frequencies=tuple(-(FS / GRID) * i for i in range(GRID)),
        frequency_deviation=75_000.0, decimation=decimation,
        low_pass_taps=lowpass(8 * GRID, 0.4 / GRID), impl=impl,
        device="cuda")


def am_wideband(impl):
    """benchmarks/run_all.py bench_am_wideband: the same grid and filter,
    D=64."""
    return AmReceiver(
        sample_rate=FS, tuning_frequency=0.0,
        channel_frequencies=tuple(-(FS / GRID) * i for i in range(GRID)),
        decimation=GRID, low_pass_taps=lowpass(8 * GRID, 0.4 / GRID),
        impl=impl, device="cuda")


def am_d(impl):
    """The 8-channel AM receiver of __graft_entry__.py (am_d)."""
    return AmReceiver(
        sample_rate=FS, tuning_frequency=TUNING,
        channel_frequencies=tuple(TUNING - 200_000.0 + 50_000.0 * i
                                  for i in range(8)),
        decimation=4, low_pass_taps=lowpass(32, 0.04), impl=impl,
        device="cuda")


def _time_axis(start, n):
    return torch.arange(start, start + n, dtype=torch.float64,
                        device="cuda") / FS


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


def wideband_fm_signal(model, start, n, seed=7):
    """An FM carrier at 1 kHz deviation on every channel of the grid, tone
    200 + 40*k Hz (examples/wideband_rx.py's construction, narrowed so each
    carrier stays inside its 15.6-kHz channel)."""
    phases = np.random.default_rng(seed).uniform(0, 6, model.num_channels)
    t = _time_axis(start, n)
    re = torch.zeros(n, dtype=torch.float64, device="cuda")
    im = torch.zeros_like(re)
    amp = 1.0 / model.num_channels
    for k, f in enumerate(model.channel_frequencies):
        tone = grid_tone(k)
        ph = (2 * np.pi * (f - model.tuning_frequency) * t
              + (1_000.0 / tone) * torch.sin(2 * np.pi * tone * t + phases[k]))
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


def device_us(fn, reps):
    """Device time per call of fn() by kernel name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0:
            out[e.key[:60]] = e.self_device_time_total / reps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def rel_err(got, want, skip=0):
    got, want = got[:, skip:], want[:, skip:]
    return float((got - want).abs().max() / want.abs().max())


def bound(flops, nbytes):
    """(bound ms, what bounds it) on the H100's FP32 FMA and HBM peaks."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
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


def compare_fm(kern, others, signal, steps=2):
    """Stream `steps` blocks through kern and each model of others; every
    other must agree with kern within AUDIO_REL_TOL after the warm-up and
    CARRY_ATOL on the carries. Returns the worst max-abs and rel error."""
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
            check(err <= AUDIO_REL_TOL,
                  f"{kern.impl} vs {models[j].impl} step {i}: audio rel err "
                  f"{err:.3g}")
            sk, so = states[0], states[j]
            for a, b, what in ((sk[2].re, so[2].re, "disc_carry.re"),
                               (sk[2].im, so[2].im, "disc_carry.im"),
                               (sk[3], so[3], "deemph_zi")):
                d = float((a - b).abs().max())
                check(d <= CARRY_ATOL, f"{kern.impl} vs {models[j].impl} "
                      f"step {i}: {what} differs by {d:.3g}")
            check(int(sk[0]) == int(so[0]), "n0 differs")
    return max_abs, worst


def compare_am(models, signal, steps=2):
    """Stream `steps` blocks through every model; all envelopes within
    ENV_ATOL of the first's. Returns the worst max-abs error."""
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
            check(d <= ENV_ATOL, f"AM {models[0].impl} vs {models[j].impl} "
                  f"step {i}: envelope differs by {d:.3g}")
    return worst


def main_path(model, blocks, want_counts):
    """Stream blocks through the model with every counter set to 0 just
    before and read just after; the counts must equal want_counts."""
    torch.cuda.synchronize()
    reset_counts()
    state = model.init()
    outs = []
    for rf in blocks:
        state, audio = model.step(state, rf)
        outs.append(audio)
    torch.cuda.synchronize()
    got = counts()
    want = {name: want_counts.get(name, 0) for name in COUNTERS}
    check(got == want, f"{type(model).__name__}(impl={model.impl!r}) "
          f"launches {got}, want {want}")
    for a in outs:
        check(tuple(a.shape) == (model.num_channels, N // model.decimation),
              f"audio shape {tuple(a.shape)}")
        check(bool(torch.isfinite(a).all()), "non-finite audio")
    return outs, got


def time_step(model, rf):
    """(ms per step back to back, device us per step by kernel, idle share)."""
    state = model.init()

    def one_step():
        nonlocal state
        state, _ = model.step(state, rf)

    step_ms = cuda_ms(one_step, reps=20)
    step_dev = device_us(one_step, reps=10)
    idle = 1.0 - sum(step_dev.values()) / (step_ms * 1e3)
    return step_ms, step_dev, idle


def time_kernel(kernel, plain, library, args, plain_reps=4):
    """(kernel ms, kernel device us by name, plain ms, library ms); the
    kernel's counter is restored, timing launches are no main-path
    launches."""
    before = kernel.launches
    k_ms = cuda_ms(lambda: kernel(*args), reps=20)
    k_dev = device_us(lambda: kernel(*args), reps=10)
    kernel.launches = before
    p_ms = cuda_ms(lambda: plain(*args), reps=plain_reps, bursts=3)
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


def fm_bound(model, nb):
    """(FLOPs, bytes) of one FM chain call over an nb-sample buffer: the
    cheapest front plus the back end's 16 operations per output and
    channel (rotor and discriminator products, de-emphasis; the sincos and
    atan2 left out), and the buffer, tables and carries in, the audio and
    carries out."""
    c, t, d = model.num_channels, model.num_taps, model.decimation
    m = (nb - t) // d + 1
    io = 4 * (2 * nb + 4 * c + 3 + 3 * c + c * m + 3 * c)
    return (front_flops(model) + 16.0 * c) * m, io + table_bytes(model)


def am_bound(model, nb):
    """As fm_bound for the AM chain: the cheapest front plus ~8 operations
    of envelope per output and channel; the buffer and tables in, the
    audio out."""
    c, t, d = model.num_channels, model.num_taps, model.decimation
    m = (nb - t) // d + 1
    return ((front_flops(model) + 8.0 * c) * m,
            4.0 * (2 * nb + c * m) + table_bytes(model))


def pfb_front_library(model, buf):
    """The library yardstick of the PFB front alone: a grouped F.conv1d
    fold per phase and one torch.matmul with the DFT bank, TF32 off."""
    def run():
        with full_f32():
            uniform_bank_front(buf, model.poly_taps, model.dft_bank,
                               model.num_taps, model.decimation)
    return run


def dense_front_library(model, buf):
    """The library yardstick of the dense front alone: F.conv1d of the
    complex tap bank, TF32 off."""
    lhs = torch.stack([buf.re, buf.im])[None]

    def run():
        with full_f32():
            F.conv1d(lhs, model.tap_bank, stride=model.decimation)
    return run


def kernel_entry(name, source, replaces, launches, max_abs, timing, bnd):
    k_ms, _, p_ms, lib_ms = timing
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms}


def flagship_phase():
    """Phase 3: B1 at the flagship; returns its kernels-line entry."""
    kern, plain = flagship("cuda"), flagship("torch")
    max_abs, worst_rel = compare_fm(kern, [plain], fm_signal)
    print(f"fm_chain vs plain: audio max-abs {max_abs:.3g}, "
          f"rel {worst_rel:.3g} (tol {AUDIO_REL_TOL}), carries atol "
          f"{CARRY_ATOL}")

    model = flagship("auto")
    check(model.front == "toeplitz", "flagship must take the dense front")
    blocks = [fm_signal(model, i * N, N, seed=11) for i in range(STEPS)]
    outs, got = main_path(model, blocks, {"fm_chain": STEPS})
    check_tones(outs[-1], model.audio_rate, lambda k: 700.0 + 370.0 * k,
                "flagship")
    _, whole = model.step(model.init(), blocks[0])
    st, h1 = model.step(model.init(), blocks[0][..., :N // 2])
    _, h2 = model.step(st, blocks[0][..., N // 2:])
    # The halves reach the same global samples through another reduced
    # stream index, so the float32 digit-table LO phase rounds differently
    # (bounded at ~6e-5 cycles, utils/phase.py); held to the JAX package's
    # block-invariance tolerance, rtol = atol = 1e-4 (tests/test_pipelines.py).
    halves = torch.cat([h1, h2], dim=-1)
    inv = float(((halves - whole).abs() - 1e-4 * whole.abs()).max())
    check(inv <= 1e-4, f"block invariance excess {inv:.3g}")
    print(f"main path: {STEPS} steps of {N} samples, fm_chain launches "
          f"{got['fm_chain']}, block invariance max-abs "
          f"{float((halves - whole).abs().max()):.3g}")

    step_ms, step_dev, idle = time_step(model, blocks[0])
    buf = buffer(model, blocks[0])
    n0, _, cf, cz = model.init()
    args = (buf, model.tap_bank, model.lo_table, n0, model.decimation,
            model.gain, model.deemph, cf, cz)
    timing = time_kernel(fm_chain, fm_chain_reference,
                         dense_front_library(model, buf), args)
    flops, nbytes = fm_bound(model, buf.re.shape[-1])
    bnd = bound(flops, nbytes)
    print(json.dumps({"device_us_per_step": step_dev,
                      "device_us_per_fm_chain_call": timing[1],
        "library": DENSE_LIBRARY,
                      "device_idle_share": idle}))
    print(json.dumps({
        "metric": "fm_channelizer_16ch_64tap_dec4_input_msps",
        "value": N / (step_ms * 1e-3) / 1e6, "unit": "Msamples/s",
        "step_ms": step_ms, "kernel_ms": timing[0], "plain_ms": timing[2],
        "library_ms": timing[3], "kernel_device_ms":
            sum(timing[1].values()) / 1e3, "bound_us": bnd[0] * 1e3,
        "bound_by": bnd[1], "gflop_per_step": flops / 1e9,
        "mbytes_per_step": nbytes / 1e6,
        "launches_per_step": got["fm_chain"] / STEPS, "card": CARD}))
    return kernel_entry(
        "fm_chain", "gsdr_tpu_torch/kernels/csrc/fm_chain.cu",
        "gsdr_tpu/kernels/fm_chain_pallas.py:888", got["fm_chain"], max_abs,
        timing, bnd)


def fm_wideband_phase():
    """Phase 4: B2 at FM wideband critical; returns its entry."""
    kern, plain, dense = (fm_wideband("pfb"), fm_wideband("pfb_torch"),
                          fm_wideband("cuda"))
    check(kern.front == "pfb" and kern.pfb_grid[0] == GRID, "B2 grid")
    max_abs, rel_plain = compare_fm(kern, [plain], wideband_fm_signal)
    _, rel_dense = compare_fm(kern, [dense], wideband_fm_signal)
    print(f"pfb_fm_chain (K=64, D=64) vs plain: max-abs {max_abs:.3g}, rel "
          f"{rel_plain:.3g}; vs dense fm_chain: rel {rel_dense:.3g} "
          f"(tol {AUDIO_REL_TOL}), carries atol {CARRY_ATOL}")

    model = fm_wideband("auto")
    check(model.front == "pfb", "'auto' must take the PFB front here")
    blocks = [wideband_fm_signal(model, i * N, N, seed=11)
              for i in range(STEPS)]
    outs, got = main_path(model, blocks, {"pfb_fm_chain": STEPS})
    check_tones(outs[-1], model.audio_rate, grid_tone, "FM wideband")
    print(f"main path: FM wideband critical, {STEPS} steps, launches {got}, "
          f"all {GRID} tones recovered")

    buf = buffer(model, blocks[0])
    n0, _, cf, cz = model.init()
    args = (buf, model.poly_taps, model.dft_bank, model.num_taps,
            model.lo_table, n0, model.decimation, model.gain, model.deemph,
            cf, cz)
    timing = time_kernel(pfb_fm_chain, pfb_fm_chain_reference,
                         pfb_front_library(model, buf), args)
    bnd = bound(*fm_bound(model, buf.re.shape[-1]))
    steps = {}
    for impl, m in (("auto", model), ("cuda", dense)):
        step_ms, step_dev, idle = time_step(m, blocks[0])
        steps[impl] = {"msps": N / (step_ms * 1e-3) / 1e6, "step_ms": step_ms,
                       "device_us_per_step": step_dev,
                       "device_idle_share": idle}
    d_args = (buf, dense.tap_bank, dense.lo_table, n0, dense.decimation,
              dense.gain, dense.deemph, cf, cz)
    before = fm_chain.launches
    dense_ms = cuda_ms(lambda: fm_chain(*d_args), reps=10)
    fm_chain.launches = before
    print(json.dumps({
        "metric": "fm_wideband_64ch_crit_input_msps", "unit": "Msamples/s",
        "value": steps["auto"]["msps"], "step_auto_pfb": steps["auto"],
        "step_cuda_dense": steps["cuda"], "pfb_kernel_ms": timing[0],
        "pfb_kernel_device_us": timing[1], "dense_kernel_ms": dense_ms,
        "dense_bound": bound(*fm_bound(dense, buf.re.shape[-1])),
        "plain_ms": timing[2], "library_ms": timing[3],
        "library": PFB_LIBRARY,
        "bound_ms": bnd[0], "bound_by": bnd[1], "card": CARD}))
    return kernel_entry(
        "pfb_fm_chain", "gsdr_tpu_torch/kernels/csrc/fm_chain.cu",
        "gsdr_tpu/kernels/fm_chain_pallas.py:414", got["pfb_fm_chain"],
        max_abs, timing, bnd)


def fm_d8_phase():
    """Phase 5: B2 at the D=8 variant (P=8) against plain and B1, and the
    two kernels' times there."""
    kern, plain, dense = (fm_wideband("pfb", 8), fm_wideband("pfb_torch", 8),
                          fm_wideband("cuda", 8))
    check(kern.pfb_grid[0] == GRID and fm_wideband("auto", 8).front == "pfb",
          "D=8: grid and 'auto' route")
    max_abs, rel_plain = compare_fm(kern, [plain], wideband_fm_signal)
    _, rel_dense = compare_fm(kern, [dense], wideband_fm_signal)
    rf = wideband_fm_signal(kern, 0, N)
    buf = buffer(kern, rf)
    n0, _, cf, cz = kern.init()
    back = (kern.lo_table, n0, 8, kern.gain, kern.deemph, cf, cz)
    before = counts()
    pfb_ms = cuda_ms(lambda: pfb_fm_chain(buf, kern.poly_taps, kern.dft_bank,
                                          kern.num_taps, *back), reps=10)
    dense_ms = cuda_ms(lambda: fm_chain(buf, dense.tap_bank, *back), reps=4)
    for name, k in COUNTERS.items():
        k.launches = before[name]
    print(json.dumps({
        "phase": "fm_wideband_64ch_d8", "pfb_vs_plain_rel": rel_plain,
        "pfb_vs_dense_rel": rel_dense, "pfb_max_abs": max_abs,
        "pfb_kernel_ms": pfb_ms,
        "pfb_bound": bound(*fm_bound(kern, buf.re.shape[-1])),
        "dense_kernel_ms": dense_ms,
        "dense_bound": bound(*fm_bound(dense, buf.re.shape[-1])),
        "card": CARD}))


def am_phase():
    """Phase 6: B3 on both fronts; returns the two entries."""
    pfb, pfb_plain, dense, dense_plain = (
        am_wideband("pfb"), am_wideband("pfb_torch"), am_wideband("cuda"),
        am_wideband("torch"))
    err_pfb = compare_am([pfb, pfb_plain], am_signal)
    err_dense = compare_am([dense, dense_plain], am_signal)
    err_fronts = compare_am([pfb, dense], am_signal)
    err_am_d = compare_am([am_d("cuda"), am_d("torch")], am_signal)
    print(f"AM wideband: pfb_am_chain vs plain {err_pfb:.3g}, am_chain vs "
          f"plain {err_dense:.3g}, fronts {err_fronts:.3g}; am_d shape "
          f"am_chain vs plain {err_am_d:.3g} (tol {ENV_ATOL} absolute)")
    # the dense front on the wideband grid, the A/B partner of B3-PFB
    buf = buffer(dense, am_signal(dense, 0, N))
    args = (buf, dense.tap_bank, dense.lo_table, dense.init()[0], GRID)
    before = am_chain.launches
    dense_ms = cuda_ms(lambda: am_chain(*args), reps=10)
    dense_dev = device_us(lambda: am_chain(*args), reps=5)
    am_chain.launches = before
    print(json.dumps({
        "phase": "am_wideband_dense", "kernel_ms": dense_ms,
        "kernel_device_us": dense_dev,
        "bound": bound(*am_bound(dense, buf.re.shape[-1])),
        "card": CARD}))

    entries = []
    for model, kernel, plain, library, what, name, max_abs in (
            (am_wideband("auto"), pfb_am_chain, pfb_am_chain_reference,
             pfb_front_library, PFB_LIBRARY, "pfb_am_chain", err_pfb),
            (am_d("auto"), am_chain, am_chain_reference,
             dense_front_library, DENSE_LIBRARY, "am_chain", err_am_d)):
        blocks = [am_signal(model, i * N, N, seed=11) for i in range(STEPS)]
        outs, got = main_path(model, blocks, {name: STEPS})
        env = outs[-1]
        check(float(env.min()) >= -1.0 and float(env.max()) <= 1.0,
              "envelope outside [-1, 1]")
        # below 5 kHz: am_d's 32-tap filter passes its neighbours, whose
        # carriers beat with the channel's at 50 kHz in the envelope
        check_tones(env, model.audio_rate, grid_tone, f"AM {name}",
                    hi_hz=5_000.0)
        print(f"main path: AM {name}, {STEPS} steps, launches {got}, "
              f"tones recovered")
        buf = buffer(model, blocks[0])
        n0 = model.init()[0]
        if model.front == "pfb":
            args = (buf, model.poly_taps, model.dft_bank, model.num_taps,
                    model.lo_table, n0, model.decimation)
        else:
            args = (buf, model.tap_bank, model.lo_table, n0, model.decimation)
        timing = time_kernel(kernel, plain, library(model, buf), args)
        step_ms, step_dev, idle = time_step(model, blocks[0])
        bnd = bound(*am_bound(model, buf.re.shape[-1]))
        print(json.dumps({
            "phase": f"am_{name}", "step_ms": step_ms,
            "msps": N / (step_ms * 1e-3) / 1e6, "device_idle_share": idle,
            "device_us_per_step": step_dev, "kernel_ms": timing[0],
            "kernel_device_us": timing[1], "plain_ms": timing[2],
            "library_ms": timing[3], "library": what, "bound_ms": bnd[0],
            "bound_by": bnd[1], "card": CARD}))
        entries.append(kernel_entry(
            name, "gsdr_tpu_torch/kernels/csrc/am_chain.cu",
            "gsdr_tpu/kernels/fm_chain_pallas.py:551", got[name], max_abs,
            timing, bnd))
    return entries


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

    # 3-6) the receivers
    kernels = [flagship_phase(), fm_wideband_phase()]
    fm_d8_phase()
    kernels += am_phase()
    print(json.dumps({"kernels": kernels}))

    # 7) the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
