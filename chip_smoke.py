"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Runs the flagship FmChannelizer of gsdr_tpu_torch (16 channels spaced
60 kHz around 100 MHz, 64-tap Hamming low-pass, decimation 4, Fs = 1 MHz,
2^20 planar complex samples per step) through the hand-written kernels:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds every kernel from gsdr_tpu_torch/kernels/csrc with nvcc;
  3. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes (two streamed 2^20-sample steps);
  4. streams 8 steps through FmChannelizer(impl='auto') with the launch
     counters set to 0 just before, and checks the audio, the counts and
     block invariance;
  5. times the step, each kernel, its plain version and a library yardstick
     with CUDA events, and prints one JSON timing line and one `kernels`
     line;
  6. prints {"ok": true, "device": {...}} as its last line.

Any failed check, build or launch exits non-zero before the last line.
Usage: python3 chip_smoke.py  (from the repository root, one GPU).
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.kernels import _build
from gsdr_tpu_torch.kernels.fm_chain import fm_chain, fm_chain_reference
from gsdr_tpu_torch.pipelines import FmChannelizer
from gsdr_tpu_torch.utils.precision import full_f32

N = 1 << 20            # complex input samples per step
STEPS = 8              # main-path steps
SKIP = 256             # zero-primed warm-up outputs left out of comparisons
AUDIO_REL_TOL = 1e-4   # kernel vs plain, max-abs error / max|audio|
CARRY_ATOL = 1e-4
FS = 1_000_000.0
TUNING = 100_000_000.0
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


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


def fm_signal(model, start, n, seed=7):
    """Real FM carriers on every channel, made on the card in float64.
    Not white noise: noise puts samples on the atan2 branch cut, where two
    correct implementations differ by 2*pi*gain."""
    phases = np.random.default_rng(seed).uniform(0, 6, model.num_channels)
    t = torch.arange(start, start + n, dtype=torch.float64, device="cuda") / FS
    re = torch.zeros(n, dtype=torch.float64, device="cuda")
    im = torch.zeros_like(re)
    amp = 0.5 / model.num_channels
    for k, f in enumerate(model.channel_frequencies):
        msg = torch.sin(2 * np.pi * (700.0 + 370.0 * k) * t + phases[k])
        ph = 2 * np.pi * (f - TUNING) * t + 0.35 * msg
        re += amp * torch.cos(ph)
        im += amp * torch.sin(ph)
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1) the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    # 2) build every kernel from the checkout
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {_build.sources()}")
    for src, rep in reports.items():
        print(f"ptxas {src}:\n{rep.strip()}", file=sys.stderr)

    # 3) kernel vs plain version on the card, two streamed steps
    kern, plain = flagship("cuda"), flagship("torch")
    sk, sp = kern.init(), plain.init()
    max_abs = worst_rel = 0.0
    for i in range(2):
        rf = fm_signal(kern, i * N, N)
        sk, yk = kern.step(sk, rf)
        sp, yp = plain.step(sp, rf)
        torch.cuda.synchronize()
        skip = SKIP if i == 0 else 0
        check(yk.shape == yp.shape == (16, N // 4), f"shape {tuple(yk.shape)}")
        err = rel_err(yk, yp, skip)
        max_abs = max(max_abs, float((yk - yp)[:, skip:].abs().max()))
        worst_rel = max(worst_rel, err)
        check(err <= AUDIO_REL_TOL, f"step {i} audio rel err {err:.3g}")
        for a, b, what in ((sk[2].re, sp[2].re, "disc_carry.re"),
                           (sk[2].im, sp[2].im, "disc_carry.im"),
                           (sk[3], sp[3], "deemph_zi")):
            d = float((a - b).abs().max())
            check(d <= CARRY_ATOL, f"step {i} {what} differs by {d:.3g}")
        check(int(sk[0]) == int(sp[0]), "n0 differs")
    print(f"fm_chain vs plain: audio max-abs {max_abs:.3g}, "
          f"rel {worst_rel:.3g} (tol {AUDIO_REL_TOL}), carries atol "
          f"{CARRY_ATOL}")

    # 4) the main path, counted
    model = flagship("auto")
    blocks = [fm_signal(model, i * N, N, seed=11) for i in range(STEPS)]
    torch.cuda.synchronize()
    fm_chain.launches = 0
    state = model.init()
    outs = []
    for rf in blocks:
        state, audio = model.step(state, rf)
        outs.append(audio)
    torch.cuda.synchronize()
    launches = fm_chain.launches
    check(launches == STEPS, f"fm_chain launched {launches} times in "
          f"{STEPS} steps")
    for a in outs:
        check(tuple(a.shape) == (16, N // 4), f"audio shape {tuple(a.shape)}")
        check(bool(torch.isfinite(a).all()), "non-finite audio")
    # physics: each channel's audio peaks at its own modulating tone
    last = outs[-1].double()
    spec = torch.fft.rfft((last - last.mean(-1, keepdim=True))
                          * torch.hann_window(last.shape[-1], dtype=torch.float64,
                                              device=last.device)).abs()
    bin_hz = model.audio_rate / last.shape[-1]
    lo = int(100.0 / bin_hz) + 1
    for k in range(model.num_channels):
        peak = (int(spec[k, lo:].argmax()) + lo) * bin_hz
        want = 700.0 + 370.0 * k
        check(abs(peak - want) <= 2 * bin_hz + 5.0,
              f"channel {k} tone at {peak:.1f} Hz, want {want:.1f}")
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
          f"{launches}, block invariance max-abs "
          f"{float((halves - whole).abs().max()):.3g}")

    # 5) timing
    state = model.init()

    def one_step():
        nonlocal state
        state, _ = model.step(state, blocks[0])

    step_ms = cuda_ms(one_step, reps=20)
    step_dev = device_us(one_step, reps=10)
    n0, tail, cf, cz = model.init()
    buf = ComplexArray(torch.cat([tail.re, blocks[0].re]),
                       torch.cat([tail.im, blocks[0].im]))
    args = (buf, model.tap_bank, model.lo_table, n0, model.decimation,
            model.gain, model.deemph, cf, cz)
    before = fm_chain.launches
    kernel_ms = cuda_ms(lambda: fm_chain(*args), reps=20)
    kernel_dev = device_us(lambda: fm_chain(*args), reps=10)
    plain_ms = cuda_ms(lambda: fm_chain_reference(*args), reps=4, bursts=3)
    lhs = torch.stack([buf.re, buf.im])[None]

    def library():
        with full_f32():
            F.conv1d(lhs, model.tap_bank, stride=model.decimation)

    library_ms = cuda_ms(library, reps=20)
    fm_chain.launches = before  # timing launches are not main-path launches
    busy_us = sum(step_dev.values())
    print(json.dumps({"device_us_per_step": step_dev,
                      "device_us_per_fm_chain_call": kernel_dev,
                      "device_idle_share": 1.0 - busy_us / (step_ms * 1e3)}))

    c, t, d = model.num_channels, model.num_taps, model.decimation
    nb = buf.re.shape[-1]
    m = (nb - t) // d + 1
    flops = 8.0 * c * t * m                      # complex MACs of the bank
    nbytes = 4.0 * (2 * nb + 4 * c * t + 4 * c + 3 + 3 * c   # inputs
                    + c * m + 3 * c)                        # outputs
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(json.dumps({
        "metric": "fm_channelizer_16ch_64tap_dec4_input_msps",
        "value": N / (step_ms * 1e-3) / 1e6, "unit": "Msamples/s",
        "step_ms": step_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "kernel_device_ms":
            sum(kernel_dev.values()) / 1e3, "bound_us": bound_ms * 1e3,
        "bound_by": bound_by, "gflop_per_step": flops / 1e9,
        "mbytes_per_step": nbytes / 1e6, "launches_per_step": launches / STEPS,
        "card": card}))
    print(json.dumps({"kernels": [{
        "name": "fm_chain", "route": "cuda",
        "source": "gsdr_tpu_torch/kernels/csrc/fm_chain.cu",
        "replaces": "gsdr_tpu/kernels/fm_chain_pallas.py:888",
        "launches": launches, "max_abs_err": max_abs, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}]}))

    # 6) the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
