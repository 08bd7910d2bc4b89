"""Probe two questions about the dense front's grades on one NVIDIA GPU.

  steps: does the flagship step at one grade read slower than at another
         because of the grade, the order in which the grades are timed, or
         what the process ran before? Times the flagship FmChannelizer
         step (impl='auto', 2^20 samples) at each grade, in the order
         bf16x3, bf16x2, f32 and in the reverse order: in a fresh process,
         after chip_smoke.py's comparisons with the plain chains (two
         2^20-sample steps per grade), and after one torch.profiler
         session. Per step: CUDA events around 20 back-to-back steps
         (median of 5 bursts), and the host's enqueue time of 20 steps
         before the synchronize.
  b4:    the channelizer kernel (B4) at bf16x3 and bf16x2 at four shapes
         (bench_pfb's K=16, 5 channels at T=61 and D=4, the flagship's
         bank, the transmux's K=32): device time per call by
         torch.profiler, call time by CUDA events, and the error against
         the plain version at the grade, of max|y|.
  b5b6:  the IIR kernel (B5) at bench_iir's 2^20 samples (biquad, order 8,
         planar biquad) and at stream_fm's 2^18 (its de-emphasis and one
         of its SOS sections), and the QPSK256 kernel (B6) at 2^19 noisy
         CIRCULAR symbols: device time per call and device kernels per
         call by torch.profiler, call time by CUDA events, the error
         against the plain version; where the tree's B6 writes uint8, both
         output types. It uses only what every tree of the port since B5
         has, so it times an older tree too: copy this file into that
         tree's tools/ and run it there.
  fm_rx: the fm_rx command line at chip_smoke.py's five-station capture
         (2^24 int8 samples at 2.048 MHz, blocks of 2^20, the CLI's
         defaults): the wall clock of a warm run file to file without the
         profiler, and where a warm run's host time goes (cProfile: seconds
         of own time by function, the top eight).

Prints one JSON line per reading. Usage, from the repository root (the
kernels are built from this checkout):
    python3 tools/probe_grades.py steps
    python3 tools/probe_grades.py b4
    python3 tools/probe_grades.py b5b6
    python3 tools/probe_grades.py fm_rx
"""

import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from gsdr_tpu_torch.carray import ComplexArray  # noqa: E402
from gsdr_tpu_torch.kernels import _build  # noqa: E402
from gsdr_tpu_torch.kernels.channelize import (  # noqa: E402
    channelize_kernel,
    channelize_reference,
)
from gsdr_tpu_torch.ops.channelize import make_complex_tap_bank  # noqa: E402
from gsdr_tpu_torch.ops.pfb import _analysis_tables, _taps_key  # noqa: E402

REPS, BURSTS = 20, 5


def host_us(fn, reps=REPS, bursts=BURSTS):
    """Host microseconds to enqueue one call of fn(), median of bursts."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(bursts):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        per_call.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def steps():
    models = {g: cs.flagship("auto", precision=g) for g in cs.GRADES}
    plain = cs.flagship("torch")
    rf = cs.fm_signal(plain, 0, cs.N)

    def stepper(model):
        state = model.init()

        def one_step():
            nonlocal state
            state, _ = model.step(state, rf)
        return one_step

    calls = {g: stepper(model) for g, model in models.items()}

    def measure(when):
        for order in (cs.GRADES, cs.GRADES[::-1]):
            for g in order:
                print(json.dumps({
                    "probe": "flagship_step", "when": when,
                    "order": "/".join(order), "grade": g,
                    "step_ms": cs.cuda_ms(calls[g], reps=REPS),
                    "host_enqueue_us": host_us(calls[g])}), flush=True)

    measure("fresh process")
    for g, model in models.items():
        cs.compare_fm(model, [cs.PlainAtGrade(model)], cs.fm_signal)
        cs.compare_fm(model, [plain], cs.fm_signal, tol=cs.FM_GRADE_TOL[g])
    measure("after the comparisons with the plain chains")
    dev = cs.device_us(calls["bf16x3"], reps=10)
    print(json.dumps({"probe": "profiler_session", "grade": "bf16x3",
                      "device_us_per_step": sum(dev.values())}), flush=True)
    measure("after one profiler session")


def b4():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    x = ComplexArray(torch.randn(cs.N, generator=gen, device="cuda"),
                     torch.randn(cs.N, generator=gen, device="cuda"))
    taps16 = cs.lowpass64(8 * 16, 0.4 / 16)
    taps32 = cs.lowpass64(8 * 32, 0.5 / 32)

    shapes = [
        ("bench_pfb K=16", _analysis_tables(_taps_key(taps16), 16,
                                            x.device)[0], 16),
        ("C=5 T=61 D=4", torch.as_tensor(make_complex_tap_bank(
            cs.lowpass(61, 0.05), [-5e4 * i for i in range(5)], cs.FS),
            device="cuda"), 4),
        ("flagship bank C=16 T=64 D=4", cs.flagship("torch").tap_bank, 4),
        ("transmux K=32", _analysis_tables(_taps_key(taps32), 32,
                                           x.device)[0], 32),
    ]
    for what, tap_bank, d in shapes:
        for g in ("bf16x3", "bf16x2"):
            def call(tap_bank=tap_bank, d=d, g=g):
                return channelize_kernel(x, tap_bank, d, precision=g)

            err, scale = cs.planar_err(
                call(), channelize_reference(x, tap_bank, d, g))
            dev = cs.device_us(call, reps=10)
            print(json.dumps({
                "probe": "b4", "shape": what, "grade": g,
                "C": tap_bank.shape[0] // 2, "T": tap_bank.shape[-1], "D": d,
                "device_us": sum(dev.values()),
                "call_ms": cs.cuda_ms(call, reps=REPS),
                "rel_err_vs_plain": err / scale}), flush=True)


def profile_call(fn, reps=20):
    """(device us per call, device kernels per call, kernel names) of fn()
    by torch.profiler, after one call outside the trace; the time is the
    mean over the records times the kernels per call (rounded), so a
    record the trace drops does not lower it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    if not ev:
        return None, 0, []
    per_call = max(1, round(len(ev) / reps))
    return (sum(e.device_time_total for e in ev) / len(ev) * per_call,
            len(ev) / reps, sorted({e.name[:40] for e in ev}))


def b5b6():
    import scipy.signal as ss
    from gsdr_tpu_torch.kernels import iir as tk
    from gsdr_tpu_torch.kernels import qpsk256 as tq
    from gsdr_tpu_torch.ops.iir import iir_block
    from gsdr_tpu_torch.ops.qpsk256 import CIRCULAR
    from gsdr_tpu_torch.pipelines import Qpsk256Modem, fm_deemphasis_coeffs

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rate = cs.FS / 4
    sos = ss.butter(8, 15e3, fs=rate, output="sos")
    cases = [(name, b, a, planar, cs.N)
             for name, b, a, planar in cs.IIR_FILTERS
             if name in ("biquad", "order8", "biquad_planar")]
    cases += [("stream_fm_deemph", *fm_deemphasis_coeffs(75e-6, rate), False,
               cs.N // 4),
              ("stream_fm_sos0", tuple(sos[0, :3]), tuple(sos[0, 3:]), False,
               cs.N // 4)]
    for name, b, a, planar, n in cases:
        rows = [torch.randn(n, generator=gen, device="cuda")
                for _ in range(2 if planar else 1)]
        x = ComplexArray(*rows) if planar else rows[0]
        filt = tk.iir_filter(b, a, "cuda")
        yp, _ = iir_block(b, a, x, impl="torch")
        scale = float((yp.re if planar else yp).abs().max())

        def call(x=x, filt=filt):
            return tk.iir_kernel(x, filt, None)

        y, _ = call()
        err = (float((y.re - yp.re).abs().max()) if planar
               else float((y - yp).abs().max())) / scale
        dev, per_call, names = profile_call(call)
        print(json.dumps({
            "probe": "b5", "case": name, "n": n, "rows": len(rows),
            "poles": len(filt.diag.poles), "device_us": dev,
            "grid_launches_per_call": per_call, "kernels": names,
            "call_ms": cs.cuda_ms(call, reps=REPS), "rel_err_vs_plain": err,
            "card": cs.CARD}), flush=True)

    modem = Qpsk256Modem(CIRCULAR, 1.0, exact_tables=True, device="cuda")
    s = torch.randint(0, 256, (cs.Q256_N,), generator=gen, device="cuda",
                      dtype=torch.int32)
    tx = modem.tx(s)
    noise = cs.Q256_SIGMA * torch.randn((2, cs.Q256_N), generator=gen,
                                        device="cuda")
    x = ComplexArray(tx.re + noise[0], tx.im + noise[1])
    want = tq.qpsk256_reference(x, modem.table)
    typed = "out_dtype" in inspect.signature(tq._launch).parameters
    variants = [("int32", lambda: tq.qpsk256_kernel(x, modem.table))]
    if typed:
        variants.append(("uint8", lambda: tq.qpsk256_kernel(
            x, modem.table, out_dtype=torch.uint8)))
    variants.append(("modem.rx (uint8)", lambda: modem.rx(x)))
    for label, call in variants:
        diff = int((call().long() != want.long()).sum())
        dev, per_call, names = profile_call(call)
        print(json.dumps({
            "probe": "b6", "n": cs.Q256_N, "out": label, "device_us": dev,
            "grid_launches_per_call": per_call, "kernels": names,
            "call_ms": cs.cuda_ms(call, reps=REPS),
            "decisions_differing_from_plain": diff, "card": cs.CARD}),
            flush=True)


def fm_rx():
    import cProfile
    import pstats
    import tempfile

    from gsdr_tpu_torch.tools import fm_rx as cli

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cap = tmp / "capture.iq"
        cs.rx_capture(cap)
        t0 = time.perf_counter()
        cli.main(cs.rx_args(cap, tmp / "a.f32"))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli.main(cs.rx_args(cap, tmp / "w.f32"))
        warm = time.perf_counter() - t0
        prof = cProfile.Profile()
        prof.enable()
        cli.main(cs.rx_args(cap, tmp / "c.f32"))
        torch.cuda.synchronize()
        prof.disable()
    own = sorted(pstats.Stats(prof).stats.items(),
                 key=lambda kv: -kv[1][2])[:8]
    blocks = cs.RX_N // cs.RX_BLOCK
    print(json.dumps({
        "probe": "fm_rx", "first_run_wall_s": first, "wall_s": warm,
        "step_ms": warm / blocks * 1e3, "input_msps": cs.RX_N / warm / 1e6,
        "host_s_own_top": {f"{fn[2]} ({Path(fn[0]).name}:{fn[1]})": v[2]
                           for fn, v in own},
        "card": cs.CARD}), flush=True)


def main():
    if not torch.cuda.is_available() or len(sys.argv) != 2 \
            or sys.argv[1] not in ("steps", "b4", "b5b6", "fm_rx"):
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(cs.CARD)
    if sys.argv[1] == "b5b6":
        _build.build_all(["iir", "qpsk256"])
        b5b6()
    elif sys.argv[1] == "fm_rx":
        _build.build_all(["fm_chain"])
        fm_rx()
    else:
        _build.build_all(["channelize", "fm_chain"])
        steps() if sys.argv[1] == "steps" else b4()
    return 0


if __name__ == "__main__":
    sys.exit(main())
