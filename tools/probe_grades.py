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

Prints one JSON line per reading. Usage, from the repository root (the
kernels are built from this checkout):
    python3 tools/probe_grades.py steps
    python3 tools/probe_grades.py b4
"""

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


def main():
    if not torch.cuda.is_available() or len(sys.argv) != 2 \
            or sys.argv[1] not in ("steps", "b4"):
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(cs.CARD)
    _build.build_all(["channelize", "fm_chain"])
    steps() if sys.argv[1] == "steps" else b4()
    return 0


if __name__ == "__main__":
    sys.exit(main())
