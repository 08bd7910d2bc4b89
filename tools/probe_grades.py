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
  compiled: where a compiled step's call spends its host time, for the
         flagship (bf16x3), the table-exact QPSK256 rx and stream_fm at
         chip_smoke.py's shapes: the host's enqueue time of one call of
         the eager step, of the compiled step (utils/compile.py) with the
         block copied in, and of its parts (the signature, the block's
         copy, the graph's replay, the clone of out), beside the call's
         time by CUDA events and a 20-step graph's time per step.
  dense: the dense front's kernels at the main paths' one-chunk shapes,
         each grade: B1 at the flagship, B3-dense at am_d, B4 at the
         transmux's K=32, Q=8 (and at f32 at bench_pfb's K=16); the
         chunked paths of chip_smoke.py's phase 11 on their first block,
         at f32 (B1 at the 2049-tap long filter, B3-dense at am_d128, B4
         at the transmux's Q=127) and at bf16x3 and bf16x2 (those, B1 at
         the narrowband scanner, and fm_demod's B1 and am_demod's B3-dense
         at T=65, D=256), with F.conv1d's time for each of the latter as
         library_ms: device time per call by torch.profiler (rounds of
         all, interleaved), and a digest of each output, also of the
         one-chunk shapes' launches forced to chip_smoke.FORCED_CHUNKS taps
         a chunk, and the registers and spill bytes ptxas reports for
         every tile kernel (as pfb). It uses only what every tree of the
         port with the chunked
         dense front (PR 12) has, so it times an older tree too (copy this
         file into that tree's tools/); equal digests across trees say the
         outputs are bit-equal.
  dense_mma: dense's bf16 chunked launches alone, each also forced to
         other chunks at bf16x3 (FORCED_MMA), with their digests and the
         tile kernels' registers: the quick timing of a variant of the
         front (tools/dense_variants.py runs it in each variant's tree).
  pfb:   the PFB front's kernels at each grade: B2 at FM wideband
         critical and at its D=8 variant, B3-PFB at AM wideband critical
         (one chunk), B2 at pfb_nfm_lmr_320 and B3-PFB at pfb_airband_480
         (chunked), and both at the K=640 and K=712 witnesses: device time
         per call by torch.profiler (rounds of all, interleaved), for the
         chunked paths the library's time (a grouped F.conv1d fold and one
         torch.matmul, TF32 off) as library_ms, a digest
         of each output, and the registers and spill bytes ptxas reports
         for every tile kernel of B1-B4 (run it before anything else
         builds in that tree). Like dense, it runs in a tree since PR 13
         too (copy this file into that tree's tools/), so equal digests say
         the outputs are bit-equal across trees.
  pfb_mma: pfb's chunked bf16 launches alone (NFM, airband, witnesses at
         bf16x3 and bf16x2), the main paths' also forced to other plans
         (FORCED_PFB), with their digests, the tile kernel's device time
         and the tile kernels' registers: the quick timing of a variant of
         the front (tools/pfb_variants.py runs it in each variant's tree).
  back_end: the FM chain (B1, B2) at the rows its back end moves: B1 at
         the flagship (each grade), at fm_demod's one channel (T=65, D=4),
         at the fm_rx CLI's five stations (T=129, D=8, 2.048 MHz) and
         fm_broadcast_rx's three (T=128, D=8, 2 MHz), at the 2049-tap long
         filter (chunked); B2 at FM wideband critical, at D=8 and at
         pfb_nfm_lmr_320 (chunked), bf16x3 unless said; 2^20 samples (the
         NFM path 983,040): for each the de-emphasis a and a^255 (float32
         square-and-multiply, as the kernel forms it), device time per
         call by torch.profiler (rounds of all, interleaved), the nodes of
         a CUDA graph of one call, F.conv1d's time for the dense front of the
         small-C rows (TF32 off), and the compiled flagship step's time
         a call (utils/compile.py, CUDA events). With a path, every
         output is saved there (torch.save), for
  back_end_quick: back_end's QUICK_BACK_END rows alone, two rounds, no
         outputs saved (tools/back_end_variants.py runs it in each tree).
  back_end_diff PARENT CHANGE: per path, whether each output of the two
         saves is equal (torch.equal) or its largest difference, the
         audio's of max|audio|, the de-emphasis state's of max(1,
         max|audio|). It uses only what every tree of the port with the
         bf16 chunked PFB front has, so it runs in the parent's tree too
         (copy this file into that tree's tools/).
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
    python3 tools/probe_grades.py compiled
    python3 tools/probe_grades.py dense
    python3 tools/probe_grades.py dense_mma
    python3 tools/probe_grades.py pfb
    python3 tools/probe_grades.py pfb_mma
    python3 tools/probe_grades.py back_end [OUT.pt]
    python3 tools/probe_grades.py back_end_quick
    python3 tools/probe_grades.py back_end_diff PARENT.pt CHANGE.pt
"""

import inspect
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
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


def digest(out):
    """A float64 checksum of every element of a kernel's outputs, weighted
    by position, so that two bit-equal outputs give equal digests."""
    leaves = cs.tree_leaves(out)
    return [float((x.double().flatten() * torch.arange(
        1, x.numel() + 1, device=x.device, dtype=torch.float64)).sum())
            for x in leaves]


def dense_f32_chunked():
    """(what, call) of the f32 dense launches on chip_smoke.py's chunked
    paths: B1 at long_filter, B3-dense at am_d128 (first block each) and
    B4 at the transmux's K=32, Q=127 on a first block behind its zero
    history."""
    m = cs.long_filter("cuda", precision="f32")
    buf = cs.buffer(m, cs.fm_signal(m, 0, cs.N, seed=11))
    n0, _, cf, cz = m.init()
    fm = (buf, m.tap_bank, m.lo_table, n0, m.decimation, m.gain, m.deemph,
          cf, cz)
    m = cs.am_d128("cuda", precision="f32")
    buf = cs.buffer(m, cs.am_signal(m, 0, cs.N, seed=11))
    am = (buf, m.tap_bank, m.lo_table, m.init()[0], m.decimation)
    k, q = cs.TMX_K, cs.TMX_LONG_Q
    taps = cs.lowpass64(q * k, 0.5 / k)
    bank = _analysis_tables(_taps_key(taps), k, "cuda")[0]
    rf = cs.grid_carriers(k, 0, cs.N)
    pad = torch.zeros((q - 1) * k, device="cuda")
    x = ComplexArray(torch.cat([pad, rf.re]), torch.cat([pad, rf.im]))
    return [("B1 long_filter", lambda: cs.fm_chain(*fm, precision="f32")),
            ("B3-dense am_d128", lambda: cs.am_chain(*am, precision="f32")),
            ("B4 transmux K=32, Q=127", lambda: channelize_kernel(
                x, bank, k, precision="f32"))]


def dense_mma_chunked():
    """(what, grade, call, library) of the bf16x3 and bf16x2 dense launches
    that take the chunked kernel on chip_smoke.py's phase-11 paths: B1 at
    the 2049-tap long filter and the narrowband scanner, B3-dense at
    am_d128 (first block each), B4 at the transmux's K=32, Q=127 (a first
    block behind its zero history), and fm_demod's B1 and am_demod's
    B3-dense at one channel, T=65, D=256 (T < D) on 2^20 samples; library,
    the same front by F.conv1d of the bank (TF32 off), as chip_smoke.py
    times it."""
    k, q = cs.TMX_K, cs.TMX_LONG_Q
    bank = _analysis_tables(_taps_key(cs.lowpass64(q * k, 0.5 / k)), k,
                            "cuda")[0]
    rf = cs.grid_carriers(k, 0, cs.N)
    pad = torch.zeros((q - 1) * k, device="cuda")
    x = ComplexArray(torch.cat([pad, rf.re]), torch.cat([pad, rf.im]))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    xo = ComplexArray(torch.randn(cs.N, generator=gen, device="cuda"),
                      torch.randn(cs.N, generator=gen, device="cuda"))
    d, taps = cs.OPS_WIDE_D, cs.OPS_TAPS
    fm_op = cs.fm_chain_args(xo, taps, cs.FS, -cs.OPS_FC,
                             cs.fm_demod_gain(cs.FS, cs.OPS_WIDE_DEV), d)
    am_op = cs.am_chain_args(xo, taps, cs.FS, -cs.OPS_FC, d)
    out = []
    for g in ("bf16x3", "bf16x2"):
        for what, make, signal in (
                ("B1 long_filter", cs.long_filter, cs.fm_signal),
                ("B1 nfm_scanner", cs.nfm_scanner, cs.nfm_signal)):
            m = make("cuda", precision=g)
            buf = cs.buffer(m, signal(m, 0, cs.N, seed=11))
            n0, _, cf, cz = m.init()
            args = (buf, m.tap_bank, m.lo_table, n0, m.decimation, m.gain,
                    m.deemph, cf, cz)
            out.append((what, g, lambda a=args, g=g:
                        cs.fm_chain(*a, precision=g),
                        cs.conv_library(buf, m.tap_bank, m.decimation)))
        m = cs.am_d128("cuda", precision=g)
        buf = cs.buffer(m, cs.am_signal(m, 0, cs.N, seed=11))
        args = (buf, m.tap_bank, m.lo_table, m.init()[0], m.decimation)
        out.append(("B3-dense am_d128", g, lambda a=args, g=g:
                    cs.am_chain(*a, precision=g),
                    cs.conv_library(buf, m.tap_bank, m.decimation)))
        out.append(("B4 transmux K=32, Q=127", g, lambda g=g:
                     channelize_kernel(x, bank, k, precision=g),
                     cs.conv_library(x, bank, k)))
        out.append(("B1 fm_demod D=256", g, lambda g=g:
                    cs.fm_chain(*fm_op, precision=g),
                    cs.conv_library(fm_op[0], fm_op[1], d)))
        out.append(("B3-dense am_demod D=256", g, lambda g=g:
                    cs.am_chain(*am_op, precision=g),
                    cs.conv_library(am_op[0], am_op[1], d)))
    return out


def dense(rounds=3):
    calls, forced = [], []
    for g in cs.GRADES:
        m = cs.flagship("cuda", precision=g)
        buf = cs.buffer(m, cs.fm_signal(m, 0, cs.N, seed=11))
        n0, _, cf, cz = m.init()
        args = (buf, m.tap_bank, m.lo_table, n0, m.decimation, m.gain,
                m.deemph, cf, cz)
        calls.append(("B1 flagship", g, lambda a=args, g=g:
                      cs.fm_chain(*a, precision=g)))
        m = cs.am_d("cuda", precision=g)
        buf = cs.buffer(m, cs.am_signal(m, 0, cs.N, seed=11))
        args = (buf, m.tap_bank, m.lo_table, m.init()[0], m.decimation)
        calls.append(("B3-dense am_d", g, lambda a=args, g=g:
                      cs.am_chain(*a, precision=g)))
        taps = cs.lowpass64(cs.TMX_Q * cs.TMX_K, 0.5 / cs.TMX_K)
        bank = _analysis_tables(_taps_key(taps), cs.TMX_K, "cuda")[0]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        x = ComplexArray(torch.randn(cs.N, generator=gen, device="cuda"),
                         torch.randn(cs.N, generator=gen, device="cuda"))
        calls.append(("B4 transmux K=32", g, lambda x=x, b=bank, g=g:
                      channelize_kernel(x, b, cs.TMX_K, precision=g)))
    taps = cs.lowpass64(8 * 16, 0.4 / 16)
    bank16 = _analysis_tables(_taps_key(taps), 16, "cuda")[0]
    calls.append(("B4 bench_pfb K=16", "f32", lambda x=x, b=bank16:
                  channelize_kernel(x, b, 16, precision="f32")))
    # the one-chunk launches forced into chunks (the chunked kernels, at
    # the f32 blocks and the bf16 blocks of the outputs' M): digests only
    for what, g, fn in calls:
        kernel = {"B1": cs.fm_chain, "B3": cs.am_chain}.get(
            what[:2], channelize_kernel)
        for tc in cs.FORCED_CHUNKS:
            forced.append((f"{what}, chunks of {tc}", g, lambda f=fn,
                           k=kernel, tc=tc: _forced(f, k, tc)))
    calls += [(what, "f32", fn) for what, fn in dense_f32_chunked()]
    mma = dense_mma_chunked()
    calls += [(what, g, fn) for what, g, fn, _ in mma]
    for what, g, fn in calls + forced:
        print(json.dumps({"probe": "dense_digest", "kernel": what,
                          "grade": g, "digest": digest(fn())}), flush=True)
    for r in range(rounds):
        for what, g, fn in calls:
            dev = cs.device_us(fn, reps=20)
            print(json.dumps({"probe": "dense", "round": r, "kernel": what,
                              "grade": g, "device_us": sum(dev.values()),
                              "by_kernel": dev}), flush=True)
        for what, g, _, library in mma:
            if g == "bf16x3":   # the library's time does not hang on it
                print(json.dumps({"probe": "dense_library", "round": r,
                                  "kernel": what, "library": "F.conv1d",
                                  "library_ms": cs.cuda_ms(library,
                                                           reps=20)}),
                      flush=True)


def dense_mma(rounds=3):
    """The bf16 chunked launches of dense_mma_chunked, each planned and,
    at bf16x3, forced to FORCED_MMA chunks (a chunk whose block does not
    fit says so): a digest of each planned output, then device time per
    call by torch.profiler, rounds of all, interleaved."""
    calls = dense_mma_chunked()
    kernels = {"B1": cs.fm_chain, "B3": cs.am_chain}
    for what, g, fn, _ in calls:
        print(json.dumps({"probe": "dense_mma_digest", "kernel": what,
                          "grade": g, "digest": digest(fn())}), flush=True)
    for r in range(rounds):
        for what, g, fn, _ in calls:
            runs = [(None, fn)]
            if g == "bf16x3":
                kernel = kernels.get(what[:2], channelize_kernel)
                runs += [(tc, lambda f=fn, k=kernel, tc=tc: _forced(f, k, tc))
                         for tc in FORCED_MMA.get(what, ())]
            for tc, f in runs:
                try:
                    dev = cs.device_us(f, reps=20)
                except RuntimeError as e:   # the forced block does not fit
                    print(json.dumps({"probe": "dense_mma", "kernel": what,
                                      "grade": g, "chunk": tc,
                                      "error": str(e)}), flush=True)
                    continue
                print(json.dumps({"probe": "dense_mma", "round": r,
                                  "kernel": what, "grade": g, "chunk": tc,
                                  "device_us": sum(dev.values())}),
                      flush=True)


# chunks dense_mma forces beside the plan: one block a SM and smaller
# chunks at the long filter (the plan: two blocks a SM), smaller ones at
# Q=127, am_d128 and the scanner
FORCED_MMA = {"B1 long_filter": (256, 512, 768),
              "B4 transmux K=32, Q=127": (64, 96, 136),
              "B3-dense am_d128": (128, 256, 384),
              "B1 nfm_scanner": (24, 32)}


def _forced(call, kernel, chunk):
    """call() with the kernel's launches forced to ``chunk`` taps a chunk
    (the wrappers' ``chunk`` argument, a test's knob)."""
    launch = kernel.launch
    kernel.launch = lambda *a, **kw: launch(*a, chunk=chunk, **kw)
    try:
        return call()
    finally:
        kernel.launch = launch


def tile_registers(reports):
    """{tile kernel<template arguments>: {registers, spill_stores,
    spill_loads}} of every tile kernel (fm_chain_tile, am_chain_tile,
    channelize_tile; the first argument 1 for the PFB front, then the
    grade and whether chunked) in the ptxas reports of build_all (bytes of
    spill stores and loads)."""
    out, entry = {}, None
    for line in "\n".join(reports.values()).splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d([a-z_]+_tile)I((?:L[bi]\d+E)+)E", line)
            entry = None
            if m:
                args = ",".join(re.findall(r"L[bi](\d+)E", m.group(2)))
                entry = f"{m.group(1)}<{args}>"
                out[entry] = {}
        elif entry and "spill stores" in line:
            out[entry]["spill_stores"] = int(
                line.split("bytes spill stores")[0].split(",")[-1])
            out[entry]["spill_loads"] = int(
                line.split("bytes spill loads")[0].split(",")[-1])
        elif entry and "registers" in line:
            out[entry]["registers"] = int(line.split("Used ")[1].split()[0])
            entry = None
    return out


def pfb_calls():
    """(what, grade, call, library) of each PFB launch the pfb probe times:
    B2 at FM wideband critical and at D=8 and B3-PFB at AM wideband
    critical (one chunk), pfb_nfm_lmr_320 (B2) and pfb_airband_480 (B3-PFB)
    on chip_smoke.py's first block, and the K=640, D=64, T=1280 and K=712,
    D=89, T=2848 witnesses (40 channels, B2 and B3-PFB), each grade;
    library, for the chunked paths, the same front by a grouped F.conv1d
    fold and one torch.matmul with the DFT bank, TF32 off (chip_smoke.py's
    pfb_front_library), else None."""
    calls = []
    for g in cs.GRADES:
        for d in (cs.GRID, 8):
            m = cs.fm_wideband("pfb", d, precision=g)
            buf = cs.buffer(m, cs.wideband_fm_signal(m, 0, cs.N, seed=11))
            calls.append((f"B2 FM wideband D={d}", g, m, buf, False))
        m = cs.am_wideband("pfb", precision=g)
        calls.append(("B3-PFB AM wideband", g, m,
                      cs.buffer(m, cs.am_signal(m, 0, cs.N, seed=11)), False))
        m = cs.pfb_nfm_lmr("pfb", precision=g)
        calls.append(("B2 pfb_nfm_lmr_320", g, m,
                      cs.buffer(m, cs.lmr_signal(m, 0, cs.PFB_N, seed=11)),
                      True))
        m = cs.pfb_airband("pfb", precision=g)
        calls.append(("B3-PFB pfb_airband_480", g, m,
                      cs.buffer(m, cs.air_signal(m, 0, cs.PFB_N, seed=11)),
                      True))
        for k, d, t in ((640, 64, 1280), (712, 89, 2848)):
            for cls, name in ((cs.FmChannelizer, "B2"),
                              (cs.AmReceiver, "B3-PFB")):
                m = cs.witness_model(cls, k, d, t, 40, g)
                calls.append((f"{name} witness K={k}", g, m, cs.buffer(
                    m, cs.witness_signal(m, 0, k * 1536)), True))
    out = []
    for what, g, m, buf, chunked in calls:
        fm = isinstance(m, cs.FmChannelizer)
        kernel = cs.pfb_fm_chain if fm else cs.pfb_am_chain
        args = cs.pfb_args(m, buf)
        out.append((what, g, lambda a=args, g=g, f=kernel:
                    f(*a, precision=g),
                    cs.pfb_front_library(m, buf) if chunked else None))
        if chunked:
            floors.append((what, g, m, buf.re.shape[-1], fm))
    return out


floors = []   # (what, grade, model, samples, fm) of pfb_calls' chunked paths


def pfb_floors():
    """Prints, for each chunked path of pfb_calls, its bound (chip_smoke's
    `bound`: bytes against the least operations) and, at a bf16 grade, the
    tensor-pass floor of its DFT-bank product alone (chip_smoke's
    `tensor_ops` at the dense bf16 peak)."""
    for what, g, m, nb, fm in floors:
        outputs = (nb - m.num_taps) // m.decimation + 1
        tensor = cs.tensor_ops(m, outputs, g)
        bnd = cs.bound(*(cs.fm_bound if fm else cs.am_bound)(m, nb, g))
        print(json.dumps({
            "probe": "pfb_floor", "kernel": what, "grade": g,
            "bound_us": bnd[0] * 1e3, "bound_by": bnd[1],
            "tensor_floor_us": (tensor[0] / cs.PEAK_BF16_FLOPS * 1e6
                                if tensor else None)}), flush=True)


def pfb(rounds=3):
    calls = pfb_calls()
    pfb_floors()
    for what, g, fn, _ in calls:
        print(json.dumps({"probe": "pfb_digest", "kernel": what,
                          "grade": g, "digest": digest(fn())}), flush=True)
    for r in range(rounds):
        for what, g, fn, library in calls:
            dev = cs.device_us(fn, reps=20)
            print(json.dumps({"probe": "pfb", "round": r, "kernel": what,
                              "grade": g, "device_us": sum(dev.values()),
                              "by_kernel": dev}), flush=True)
            if library is not None and g == "bf16x3":
                print(json.dumps({"probe": "pfb_library", "round": r,
                                  "kernel": what,
                                  "library": "grouped F.conv1d fold + "
                                             "torch.matmul, TF32 off",
                                  "library_ms": cs.cuda_ms(library,
                                                           reps=10)}),
                      flush=True)


# plans pfb_mma forces beside the planner's at the main paths' grids (a
# plan whose block does not fit says so)
FORCED_PFB = {"B2 pfb_nfm_lmr_320": ((16, 4), (24, 4), (32, 2)),
              "B3-PFB pfb_airband_480": ((16, 4), (24, 4), (32, 2))}


def pfb_mma(rounds=3):
    """pfb's chunked bf16 launches (the NFM and airband paths and the
    witnesses at bf16x3 and bf16x2), each planned and, at the main paths'
    grids, forced to FORCED_PFB plans: a digest of each planned output,
    then the tile kernel's device time per call by torch.profiler (the
    kernel whose name holds "tile"), rounds of all, interleaved: the quick
    timing of a variant of the front (tools/pfb_variants.py runs it in
    each variant's tree)."""
    calls = [(what, g, fn) for what, g, fn, library in pfb_calls()
             if library is not None and g != "f32"]
    for what, g, fn in calls:
        print(json.dumps({"probe": "pfb_mma_digest", "kernel": what,
                          "grade": g, "digest": digest(fn())}), flush=True)
    kernels = {"B2": cs.pfb_fm_chain, "B3": cs.pfb_am_chain}
    for r in range(rounds):
        for what, g, fn in calls:
            runs = [(None, fn)] + [
                (p, lambda f=fn, k=kernels[what[:2]], p=p: _planned(f, k, p))
                for p in FORCED_PFB.get(what, ())]
            for plan, f in runs:
                try:
                    dev = cs.device_us(f, reps=20)
                except RuntimeError as e:   # the forced block does not fit
                    print(json.dumps({"probe": "pfb_mma", "kernel": what,
                                      "grade": g, "plan": plan,
                                      "error": str(e)}), flush=True)
                    continue
                print(json.dumps({
                    "probe": "pfb_mma", "round": r, "kernel": what,
                    "grade": g, "plan": plan,
                    "tile_us": sum(v for k, v in dev.items() if "tile" in k),
                    "device_us": sum(dev.values())}), flush=True)


def _planned(call, kernel, plan):
    """call() with the PFB kernel's launches forced to ``plan`` (the
    wrappers' ``plan`` argument, a test's knob)."""
    launch = kernel.launch
    kernel.launch = lambda *a, **kw: launch(*a, plan=plan, **kw)
    try:
        return call()
    finally:
        kernel.launch = launch


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


def compiled():
    from gsdr_tpu_torch.utils.compile import compile_step, signature
    from gsdr_tpu_torch.utils.timing import time_step
    from gsdr_tpu_torch.utils.tree import tree_flatten

    paths = {p[0]: p for p in cs.compiled_paths(None)
             if p[0] in ("flagship_bf16x3", "qpsk256_rx", "stream_fm")}
    for name, step, state0, blocks, _, _, _ in paths.values():
        block = blocks[0]
        run = compile_step(step)
        state, out = run(state0, block)
        graph = run._graph(state, block)[0]
        s_leaves, b_leaves = tree_flatten(state)[0], tree_flatten(block)[0]
        st_e, st_c = state0, state

        def eager():
            nonlocal st_e
            st_e, _ = step(st_e, block)

        def call():
            nonlocal st_c
            st_c, _ = run(st_c, block)

        def copy_block():
            for buf, leaf in zip(graph.block_in, b_leaves):
                buf.copy_(leaf)

        outs = tree_flatten(out)[0]
        print(json.dumps({
            "probe": "compiled_call", "path": name,
            "eager_host_us": host_us(eager), "eager_ms": cs.cuda_ms(
                eager, reps=REPS),
            "compiled_host_us": host_us(call),
            "compiled_ms": cs.cuda_ms(call, reps=REPS),
            "signature_host_us": host_us(lambda: signature(st_c, block)),
            "block_copy_host_us": host_us(copy_block),
            "replay_host_us": host_us(graph.graph.replay),
            "out_clone_host_us": host_us(lambda: [x.clone() for x in outs]),
            "graph_20_step_ms": time_step(step, state0, block, iters=20,
                                          reps=5) * 1e3,
            "state_leaves": len(s_leaves), "card": cs.CARD}), flush=True)


def _ipow32(a, k):
    """a^k as the FM kernel's ipow forms it: float32 square-and-multiply."""
    r, b = torch.tensor(1.0), torch.tensor(float(a))
    while k:
        if k & 1:
            r = r * b
        b = b * b
        k >>= 1
    return float(r)


def _carriers(model, n, seed=7):
    """FM carriers on the model's channels, 0.35 rad of tone each, made on
    the card in float64."""
    phases = np.random.default_rng(seed).uniform(0, 6, model.num_channels)
    t = torch.arange(n, dtype=torch.float64, device="cuda") / \
        model.sample_rate
    re = torch.zeros(n, dtype=torch.float64, device="cuda")
    im = torch.zeros_like(re)
    for k, f in enumerate(model.channel_frequencies):
        msg = torch.sin(2 * np.pi * (700.0 + 370.0 * k) * t + phases[k])
        ph = 2 * np.pi * (f - model.tuning_frequency) * t + 0.35 * msg
        re += torch.cos(ph) / model.num_channels
        im += torch.sin(ph) / model.num_channels
    return ComplexArray(re.float(), im.float())


def back_end_calls():
    """(what, grade, call, de-emphasis a, library or None) of each FM
    chain launch the back_end probe times."""
    from gsdr_tpu_torch.examples.fm_broadcast_rx import lowpass as bc_lp
    from gsdr_tpu_torch.tools.fm_rx import design_lowpass

    calls = []

    def dense(what, m, g, rf, library=False):
        buf = cs.buffer(m, rf)
        n0, _, cf, cz = m.init()
        args = (buf, m.tap_bank, m.lo_table, n0, m.decimation, m.gain,
                m.deemph, cf, cz)
        calls.append((what, g, lambda: cs.fm_chain(*args, precision=g),
                      float(m.deemph[2]),
                      cs.conv_library(buf, m.tap_bank, m.decimation)
                      if library else None))

    for g in cs.GRADES:
        m = cs.flagship("cuda", precision=g)
        dense("B1 flagship", m, g, cs.fm_signal(m, 0, cs.N, seed=11))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    t = torch.arange(cs.N, device="cuda", dtype=torch.float64) / cs.FS
    ph = (2 * np.pi * cs.OPS_FC * t + (cs.OPS_DEV / cs.OPS_TONE)
          * torch.sin(2 * np.pi * cs.OPS_TONE * t))
    x = ComplexArray(torch.cos(ph).float(), torch.sin(ph).float())
    op = cs.fm_chain_args(x, cs.OPS_TAPS, cs.FS, -cs.OPS_FC,
                          cs.fm_demod_gain(cs.FS, cs.OPS_DEV), cs.OPS_D)
    calls.append(("B1 fm_demod C=1, T=65, D=4", "bf16x3",
                  lambda: cs.fm_chain(*op, precision="bf16x3"),
                  float(op[6][2]),
                  cs.conv_library(op[0], op[1], cs.OPS_D)))
    m = cs.FmChannelizer(
        sample_rate=cs.RX_FS, tuning_frequency=0.0,
        channel_frequencies=cs.RX_STATIONS, frequency_deviation=75e3,
        decimation=8, low_pass_taps=design_lowpass(129, 0.4 / 8),
        deemphasis_tau=75e-6, device="cuda")
    dense("B1 fm_rx C=5, T=129, D=8", m, "bf16x3", _carriers(m, cs.N), True)
    m = cs.FmChannelizer(
        sample_rate=2_000_000.0, tuning_frequency=0.0,
        channel_frequencies=(-400_000.0, 0.0, 500_000.0),
        frequency_deviation=75_000.0, decimation=8,
        low_pass_taps=bc_lp(128, 0.05), device="cuda")
    dense("B1 fm_broadcast_rx C=3, T=128, D=8", m, "bf16x3",
          _carriers(m, cs.N), True)
    m = cs.long_filter("cuda", precision="bf16x3")
    dense("B1 long_filter (chunked)", m, "bf16x3",
          cs.fm_signal(m, 0, cs.N, seed=11))
    for what, m, rf in (
            ("B2 FM wideband D=64", cs.fm_wideband("pfb", cs.GRID), None),
            ("B2 FM wideband D=8", cs.fm_wideband("pfb", 8), None),
            ("B2 pfb_nfm_lmr_320 (chunked)", cs.pfb_nfm_lmr("pfb"), 1)):
        rf = (cs.lmr_signal(m, 0, cs.PFB_N, seed=11) if rf
              else cs.wideband_fm_signal(m, 0, cs.N, seed=11))
        args = cs.pfb_args(m, cs.buffer(m, rf))
        calls.append((what, "bf16x3", lambda a=args:
                      cs.pfb_fm_chain(*a, precision="bf16x3"),
                      float(m.deemph[2]), None))
    return calls


# the back_end_quick rows: the flagship at bf16x3 and f32, fm_rx, the
# long filter and B2 at D=8 (tools/back_end_variants.py's probe)
QUICK_BACK_END = ("B1 flagship bf16x3", "B1 flagship f32",
                  "B1 fm_rx C=5, T=129, D=8 bf16x3",
                  "B1 long_filter (chunked) bf16x3",
                  "B2 FM wideband D=8 bf16x3")


def back_end(out=None, rounds=3, quick=False):
    from gsdr_tpu_torch.utils.compile import compile_step

    calls = back_end_calls()
    if quick:
        calls = [c for c in calls if f"{c[0]} {c[1]}" in QUICK_BACK_END]
    saved = {}
    # the nodes of a CUDA graph of one call (chip_smoke.graph_nodes; none
    # in an older tree, whose FM call was three grid launches)
    nodes = getattr(cs, "graph_nodes", None)
    for what, g, fn, a, _ in calls:
        a255 = _ipow32(a, 255)
        res = fn()
        saved[f"{what} {g}"] = [x.cpu() for x in cs.tree_leaves(res)]
        print(json.dumps({"probe": "back_end_path", "kernel": what,
                          "grade": g, "a": a, "a255": a255,
                          "exact": a255 == 0.0,
                          "graph_nodes_per_call":
                              nodes(fn)[0] if nodes else None,
                          "digest": digest(res)}), flush=True)
    if out:
        torch.save(saved, out)
    if quick:
        for r in range(rounds):
            for what, g, fn, _, _ in calls:
                dev = cs.device_us(fn, reps=20)
                print(json.dumps({"probe": "back_end", "round": r,
                                  "kernel": what, "grade": g,
                                  "device_us": sum(dev.values())}),
                      flush=True)
        return
    m = cs.flagship("auto")
    block = cs.fm_signal(m, 0, cs.N, seed=11)
    run = compile_step(m.step)
    state = run(m.init(), block)[0]

    def step():
        nonlocal state
        state, _ = run(state, block)

    for r in range(rounds):
        for what, g, fn, _, library in calls:
            dev = cs.device_us(fn, reps=20)
            line = {"probe": "back_end", "round": r, "kernel": what,
                    "grade": g, "device_us": sum(dev.values()),
                    "by_kernel": dev}
            if library is not None:
                line.update({"library": "F.conv1d, TF32 off",
                             "library_ms": cs.cuda_ms(library, reps=20)})
            print(json.dumps(line), flush=True)
        print(json.dumps({"probe": "back_end_compiled", "round": r,
                          "path": "flagship bf16x3",
                          "compiled_ms": cs.cuda_ms(step, reps=20)}),
              flush=True)


def back_end_diff(parent, change):
    a, b = torch.load(parent), torch.load(change)
    for what in a:
        want, got = a[what], b[what]
        scale = float(want[0].abs().max())
        diffs = [float((x - y).abs().max()) for x, y in zip(got, want)]
        print(json.dumps({
            "probe": "back_end_diff", "kernel": what,
            "equal": all(torch.equal(x, y) for x, y in zip(got, want)),
            "audio_vs_max": diffs[0] / scale,
            "zf_vs_max1": diffs[-1] / max(1.0, scale),
            "carry_f": diffs[1:-1]}), flush=True)


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
    if len(sys.argv) == 4 and sys.argv[1] == "back_end_diff":
        back_end_diff(sys.argv[2], sys.argv[3])
        return 0
    if not torch.cuda.is_available() or not (
            len(sys.argv) == 2 or sys.argv[1:2] == ["back_end"]) \
            or len(sys.argv) > 3 \
            or sys.argv[1] not in ("steps", "b4", "b5b6", "fm_rx",
                                   "compiled", "dense", "dense_mma", "pfb",
                                   "pfb_mma", "back_end", "back_end_quick"):
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
    elif sys.argv[1] in ("back_end", "back_end_quick"):
        reports = _build.build_all(["fm_chain"])
        print(json.dumps({"probe": "back_end_registers",
                          "registers": tile_registers(reports)}), flush=True)
        if sys.argv[1] == "back_end_quick":
            back_end(rounds=2, quick=True)
        else:
            back_end(sys.argv[2] if len(sys.argv) == 3 else None)
    elif sys.argv[1] == "compiled":
        _build.build_all(["fm_chain", "iir", "qpsk256"])
        compiled()
    elif sys.argv[1] == "dense":
        reports = _build.build_all(["fm_chain", "am_chain", "channelize"])
        print(json.dumps({"probe": "dense_registers",
                          "registers": tile_registers(reports)}), flush=True)
        dense()
    elif sys.argv[1] == "dense_mma":
        reports = _build.build_all(["fm_chain", "am_chain", "channelize"])
        print(json.dumps({"probe": "dense_registers",
                          "registers": tile_registers(reports)}), flush=True)
        dense_mma()
    elif sys.argv[1] in ("pfb", "pfb_mma"):
        reports = _build.build_all(["fm_chain", "am_chain", "channelize"])
        print(json.dumps({"probe": "pfb_registers",
                          "registers": tile_registers(reports)}), flush=True)
        pfb() if sys.argv[1] == "pfb" else pfb_mma()
    else:
        _build.build_all(["channelize", "fm_chain"])
        steps() if sys.argv[1] == "steps" else b4()
    return 0


if __name__ == "__main__":
    sys.exit(main())
