"""Run one cell once: set-up, the measured window (or, with ``--trace
1``, the traced stretch), then the comparison with the plain receiver,
and one JSON line of results.

Set-up (``setup_s``, from the command's start): torch and the card, the
one nvcc source of the cell's receiver (built once into the checkout's
``build/``), the receiver and its tables, the ring synthesised on the
card from the seed, and ``WARM_BLOCKS`` blocks through the compiled step,
the first of which captures its CUDA graph. Only the cell's own block
shape is warmed. In a run that builds, the nvcc build is part of
set-up (``build_s`` on standard error); in one that finds the library
built it costs a look at the file.

``--trace 0``: blocks back to back for ``--seconds``; ``input_msps`` is
every input sample stepped over the host's seconds from the first call to
the synchronise after the last completion, ``block_ms_p95`` the 95th
percentile of the blocks' completion-to-completion times on the card.
``--trace 1``: ``span_blocks`` blocks with the host's time of each call,
then ``trace_blocks`` under the profiler; the per-layer metrics read
those (``metrics/``).

The cell's kind (``kinds/``) designs what both sides are handed, makes
the ring from the seed and computes the numbers compared; the harness
adds the host copies' and holds each to the configuration's limit.
"""

import argparse
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from sdr_bench import check, drive, registry, roofline, trace

# top-level module names that no run may have loaded: JAX and the JAX
# package (compared whole: gsdr_tpu_torch is the program)
FORBIDDEN = ("jax", "jaxlib", "flax", "gsdr_tpu", "benchmarks", "bench")
_CARD_QUERY = ("name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,"
               "temperature.gpu,power.draw")
WARM_BLOCKS = 3          # set-up's blocks: the first captures the graph
CHECK_BLOCKS = 16        # sampled blocks of the window compared
TRACE_WARM_BLOCKS = 20   # traced blocks before the window (profiler start)


_T0 = [time.perf_counter()]


def log(*parts):
    print(f"[{time.perf_counter() - _T0[0]:8.3f}]", *parts, file=sys.stderr,
          flush=True)


class CardInfo:
    """nvidia-smi's reading of the card (name, power limit, clocks, power
    draw), taken in a process of its own while the set-up goes on."""

    def __init__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={_CARD_QUERY}",
                 "--format=csv,noheader"], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            self.error = None
        except OSError as e:
            self.proc, self.error = None, e

    def read(self):
        if self.proc is None:
            return f"nvidia-smi unavailable ({self.error})"
        try:
            return self.proc.communicate(timeout=30)[0].strip()
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            return "nvidia-smi gave no reading in 30 s"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _finite(x):
    return x if isinstance(x, int) or math.isfinite(x) else None


def _stats(st):
    """The stretch's block times (ms) and host seconds a call and a wait,
    for the run's notes."""
    ms = np.asarray(st.block_ms)
    q = [float(x) for x in np.percentile(ms, [50, 95, 99])]
    return (f"block ms mean {float(ms.mean())!r} median {q[0]!r} p95 "
            f"{q[1]!r} p99 {q[2]!r} max {float(ms.max())!r}; host us a call "
            f"{1e6 * float(np.mean(st.calls))!r}, a wait "
            f"{1e6 * float(np.mean(st.waits or [0.0]))!r}, an audio copy "
            f"{1e6 * float(np.mean(st.copies or [0.0]))!r}")


def _launches(counters):
    return {k: c.launches for k, c in counters.items()}


def _setup(cell, seed, device, grade, t0):
    """Build the cell's receiver, its ring and its compiled step, and
    warm the block shape; returns (design, block samples, entry, ring,
    stream, setup seconds)."""
    cfg, traffic, kind = cell.config, cell.traffic, cell.kind
    card_info = CardInfo() if device.type == "cuda" else None
    entry = cell.entry
    log("entry loaded")
    if card_info is not None and entry.LIBRARY:
        from gsdr_tpu_torch.kernels._build import build_all

        b0 = time.perf_counter()
        built = build_all([entry.LIBRARY])
        log(f"build_s {time.perf_counter() - b0!r} (compiled: "
            f"{sorted(built) or 'none, already built'})")
    design = kind.design(cfg)
    n = kind.block_samples(cfg, traffic)
    model = entry.build(cfg, design, device, grade or cfg["precision"])
    log(f"receiver built: {n} samples a block, seed {seed}, route",
        entry.route(model))
    ring = kind.make_ring(cfg, traffic, n, seed, device)
    log(f"ring: {ring[0].shape[0]} blocks, "
        f"{sum(p.numel() * p.element_size() for p in ring) / 1e6:.1f} MB")
    counters = entry.counters()
    before = _launches(counters)
    stream = drive.Stream(entry.step(model), model.init(), ring,
                          entry.block, traffic, device, seed, CHECK_BLOCKS)
    stream.run(lambda i, t: i >= WARM_BLOCKS)
    after = _launches(counters)
    log("launches in warm-up and capture:",
        {k: after[k] - before[k] for k in after})
    setup_s = time.perf_counter() - t0
    log(f"setup_s {setup_s!r}")
    if card_info is not None:
        log("card:", card_info.read())
    return design, n, entry, ring, stream, setup_s


def _window(cell, stream, n, seconds, setup_s):
    """The measured window: (blocks, end-to-end metrics)."""
    st = stream.run(lambda i, t: t >= seconds)
    log(f"window: {st.blocks} blocks in {st.seconds!r} s;", _stats(st))
    values = {"input_msps": st.blocks * n / st.seconds / 1e6,
              "block_ms_p95": float(np.percentile(st.block_ms, 95)),
              "setup_s": setup_s}
    return st.blocks, {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end()}


def _traced(cell, stream, n, device, grade):
    """The untraced span stretch and the traced stretch: (blocks,
    per-layer metrics, the device's busy and window seconds, the
    breakdown)."""
    traffic = cell.traffic
    spans = stream.run(lambda i, t: i >= int(traffic["span_blocks"]))
    log("untraced stretch:", _stats(spans))
    prof, records, runtime, window = trace.profile_stretch(
        stream, int(traffic["trace_blocks"]), TRACE_WARM_BLOCKS)
    log("traced stretch:", _stats(prof))
    card = roofline.peaks(torch.cuda.get_device_name(device)) \
        if device.type == "cuda" else None
    bound = None
    if card is not None:
        work = cell.work.counts(cell.config, n,
                                grade or cell.config["precision"])
        bound, by = roofline.bound_s(work, card)
        log(f"roofline: {bound * 1e6!r} us a block, bound by {by}")
    ctx = trace.Context(cell, records, window, prof.blocks, spans.calls,
                        bound, lambda m: cell.module("metrics", m))
    metrics = {}
    for m in cell.per_layer():
        v = ctx.value(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    busy = {"busy_s": ctx.busy_us() * 1e-6, "window_s": ctx.window_us * 1e-6}
    return (spans.blocks + prof.blocks, metrics, busy,
            trace.breakdown(records, trace.union(records, window), window,
                            runtime))


def run_cell(name, seed, seconds, traced, root=registry.ROOT,
             device="cuda", grade=None, t0=None):
    """Run one cell once; returns (result line as a dict, numbers
    compared). ``grade`` replaces the configuration's precision (the
    control's lower grade); no benchmark run passes it."""
    t0 = time.perf_counter() if t0 is None else t0
    _T0[0] = t0
    cell = registry.Cell(name, root)
    device = torch.device(device)
    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    design, n, entry, ring, stream, setup_s = _setup(cell, seed, device,
                                                     grade, t0)
    stream.sampling = True
    busy, breakdown = {}, None
    if traced:
        attempted, metrics, busy, breakdown = _traced(cell, stream, n,
                                                      device, grade)
    else:
        attempted, metrics = _window(cell, stream, n, seconds, setup_s)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    # the program's outputs and final state, then the program freed
    outputs = dict(stream.kept)
    outputs[stream.last[0]] = stream.last[1]
    final = entry.final_state(stream.state)
    host_mismatch = (stream.host.mismatches() if stream.host is not None
                     else None)
    total = stream.position
    del stream, entry
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    numbers, failed = cell.kind.compare(cell.config, design, cell.reference,
                                        ring, n, outputs, final, total)
    if host_mismatch is not None:
        numbers["host_copy_mismatch"] = host_mismatch
    numbers, failed = check.judge(numbers, cell.config["limits"], failed)
    log(f"reference: {len(outputs)} blocks in "
        f"{time.perf_counter() - r0!r} s")
    result = {"correct": check.passed(numbers), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if on_card else "cpu"),
                         "count": 1, "memory_peak_bytes": int(memory_peak),
                         **busy}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": _finite(v), "limit": lim}
                       for k, (v, lim) in numbers.items()}
    return result, numbers


def main(argv, t0):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = registry.Cell(args.workload)
    _T0[0] = t0
    log("torch imported")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        log(f"cell {args.workload} needs {cell.chips} CUDA device(s); "
            f"this machine has {have}: no result")
        return 2
    torch.set_num_threads(1)
    torch.cuda.init()
    log("CUDA initialised")
    result, numbers = run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), t0=t0)
    bad = forbidden_modules()
    if bad:
        log(f"loaded modules of JAX or the JAX package: {bad}; no result")
        return 3
    for k, (v, lim) in numbers.items():
        log(f"check {k} {v!r} limit {lim!r}")
    print(json.dumps(result), flush=True)
    return 0
