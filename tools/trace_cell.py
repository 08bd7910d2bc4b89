"""Readings of the port's own tracing (gsdr_tpu_torch/utils/profiling.py)
in one cell of the benchmark (BENCHMARK.json, sdr_bench/), on one NVIDIA
GPU.

Builds the cell's receiver, ring (from --seed) and block stream as the
benchmark's harness does, and steps them through four stretches of the
mix's trace_blocks blocks each, every stretch after a few blocks of its
own warm-up (where a new graph is captured, outside what is read):

  1. untraced, and 2. with spans on: the median host microseconds of a
     call (the harness's call_host_us), so the cost of the spans;
  3. with spans on under the profiler: the spans mapped onto the trace's
     clock (profiling.clock_map: each compiled.replay span around its
     cudaGraphLaunch), the share of replay spans that enclose their
     launch, and the window's longest idle gaps named by the innermost
     span open at their start (named_gaps);
  4. with spans and device counters on (the counted graph): the
     compiled call's parts and the chain kernels' waits (values), the
     device-counted launches and look-back polls a block, and beside them
     the row tile the chunked PFB front took and its blocks a launch
     (engagement).

Prints its notes on standard error and one JSON line of the readings on
standard output. Usage, from the repository root:
    python3 tools/trace_cell.py --workload nfm320.capture --seed 7
"""

import argparse
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WARM = 3               # blocks before a stretch: a new graph's capture
TOP_GAPS = 10
WINDOW_EDGE = "window edge"
# (reading, counter, the counter it is a share of)
SHARES = (("front_share_pct", "front_clocks", "block_clocks"),
          ("fold_wait_pct", "full_wait_clocks", "consumer_front_clocks"),
          ("product_wait_pct", "free_wait_clocks", "producer_front_clocks"),
          ("stage_wait_pct", "stage_wait_clocks", "producer_front_clocks"),
          ("lookback_wait_pct", "poll_clocks", "block_clocks"))


def values(spans, counters):
    """{reading: value} from a stretch's spans (``profiling.Span``) and
    its kernels' counters ({kernel: {counter: count}}), without those it
    has nothing for: the medians over the calls of ``compiled.lookup``,
    of ``compiled.copy_in`` plus ``compiled.clone`` and of
    ``compiled.replay`` (us), and the counters' shares (``SHARES``, %)."""
    calls = {}
    for sp in spans:
        if sp.call and sp.end:
            parts = calls.setdefault(sp.call, {})
            parts[sp.name] = parts.get(sp.name, 0) + sp.end - sp.start
    calls = [c for c in calls.values() if "compiled.replay" in c]
    out = {}
    if calls:
        def median_us(part):
            return statistics.median(part(c) for c in calls) / 1e3

        out["lookup_host_us"] = median_us(lambda c: c["compiled.lookup"])
        out["copy_host_us"] = median_us(
            lambda c: c["compiled.copy_in"] + c["compiled.clone"])
        out["replay_host_us"] = median_us(lambda c: c["compiled.replay"])
    total = {}
    for got in counters.values():
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    for name, part, whole in SHARES:
        if total.get(whole) and part in total:
            out[name] = 100.0 * total[part] / total[whole]
    return out


def engagement(counters, wrappers):
    """{reading: value} of the chunked bf16 PFB front's row tile
    (csrc/fronts.cuh, pfb_mma_rows): each counted kernel's blocks a launch
    ({kernel: {counter: count}}: the grid its launches took), and the rows
    of the blocks each wrapper's chunked launches took (``ChainKernel``'s
    ``row_tiles``, counted at a graph's capture, not its replays), for
    those that have any."""
    out = {}
    for kernel, got in counters.items():
        if got.get("launches"):
            out[f"{kernel}.blocks_a_launch"] = got["blocks"] / got["launches"]
    for name, wrapper in wrappers.items():
        took = [r for r, n in getattr(wrapper, "row_tiles", {}).items() if n]
        if took:
            out[f"{name}.row_tiles"] = took
    return out


def named_gaps(busy, window, runtime, spans, offset_us, top=TOP_GAPS):
    """[(what the host was in at the gap's start, gap us)] of the window's
    longest idle gaps, longest first: ``WINDOW_EDGE`` for a gap at the
    window's start or end (its marker launches and final synchronise);
    else the innermost program span open then (``span <name>``, the spans
    mapped by ``offset_us``); else the CUDA runtime call open then; else
    the host outside both (``sdr_bench.trace.HOST_IDLE``)."""
    from sdr_bench import trace

    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    gaps = sorted(((a, b - a) for a, b in zip(edges[::2], edges[1::2])
                   if b > a), key=lambda g: -g[1])
    mapped = [(sp.start / 1e3 + offset_us, sp.end / 1e3 + offset_us,
               sp.name) for sp in spans if sp.end]
    out = []
    for a, length in gaps[:top]:
        inner = [s for s in mapped if s[0] <= a < s[1]]
        open_ = [r for r in runtime if r.ts <= a < r.end]
        if a == window[0] or a + length == window[1]:
            what = WINDOW_EDGE
        elif inner:
            what = "span " + max(inner)[2]
        elif open_:
            what = f"host in {open_[0].name}"
        else:
            what = trace.HOST_IDLE
        out.append((what, length))
    return out


def run(name, seed, log):
    """The four stretches of the cell ``name``; returns its readings."""
    import torch

    from gsdr_tpu_torch.utils import profiling
    from sdr_bench import drive, registry, trace
    from sdr_bench.harness import TRACE_WARM_BLOCKS

    cell = registry.Cell(name, ROOT)
    cfg, traffic, kind, entry = cell.config, cell.traffic, cell.kind, \
        cell.entry
    device = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = kind.block_samples(cfg, traffic)
    model = entry.build(cfg, kind.design(cfg), device, cfg["precision"])
    ring = kind.make_ring(cfg, traffic, n, seed, device)
    stream = drive.Stream(entry.step(model), model.init(), ring, entry.block,
                          traffic, device, seed, 0)
    blocks = int(traffic["trace_blocks"])
    out = {"workload": name, "seed": seed,
           "card": torch.cuda.get_device_name(device)}

    def host_us(stretch):
        return statistics.median(stretch.calls) * 1e6

    stream.run(lambda i, t: i >= WARM)
    out["call_host_us.untraced"] = host_us(
        stream.run(lambda i, t: i >= blocks))
    with profiling.tracing(profiling.SPANS) as rec:
        stream.run(lambda i, t: i >= WARM)
        out["call_host_us.spans"] = host_us(
            stream.run(lambda i, t: i >= blocks))
        log("spans stretch: graphs captured",
            rec.counts["compiled.capture"])

    with profiling.tracing(profiling.SPANS) as rec:
        _, records, runtime, window = trace.profile_stretch(
            stream, blocks, TRACE_WARM_BLOCKS)
    spans = rec.spans()
    fit = profiling.clock_map(spans, [(r.name, r.ts, r.dur)
                                      for r in runtime])
    log(f"profiler stretch: graphs captured {rec.counts['compiled.capture']}"
        f", spans dropped {rec.dropped}; clock map {fit}")
    if fit is not None:
        out["replay_enclosed"] = fit.enclosed
        out["clock_residual_us"] = fit.residual_us
        gaps = named_gaps(trace.union(records, window), window, runtime,
                          spans, fit.offset_us)
        out["idle_gaps_us"] = [[what, us] for what, us in gaps]

    with profiling.tracing(profiling.COUNTERS) as rec:
        stream.run(lambda i, t: i >= WARM)
        captured = rec.counts["compiled.capture"]
        rec.clear()
        counted = stream.run(lambda i, t: i >= blocks)
        spans, counters = rec.spans(), rec.counters()
        log(f"counted stretch: graphs captured {captured} in its warm-up, "
            f"{rec.counts['compiled.capture']} in its {counted.blocks} "
            f"blocks; spans dropped {rec.dropped}")
    for kernel, got in counters.items():
        out[f"{kernel}.launches_a_block"] = got["launches"] / counted.blocks
        if "polls" in got:
            out[f"{kernel}.polls_a_block"] = got["polls"] / counted.blocks
        log(f"{kernel} counters: {got}")
    out.update(values(spans, counters))
    rows = engagement(counters, entry.counters())
    log(f"row tile and grid: {rows}")
    out.update(rows)
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    # the benchmark's build and kernel caches, inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ.setdefault(var, str(ROOT / "build" / "sdr_bench" / sub))
    sys.path.insert(0, str(ROOT))

    def log(*parts):
        print(*parts, file=sys.stderr, flush=True)

    print(json.dumps(run(args.workload, args.seed, log)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
