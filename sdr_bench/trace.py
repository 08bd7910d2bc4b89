"""The traced stretch: blocks stepped under ``torch.profiler``, and what
the per-layer metrics read from it.

The profiler records device activity alone (kernels, copies, memsets,
and the host's CUDA runtime calls that CUPTI reports with them): the
host's own operator records would double a host-bound cell's host time
and misstate its card's idle share. The window is bounded on the card by
two marker kernels (``torch.cuda._sleep``) that the harness launches
before the window's first block and after its last block has completed.
The trace is written as Chrome JSON to a temporary file (under
``TMPDIR``), read back and removed.
"""

import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = re.compile(r"spin_kernel")
MARKER_CYCLES = 1000
HOST_IDLE = "host outside CUDA calls"


# a stream's device records may sum to this share of the window before
# the trace counts as wrong (records counted twice read 2x; the clocks of
# the records and the window differ by a percent or so)
OVER_WINDOW = 1.02


class Record:
    __slots__ = ("name", "cat", "ts", "dur", "stream")

    def __init__(self, name, cat, ts, dur, stream=None):
        self.name, self.cat, self.ts, self.dur = name, cat, ts, dur
        self.stream = stream

    @property
    def end(self):
        return self.ts + self.dur


def _marker():
    import torch

    torch.cuda._sleep(MARKER_CYCLES)
    torch.cuda.synchronize()


def profile_stretch(stream, blocks, warm):
    """Step ``warm`` blocks, then ``blocks`` blocks in the window, of
    ``stream`` under the profiler (the warm blocks take the profiler's
    own start-up out of the window); returns (Stretch, device records in
    the window, the host's CUDA runtime calls, (window start, end) us)."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    if stream.device.type != "cuda":
        # no device to trace: the stretch runs, and the window holds no
        # device record (a CPU rehearsal of the run's flow)
        stream.run(lambda i, t: i >= warm)
        stretch = stream.run(lambda i, t: i >= blocks)
        return stretch, [], [], (0.0, stretch.seconds * 1e6)
    # an empty profile first: it takes whatever an earlier one left
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        stream.run(lambda i, t: i >= warm)
        _marker()
        stretch = stream.run(lambda i, t: i >= blocks)
        _marker()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    device, runtime = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        rec = Record(e.get("name", ""), e.get("cat", ""), float(e["ts"]),
                     float(e.get("dur", 0.0)),
                     (e.get("args") or {}).get("stream"))
        if rec.cat in DEVICE_CATS:
            device.append(rec)
        elif rec.cat == "cuda_runtime":
            runtime.append(rec)
    marks = sorted((r for r in device if MARKER.search(r.name)),
                   key=lambda r: r.ts)
    if len(marks) < 2:
        raise RuntimeError(f"the trace holds {len(marks)} of the window's "
                           "two marker kernels")
    window = (marks[-2].end, marks[-1].ts)
    device = [r for r in device if r.end > window[0] and r.ts < window[1]]
    check_records(device, window)
    return stretch, device, runtime, window


def check_records(device, window):
    """Raise where the window holds no device record, or where one
    stream's records sum to more than the window: a trace that lost its
    records or holds some twice."""
    if not device:
        raise RuntimeError("the traced window holds no device record")
    per_stream = {}
    for r in device:
        per_stream[r.stream] = per_stream.get(r.stream, 0.0) + r.dur
    span = window[1] - window[0]
    for stream, us in per_stream.items():
        if us > OVER_WINDOW * span:
            raise RuntimeError(
                f"the device records of stream {stream} sum to {us:.1f} us "
                f"in a window of {span:.1f} us: the trace is wrong")


def union(records, window):
    """Merged (start, end) intervals of the records, clipped to window."""
    out = []
    for a, b in sorted((max(r.ts, window[0]), min(r.end, window[1]))
                       for r in records):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(busy, window, runtime):
    """[(what the host was doing at the gap's start, gap us)], longest
    first: the CUDA runtime call it was in, else HOST_IDLE."""
    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    gaps = [(a, b - a) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps.sort(key=lambda g: -g[1])
    out = []
    for a, length in gaps[:10]:
        open_ = [r for r in runtime if r.ts <= a < r.end]
        out.append((f"host in {open_[0].name}" if open_ else HOST_IDLE,
                    length))
    return out


def short_name(name, width=96):
    """A kernel's name without its argument list, at most ``width``."""
    return re.sub(r"\((?!anonymous namespace\)).*$", "", name)[:width] \
        or name[:width]


def breakdown(device, busy, window, runtime, top=10):
    """The ``breakdown`` of a traced run: device operations by total
    seconds, and the longest idle gaps by what the host was doing."""
    by_name = {}
    for r in device:
        key = short_name(r.name)
        by_name[key] = by_name.get(key, 0.0) + r.dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v * 1e-6] for k, v in ops],
            "idle_gaps": [[k, v * 1e-6] for k, v in
                          idle_gaps(busy, window, runtime)[:top]]}


class Context:
    """What a per-layer metric's ``read(ctx)`` reads: the device records
    of the traced window, the blocks stepped in it, the untraced calls'
    host seconds, the cell, and the least time of a block."""

    def __init__(self, cell, device, window, blocks, call_seconds,
                 bound_s, load_metric):
        self.cell = cell
        self.records = device
        self.window = window
        self.blocks = blocks
        self.call_seconds = call_seconds
        self.bound_s = bound_s
        self._load = load_metric
        self._values = {}

    @property
    def window_us(self):
        return self.window[1] - self.window[0]

    def busy_us(self):
        return sum(b - a for a, b in union(self.records, self.window))

    def device_us(self, keep):
        """Device us a block of the records for which ``keep(record)``."""
        return sum(r.dur for r in self.records if keep(r)) / self.blocks

    def value(self, name):
        """Another per-layer metric's value (None when it reads none)."""
        if name not in self._values:
            self._values[name] = self._load(name).read(self)
        return self._values[name]
