"""Tracing of the port: the program's spans on the host, clock counters on
the card, and the profiler's Chrome trace that holds both.

Counterpart of ``gsdr_tpu/utils/profiling.py``'s ``trace``.

One switch, ``tracing(level)`` (or ``enable(level)`` and ``disable()``),
at one of two levels:

  * ``SPANS``: every call of a compiled step (``utils/compile.py``)
    records its spans: ``compiled.call`` and, on the card, its children
    ``compiled.lookup`` (the graph's fast path, or the signature and the
    graph's lookup, with ``compiled.capture`` inside it for a new graph;
    also counted, in ``Recorder.counts``), ``compiled.copy_in`` (the state and block into
    the graph's buffers), ``compiled.replay`` and ``compiled.clone`` (the
    ``out`` clone). Each span holds its name, start and end
    (``time.perf_counter_ns``), parent and the id of the call it belongs
    to: every span of one compiled call shares that call's id.
  * ``COUNTERS``: the spans, and every kernel with a counted instantiation
    (``csrc/clocks.cuh``: ``pfb_fm_chain`` and ``pfb_am_chain`` on the
    chunked PFB front at bf16x3) launches it, which adds its SM clocks and
    counts into a buffer that its wrapper owns (``KernelCounters``). The
    level is part of a compiled step's signature, so a graph captured at
    one level is never replayed at the other. Other kernels count nothing
    and report none.

Spans go into a buffer allocated when tracing starts; nothing is written
until the caller reads it (``Recorder.spans``, ``Recorder.counters``) or
``trace(log_dir)`` exports it. With tracing off (``OFF``, the default)
each site costs one check of ``level`` and runs the code it runs
untraced. The recorder serves one thread.

``clock_map`` maps the span clock onto a profiler trace's clock, fitted
to the trace's records that spans enclose; ``trace(log_dir)`` writes the
profiler's Chrome trace with the program's spans on the trace's clock.
"""

import collections
import contextlib
import json
import os
import statistics
import time
from pathlib import Path

import torch

OFF, SPANS, COUNTERS = 0, 1, 2
level = OFF         # read at every site
_recorder = None
_kernel_counters = []

# the span ``trace`` records around a profiler annotation of the same name,
# at its start and its end
ANCHOR = "profiling.anchor"
# (span name, trace record name): each such span encloses its record
ENCLOSED = (("compiled.replay", "cudaGraphLaunch"), (ANCHOR, ANCHOR))
_MAX_SHIFT = 256    # records and spans of one name counted apart at most

Span = collections.namedtuple("Span", "name start end parent call")
Span.__doc__ = ("A recorded span: its name, start and end "
                "(``time.perf_counter_ns``; end 0 if never closed), its "
                "parent's index (-1: none) and its call's id (0: outside "
                "any compiled call).")
ClockMap = collections.namedtuple("ClockMap",
                                  "offset_us residual_us pairs enclosed")
ClockMap.__doc__ = (
    "``clock_map``'s fit: a span's time in us plus ``offset_us`` is the "
    "trace's time; ``residual_us`` the median distance between a record's "
    "centre and its span's mapped centre; ``pairs`` the (span, record) "
    "pairs fitted; ``enclosed`` the share of them whose mapped span "
    "encloses its record.")


class Recorder:
    """The spans and counts of one tracing session, in lists of
    ``capacity`` entries allocated at the start: a span past them is
    dropped and counted in ``dropped``."""

    def __init__(self, capacity):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._name = [None] * capacity
        self._start = [0] * capacity
        self._end = [0] * capacity
        self._parent = [-1] * capacity
        self._call = [0] * capacity
        self.counts = collections.Counter()
        self.clear()

    def clear(self):
        """Forget every span and count, and zero the counted kernels'
        counters (after the launches in flight)."""
        self.n = 0
        self.dropped = 0
        self.counts.clear()
        self._top = -1       # the innermost open span
        self._current = 0    # the call id of a span opened now
        self._calls = 0
        for kc in _kernel_counters:
            kc.reset()

    def open(self, name, call=False):
        """Open span ``name`` under the innermost open span (``call``: a
        compiled call, with a new call id); returns its index for
        ``close`` (-1 if dropped)."""
        if call:
            self._calls += 1
            cid = self._calls
        else:
            cid = self._current
        i = self.n
        if i == self.capacity:
            self.dropped += 1
            return -1
        self.n = i + 1
        self._name[i] = name
        self._parent[i] = self._top
        self._call[i] = cid
        self._top = i
        self._current = cid
        self._start[i] = time.perf_counter_ns()
        return i

    def close(self, i):
        """Close the span ``open`` returned; its parent is innermost
        again."""
        t = time.perf_counter_ns()
        if i < 0:
            return
        self._end[i] = t
        p = self._parent[i]
        self._top = p
        self._current = self._call[p] if p >= 0 else 0

    def spans(self):
        """The recorded spans (``Span``), in the order they opened."""
        return [Span(self._name[i], self._start[i], self._end[i],
                     self._parent[i], self._call[i]) for i in range(self.n)]

    def counters(self):
        """{kernel: {counter: count}} of every counted kernel that a launch
        has counted on, after the launches in flight; a kernel that never
        counted is absent."""
        out = {}
        for kc in _kernel_counters:
            got = kc.read()
            if got is not None:
                out[kc.kernel] = got
        return out


class KernelCounters:
    """The counters of a kernel's counted instantiation: one int64 buffer
    a device, of one slot per entry of ``fields`` (``None`` at a slot the
    kernel does not count), zeroed when made, added into by every counted
    launch and never replaced, so a graph's launches keep its address. The
    kernel's wrapper owns it and passes ``buffer(device)`` to its counted
    launches; ``Recorder.counters`` reads every one."""

    def __init__(self, kernel, fields):
        self.kernel = kernel
        self.fields = tuple(fields)
        self._buffers = {}
        _kernel_counters.append(self)

    def buffer(self, device):
        """The buffer of ``device``, made zeroed on its first use; inside a
        CUDA-graph capture it must exist already (the compiled step's
        warm-up, outside the capture, makes it)."""
        buf = self._buffers.get(device)
        if buf is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{self.kernel}: no counter buffer on {device} before "
                    "the capture; run the step once outside it")
            buf = self._buffers[device] = torch.zeros(
                len(self.fields), dtype=torch.int64, device=device)
        return buf

    def _synchronize(self):
        """Wait for every launch in flight on the buffers' devices: the
        counted launches run on the compiled step's stream, not the
        current one."""
        for device in self._buffers:
            torch.cuda.synchronize(device)

    def read(self):
        """{counter: count} summed over the devices after the launches in
        flight, or None before any buffer is made."""
        if not self._buffers:
            return None
        self._synchronize()
        total = sum(b.cpu() for b in self._buffers.values())
        return {f: int(v) for f, v in zip(self.fields, total.tolist()) if f}

    def reset(self):
        """Zero the buffers between the launches before and after."""
        self._synchronize()
        for b in self._buffers.values():
            b.zero_()
        self._synchronize()


def enable(lvl=SPANS, capacity=1 << 16):
    """Turn tracing on at ``lvl`` (SPANS or COUNTERS) with a new recorder
    of ``capacity`` spans (the counted kernels' counters zeroed); returns
    it."""
    global level, _recorder
    if lvl not in (SPANS, COUNTERS):
        raise ValueError(f"tracing level must be SPANS ({SPANS}) or "
                         f"COUNTERS ({COUNTERS}), got {lvl!r}")
    _recorder = Recorder(capacity)
    level = lvl
    return _recorder


def disable():
    """Turn tracing off; returns the last recorder, whose spans and
    counters stay readable."""
    global level
    level = OFF
    return _recorder


def recorder():
    """The recorder of the current (or last) tracing session."""
    return _recorder


@contextlib.contextmanager
def tracing(lvl=SPANS, capacity=1 << 16):
    """Tracing on at ``lvl`` inside the block (see ``enable``); yields the
    recorder."""
    rec = enable(lvl, capacity)
    try:
        yield rec
    finally:
        disable()


def _pairs(spans, records):
    """(span, record) intervals paired in order, both sorted by start;
    where their counts differ, at the offset between the two sequences
    that leaves the least spread of their centres' differences."""
    if not spans or not records:
        return []
    short, long_ = (spans, records) if len(spans) <= len(records) \
        else (records, spans)
    shifts = range(min(len(long_) - len(short), _MAX_SHIFT) + 1)

    def spread(shift):
        d = [(b[0] + b[1] - a[0] - a[1]) / 2
             for a, b in zip(short, long_[shift:shift + len(short)])]
        m = statistics.median(d)
        return statistics.median(abs(x - m) for x in d)

    best = min(shifts, key=spread) if len(shifts) > 1 else 0
    out = list(zip(short, long_[best:best + len(short)]))
    return out if short is spans else [(s, r) for r, s in out]


def clock_map(spans, records):
    """The map of the span clock onto a profiler trace's clock, fitted to
    the trace records that spans enclose (``ENCLOSED``: each
    ``compiled.replay`` span encloses its ``cudaGraphLaunch`` runtime
    record, each ``ANCHOR`` span the profiler's annotation of the same
    name): the offset that the most pairs' spans, so mapped, enclose
    their records. ``spans``: ``Span``s; ``records``: (name, start us,
    duration us) on the trace's clock. Returns a ``ClockMap``, or None
    where no pair is found."""
    pairs = []
    for span_name, rec_name in ENCLOSED:
        s = sorted((sp.start / 1e3, sp.end / 1e3) for sp in spans
                   if sp.name == span_name and sp.end)
        r = sorted((ts, ts + dur) for name, ts, dur in records
                   if name == rec_name)
        pairs += _pairs(s, r)
    if not pairs:
        return None
    # each pair admits offsets in [record end - span end, record start -
    # span start]: the offset the most of those intervals hold
    edges = sorted(e for (a, b), (ts, te) in pairs if te - b <= ts - a
                   for e in ((te - b, 0), (ts - a, 1)))
    diffs = [(ts + te - a - b) / 2 for (a, b), (ts, te) in pairs]
    offset, depth, most = statistics.median(diffs), 0, 0
    for k, (x, closes) in enumerate(edges):
        depth += -1 if closes else 1
        if depth > most:
            most = depth
            offset = (x + edges[k + 1][0]) / 2
    enclosed = sum(a + offset <= ts and te <= b + offset
                   for (a, b), (ts, te) in pairs) / len(pairs)
    return ClockMap(offset, statistics.median(abs(d - offset) for d in diffs),
                    len(pairs), enclosed)


def _anchor(rec, record_function):
    i = rec.open(ANCHOR)
    with record_function(ANCHOR):
        pass
    rec.close(i)


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block with ``torch.profiler`` and record the program's
    spans; on exit write ``log_dir/trace.json`` (open it in Perfetto or
    chrome://tracing): the profiler's Chrome trace of the host and, where
    there is a card, its kernels, with the program's spans in it (category
    ``gsdr_span``; their call id and parent in ``args``) on the trace's
    clock (``clock_map`` over the anchors this marks at the block's start
    and end and the compiled replays; the fit under ``gsdrClockMap``) and
    the counted kernels' counters under ``gsdrCounters``. Tracing is at
    SPANS inside the block unless the caller has it on already, at its
    level. Yields the ``torch.profiler.profile`` (``key_averages()`` for
    sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    own = level == OFF
    rec = enable(SPANS) if own else _recorder
    first = rec.n
    try:
        with profile(activities=activities) as prof:
            _anchor(rec, record_function)
            yield prof
            _anchor(rec, record_function)
    finally:
        if own:
            disable()
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    events = doc.setdefault("traceEvents", [])
    spans = rec.spans()
    cmap = clock_map(spans[first:], [
        (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
        for e in events if e.get("ph") == "X" and "ts" in e])
    offset = cmap.offset_us if cmap is not None else 0.0
    pid = os.getpid()
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": "gsdr_span",
                   "args": {"name": "gsdr_tpu_torch spans"}})
    for i in range(first, len(spans)):
        sp = spans[i]
        if not sp.end:
            continue
        events.append({"ph": "X", "cat": "gsdr_span", "name": sp.name,
                       "pid": pid, "tid": "gsdr_span",
                       "ts": sp.start / 1e3 + offset,
                       "dur": (sp.end - sp.start) / 1e3,
                       "args": {"call": sp.call, "span": i,
                                "parent": sp.parent}})
    doc["gsdrClockMap"] = cmap._asdict() if cmap is not None else None
    doc["gsdrCounters"] = rec.counters()
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
