"""The port's tracing (``gsdr_tpu_torch/utils/profiling.py``): the spans of
a compiled call and its counter level, the clock map, the exported trace;
on the card, the chain kernels' counted instantiations
(``csrc/clocks.cuh``) against the plain ones.

The CPU runs a compiled call's card path with a graph that replays its
step eagerly (``_EagerGraph``). The card tests (marked ``cuda``) skip
elsewhere: ``python -m pytest -m cuda tests/test_torch_tracing.py``."""

import json
import re
import types

import numpy as np
import pytest
import torch

from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels import _build, am_chain, chain, fm_chain
from gsdr_tpu_torch.pipelines import AmReceiver, FmChannelizer
from gsdr_tpu_torch.utils import compile as cmp
from gsdr_tpu_torch.utils import profiling
from gsdr_tpu_torch.utils.tree import tree_flatten, tree_unflatten

CHILDREN = ["compiled.lookup", "compiled.copy_in", "compiled.replay",
            "compiled.clone"]


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.disable()
    yield
    profiling.disable()


def _step(state, x):
    return state + x.sum(), x * 2.0


class _EagerGraph(cmp._Graph):
    """A captured signature whose graph runs the step eagerly at each
    replay: the compiled call's card path, on the CPU."""

    def __init__(self, run, warm, state, block, stream):
        s_leaves, self.state_def = state
        b_leaves, self.block_def = block
        self.state_in = [cmp._static(x) for x in s_leaves]
        self.block_in = [cmp._static(x) for x in b_leaves]
        self.state_tree = tree_unflatten(self.state_def, self.state_in)
        self.block_tree = tree_unflatten(self.block_def, self.block_in)
        self.block_specs = tuple(map(cmp._spec, self.block_in))
        self.settings = cmp._settings()
        self.tallies = []
        self.out, self.out_def = [], None

        def replay():
            new_state, out = run(self.state_tree, self.block_tree)
            self._loop_back(new_state)
            self.out, self.out_def = tree_flatten(out)

        self.graph = types.SimpleNamespace(replay=replay)


@pytest.fixture
def card_path(monkeypatch):
    """Compiled calls on CPU tensors take the card path, on _EagerGraph."""
    monkeypatch.setattr(cmp, "device_of",
                        lambda block: torch.device("cuda", 0))
    monkeypatch.setattr(cmp, "_Graph", _EagerGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda dev: None)


@pytest.mark.parametrize("path", ["cpu", "card"])
def test_tracing_off_records_nothing(monkeypatch, request, path):
    """Off, a compiled call (the CPU's plain path, or the card path's
    capture and fast path) opens no span and records nothing in the last
    session's recorder."""
    if path == "card":
        request.getfixturevalue("card_path")
    with profiling.tracing() as rec:
        pass

    def opened(*args, **kwargs):
        raise AssertionError("a span opened with tracing off")

    monkeypatch.setattr(profiling.Recorder, "open", opened)
    step = cmp.compile_step(_step)
    state, out = step(torch.zeros(()), torch.ones(8))
    state, out = step(state, torch.ones(8))
    assert float(state) == 16.0 and torch.equal(out, 2 * torch.ones(8))
    assert profiling.level == profiling.OFF and rec.n == 0
    assert not rec.counts and profiling.recorder() is rec


def test_spans_nest_under_the_compiled_call(card_path):
    """Each call's spans nest under its compiled.call and share its id; the
    first captures (a span inside its lookup, and a count), the second
    takes the fast path; the outputs are the eager step's."""
    step = cmp.compile_step(_step)
    x = torch.arange(6.0)
    with profiling.tracing() as rec:
        s1, y1 = step(torch.zeros(()), x)
        s2, y2 = step(s1, x + 1)
    assert float(s2) == float(x.sum() + (x + 1).sum())
    assert torch.equal(y1, 2 * x) and torch.equal(y2, 2 * (x + 1))
    spans = rec.spans()
    names = [sp.name for sp in spans]
    assert names == (["compiled.call", "compiled.lookup", "compiled.capture"]
                     + CHILDREN[1:] + ["compiled.call"] + CHILDREN)
    assert rec.counts["compiled.capture"] == 1 and step.graphs == 1
    second = names.index("compiled.call", 1)
    for first, call_id in ((0, 1), (second, 2)):
        assert spans[first].parent == -1 and spans[first].call == call_id
        end = second if first == 0 else len(spans)
        for k, sp in enumerate(spans[first + 1:end], first + 1):
            parent = k - 1 if sp.name == "compiled.capture" else first
            assert sp.parent == parent and sp.call == call_id
            assert spans[first].start <= sp.start <= sp.end \
                <= spans[first].end


def test_cpu_call_records_its_span():
    """On the CPU a compiled call runs the step and records compiled.call
    alone."""
    step = cmp.compile_step(_step)
    with profiling.tracing() as rec:
        step(torch.zeros(()), torch.ones(4))
    assert [(sp.name, sp.parent, sp.call) for sp in rec.spans()] == [
        ("compiled.call", -1, 1)]


@pytest.mark.parametrize("lvl,same", [(profiling.SPANS, True),
                                      (profiling.COUNTERS, False)])
def test_signature_follows_the_counter_level(lvl, same):
    """Spans alone replay the untraced graph; the counter level is another
    signature, so another graph."""
    state, block = torch.zeros(3), TCA(torch.ones(8), torch.zeros(8))
    key = cmp.signature(state, block)[0]
    with profiling.tracing(lvl):
        assert (cmp.signature(state, block)[0] == key) is same


def test_recorder_drops_past_its_capacity():
    with profiling.tracing(capacity=2) as rec:
        for name in "abc":
            rec.close(rec.open(name))
    assert [sp.name for sp in rec.spans()] == ["a", "b"]
    assert rec.dropped == 1
    with pytest.raises(ValueError):
        profiling.enable(3)


def _spans(starts_us, durs_us, name="compiled.replay"):
    return [profiling.Span(name, int(s * 1e3), int((s + d) * 1e3), -1, k + 1)
            for k, (s, d) in enumerate(zip(starts_us, durs_us))]


def test_clock_map_recovers_a_known_offset():
    """Replay spans against their cudaGraphLaunch records, shifted by a
    known offset with jitter inside each span, one record more than spans
    (a launch before the first span) and records of another name: the map
    puts every span around its record, within the jitter of the offset."""
    rng = np.random.default_rng(3)
    offset = 1.7e9 - 123.456
    starts = np.cumsum(rng.uniform(50.0, 90.0, 200))
    durs = rng.uniform(8.0, 14.0, 200)
    lead = rng.uniform(1.0, 3.0, 200)
    launch = durs - lead - rng.uniform(1.0, 3.0, 200)
    records = [("cudaGraphLaunch", s + offset + a, d)
               for s, a, d in zip(starts, lead, launch)]
    records = [("cudaGraphLaunch", starts[0] + offset - 40.0, 5.0)] + records
    records += [("cudaMemcpyAsync", s + offset + 1.0, 2.0) for s in starts]
    m = profiling.clock_map(_spans(starts, durs), records)
    assert m.pairs == 200 and m.enclosed == 1.0
    assert abs(m.offset_us - offset) < 1.0
    assert m.residual_us < 3.0
    assert profiling.clock_map(_spans(starts, durs), []) is None


def test_trace_writes_the_programs_spans(tmp_path):
    """trace() writes the profiler's trace with the program's spans on its
    clock: the anchors around its annotations, the compiled calls between
    them, and the fit."""
    step = cmp.compile_step(_step)
    with profiling.trace(tmp_path / "tr") as prof:
        state = torch.zeros(())
        for _ in range(3):
            state, _ = step(state, torch.ones(16))
    assert prof is not None and profiling.level == profiling.OFF
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "gsdr_span"]
    assert [e["name"] for e in spans] == (
        [profiling.ANCHOR] + ["compiled.call"] * 3 + [profiling.ANCHOR])
    assert [e["args"]["call"] for e in spans] == [0, 1, 2, 3, 0]
    fit = doc["gsdrClockMap"]
    assert fit["pairs"] == 2 and fit["enclosed"] == 1.0
    notes = [e for e in doc["traceEvents"] if e.get("name") ==
             profiling.ANCHOR and e.get("cat") != "gsdr_span"]
    assert len(notes) == 2
    for span, note in zip(spans[::4], notes):
        assert span["ts"] <= note["ts"]
        assert note["ts"] + note["dur"] <= span["ts"] + span["dur"]
    assert doc["gsdrCounters"] == {}


def test_chain_clocks_match_the_source():
    """CHAIN_CLOCKS names clocks.cuh's counter slots, in order."""
    src = (_build.CSRC / "clocks.cuh").read_text()
    body = re.search(r"enum Counter : int \{(.*?)\};", src, re.S).group(1)
    slots = re.findall(r"^\s*(k\w+),", body, re.M)
    assert slots[-1] == "kPolls" and len(slots) == len(chain.CHAIN_CLOCKS)
    assert "kCounters" in body.split(slots[-1])[1]
    want = ["k" + "".join(w.title() for w in f.split("_"))
            for f in chain.CHAIN_CLOCKS]
    rename = {"kBlockClocks": "kBlock", "kFrontClocks": "kFront",
              "kConsumerFrontClocks": "kConsumerFront",
              "kFullWaitClocks": "kFullWait",
              "kProducerFrontClocks": "kProducerFront",
              "kFreeWaitClocks": "kFreeWait",
              "kStageWaitClocks": "kStageWait"}
    assert [rename.get(w, w) for w in want] == slots


def test_counted_launch_only_where_the_kernel_counts(monkeypatch):
    """No counter buffer below the counter level, at another grade or at
    the one-chunk plan; the chunked plan at bf16x3 takes one."""
    counters = profiling.KernelCounters("test_kernel", ("launches",))
    try:
        made = []
        monkeypatch.setattr(counters, "buffer", lambda dev: made.append(dev)
                            or torch.zeros(1, dtype=torch.int64))
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: False)
        dev = torch.device("cpu")
        plan, k, q = (32, 4), 640, 4
        with profiling.tracing(profiling.SPANS):
            assert chain.counted_launch(counters, dev, 3, plan, k, q) is None
        with profiling.tracing(profiling.COUNTERS):
            assert chain.counted_launch(counters, dev, 2, plan, k, q) is None
            assert chain.counted_launch(counters, dev, 3, (k, q), k, q) \
                is None
            assert chain.counted_launch(counters, dev, 3, plan, k, q) \
                is not None
        assert made == [dev]
    finally:
        profiling._kernel_counters.remove(counters)


# ---------------------------------------------------------------------------
# On the card: the counted chain kernels
# ---------------------------------------------------------------------------

# The benchmark's two deployments (sdr_bench/configs): land-mobile NFM,
# 320 channels of the 12.5-kHz raster at 8 MHz, 2560 taps, D = 160; VHF
# airband AM, 480 channels of 8333.25 Hz at 7.99992 MHz, 3840 taps, D =
# 240; each on the chunked bf16x3 PFB front
CELLS = {
    "fm": dict(fs=8e6, bins=range(-160, 160), spacing=12_500.0, taps=2560,
               cutoff=5000.0, d=160),
    "am": dict(fs=7.99992e6, bins=range(-240, 240), spacing=7.99992e6 / 960,
               taps=3840, cutoff=3000.0, d=240),
}
# the capture block, and each deployment's 20-ms block
def _trace_cell():
    """tools/trace_cell.py, the readings of the tracing in a benchmark
    cell."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "trace_cell", _build.CSRC.parents[2] / "tools" / "trace_cell.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _call(call, t0, parts):
    """The spans of one compiled call from t0 (ns): its parts' (name,
    ns) in turn."""
    spans, t = [], t0
    for name, ns in parts:
        spans.append(profiling.Span(name, t, t + ns, 0, call))
        t += ns
    return [profiling.Span("compiled.call", t0, t, -1, call)] + spans


def test_trace_cell_values_from_spans_and_counters():
    """The medians of the compiled call's parts over the calls (an unclosed
    span left out) and the counters' shares, summed over the kernels;
    nothing for what a stretch lacks."""
    tc = _trace_cell()
    spans = []
    for k, scale in enumerate((1, 3, 2)):
        spans += _call(k + 1, 10_000 * k, [
            ("compiled.lookup", 1000 * scale), ("compiled.copy_in", 500),
            ("compiled.replay", 4000 * scale), ("compiled.clone", 700)])
    spans.append(profiling.Span("compiled.lookup", 0, 0, -1, 9))  # unclosed
    fm = {"launches": 3, "blocks": 30, "block_clocks": 1000,
          "front_clocks": 800, "consumer_front_clocks": 4000,
          "full_wait_clocks": 1000, "producer_front_clocks": 5000,
          "free_wait_clocks": 500, "stage_wait_clocks": 250,
          "poll_clocks": 20, "polls": 4}
    got = tc.values(spans, {"pfb_fm_chain": fm})
    assert got == {"lookup_host_us": 2.0, "copy_host_us": 1.2,
                   "replay_host_us": 8.0, "front_share_pct": 80.0,
                   "fold_wait_pct": 25.0, "product_wait_pct": 10.0,
                   "stage_wait_pct": 5.0, "lookback_wait_pct": 2.0}
    am = {k: v for k, v in fm.items() if k not in ("poll_clocks", "polls")}
    assert "lookback_wait_pct" not in tc.values([], {"am": am})
    assert tc.values(_call(1, 0, [("x", 5)]), {}) == {}


def test_trace_cell_reads_the_row_tile_and_grid():
    """The counted kernels' blocks a launch (their grid) and the rows the
    wrappers' chunked launches took, beside the counter ratios; nothing
    for a kernel that did not launch or a wrapper without row counts."""
    tc = _trace_cell()
    counters = {"pfb_fm_chain": {"launches": 4, "blocks": 320},
                "pfb_am_chain": {"launches": 0, "blocks": 0}}
    wrappers = {"fm_chain": types.SimpleNamespace(),
                "pfb_fm_chain": types.SimpleNamespace(
                    row_tiles={256: 0, 128: 2, 64: 0}),
                "pfb_am_chain": types.SimpleNamespace(
                    row_tiles={256: 0, 128: 0, 64: 0})}
    assert tc.engagement(counters, wrappers) == {
        "pfb_fm_chain.blocks_a_launch": 80.0,
        "pfb_fm_chain.row_tiles": [128]}
    assert tc.engagement({}, {}) == {}


def test_trace_cell_names_gaps_by_span():
    """Window edges first, then the innermost span open at a gap's start,
    then the runtime call, then the host outside both."""
    from sdr_bench import trace

    tc = _trace_cell()
    window = (100.0, 200.0)
    busy = [[105.0, 120.0], [130.0, 150.0], [151.0, 170.0], [190.0, 195.0]]
    spans = [profiling.Span("compiled.call", 116_000, 135_000, -1, 1),
             profiling.Span("compiled.replay", 117_000, 123_000, 0, 1)]
    runtime = [trace.Record("cudaEventSynchronize", "cuda_runtime", 149.0,
                            5.0)]
    got = tc.named_gaps(busy, window, runtime, spans, 2.0)
    assert got == [(trace.HOST_IDLE, 20.0),
                   ("span compiled.replay", 10.0),
                   (tc.WINDOW_EDGE, 5.0), (tc.WINDOW_EDGE, 5.0),
                   ("host in cudaEventSynchronize", 1.0)]


BLOCKS = {"fm": (983_040, 160_000), "am": (983_040, 160_320)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")


def _receiver(kind):
    c = CELLS[kind]
    k = np.arange(c["taps"]) - (c["taps"] - 1) / 2.0
    h = np.sinc(2 * c["cutoff"] / c["fs"] * k) * np.hamming(c["taps"])
    kw = dict(sample_rate=c["fs"], tuning_frequency=0.0,
              channel_frequencies=tuple(b * c["spacing"] for b in c["bins"]),
              decimation=c["d"],
              low_pass_taps=tuple(float(v) for v in h / h.sum()),
              impl="auto", precision="bf16x3", device="cuda")
    if kind == "fm":
        return FmChannelizer(frequency_deviation=2500.0,
                             deemphasis_tau=75e-6, **kw)
    return AmReceiver(**kw)


def _block(n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return TCA(torch.randn(n, generator=g, device="cuda") * 0.1,
               torch.randn(n, generator=g, device="cuda") * 0.1)


def _counters(kind):
    return (fm_chain if kind == "fm" else am_chain).pfb_counters


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fm", "am"])
def test_counted_kernels_bit_equal_on_card(card, kind):
    """The counted instantiation's outputs and state equal the plain
    one's bit for bit, three blocks of each length in turn from one state,
    at both deployments' geometries; each counted call is one launch."""
    model = _receiver(kind)
    assert model.front == "pfb"
    for n in BLOCKS[kind]:
        state = model.init()
        for i in range(3):
            blk = _block(n, 11 * i + n % 97)
            plain_state, plain = model.step(state, blk)
            with profiling.tracing(profiling.COUNTERS) as rec:
                counted_state, counted = model.step(state, blk)
                got = rec.counters()[_counters(kind).kernel]
            assert got["launches"] == 1
            assert torch.equal(plain, counted)
            for a, b in zip(tree_flatten(plain_state)[0],
                            tree_flatten(counted_state)[0]):
                assert torch.equal(a, b) if isinstance(a, torch.Tensor) \
                    else a == b
            state = plain_state


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fm", "am"])
def test_counted_waits_within_their_fronts_on_card(card, kind):
    """0 <= each wait <= its warps' front clocks <= 8 warps' block clocks;
    the front call within the block; the look-back's polls within the
    block (FM); no poll counters in the AM kernel."""
    model = _receiver(kind)
    state = model.init()
    with profiling.tracing(profiling.COUNTERS) as rec:
        for i in range(4):
            state, _ = model.step(state, _block(BLOCKS[kind][i % 2], i))
        got = rec.counters()[_counters(kind).kernel]
    assert got["launches"] == 4 and got["blocks"] > 4
    block = got["block_clocks"]
    assert 0 < got["front_clocks"] <= block
    assert 0 <= got["full_wait_clocks"] <= got["consumer_front_clocks"] \
        <= 8 * block
    assert 0 <= got["free_wait_clocks"] + got["stage_wait_clocks"] \
        <= got["producer_front_clocks"] <= 8 * block
    if kind == "fm":
        assert 0 <= got["poll_clocks"] <= block and got["polls"] >= 0
    else:
        assert "poll_clocks" not in got and "polls" not in got


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fm", "am"])
def test_one_launch_counted_a_replay_on_card(card, kind):
    """A compiled step at the counter level captures its own graph, and
    its replays count one launch each; back at spans alone it replays the
    untraced graph, which counts nothing."""
    model = _receiver(kind)
    step = cmp.compile_step(model.step)
    blk = _block(BLOCKS[kind][1], 5)
    state, _ = step(model.init(), blk)
    with profiling.tracing(profiling.COUNTERS) as rec:
        state, _ = step(state, blk)           # the counted graph's capture
        torch.cuda.synchronize()
        rec.clear()
        for _ in range(7):
            state, _ = step(state, blk)
        torch.cuda.synchronize()
        got = rec.counters()[_counters(kind).kernel]
    assert step.graphs == 2 and rec.counts["compiled.capture"] == 0
    assert got["launches"] == 7 and got["blocks"] % 7 == 0
    with profiling.tracing(profiling.SPANS) as rec:
        state, _ = step(state, blk)
        torch.cuda.synchronize()
        assert rec.counters()[_counters(kind).kernel]["launches"] == 0
    assert step.graphs == 2


@pytest.mark.cuda
def test_trace_maps_replays_on_card(card, tmp_path):
    """trace() of a compiled receiver: every replay span, mapped, encloses
    its cudaGraphLaunch record."""
    model = _receiver("fm")
    step = cmp.compile_step(model.step)
    blk = _block(BLOCKS["fm"][1], 9)
    state, _ = step(model.init(), blk)
    torch.cuda.synchronize()
    with profiling.trace(tmp_path / "tr"):
        for _ in range(50):
            state, _ = step(state, blk)
        torch.cuda.synchronize()
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    fit = doc["gsdrClockMap"]
    assert fit["pairs"] == 52 and fit["enclosed"] >= 0.99
