"""The compiled step (``gsdr_tpu_torch/utils/compile.py``) and the state
trees it walks (``utils/tree.py``), on the CPU: the port's counterpart of
``jax.jit`` against ``jax.jit`` on the same numpy inputs. On the CPU a
compiled step runs the step as it is; the graphs themselves are held to
the eager steps on the card (``tests/test_torch_cuda.py``)."""

import collections
import dataclasses
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

import gsdr_tpu.stream as js
import gsdr_tpu_torch.stream as ts
from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.pipelines import AmReceiver as JAm
from gsdr_tpu.pipelines import FmChannelizer as JFm
from gsdr_tpu.runtime import IqFileSource as JSource
from gsdr_tpu.runtime import StreamRunner as JRunner
from gsdr_tpu.runtime import host as jhost
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels.chain import graph_refs, hold_for_graph
from gsdr_tpu_torch.ops.pfb import pfb_channelize_block
from gsdr_tpu_torch.pipelines import Qpsk256Modem, fm_deemphasis_coeffs
from gsdr_tpu_torch.runtime import IqFileSource, StreamRunner
from gsdr_tpu_torch.utils import timing
from gsdr_tpu_torch.utils.compile import CompiledStep, compile_step, signature
from gsdr_tpu_torch.utils.convert import (
    am_receiver_from_fields,
    fm_channelizer_from_fields,
)
from gsdr_tpu_torch.utils.tree import tree_flatten, tree_unflatten

FS = 1_000_000.0
BLOCK = 4096
SKIP = 256            # zero-primed warm-up outputs
# the XLA-path gates of the parity tests: FM audio of max|audio|
# (tests/test_torch_fm_radio.py, tests/test_torch_runtime.py), the AM
# envelope absolute (tests/test_torch_am_radio.py), the stream_fm chain's
# audio of max|audio| (tests/test_torch_stream.py)
FM_TOL = 2e-4
ENV_ATOL = 1e-5
CHAIN_TOL = 1e-4


def _lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def _jfm():
    """A small flagship: 4 channels 60 kHz apart, 33 taps, D=4."""
    return JFm(sample_rate=FS, tuning_frequency=100_000_000.0,
               channel_frequencies=tuple(100_000_000.0 - 90_000.0
                                         + 60_000.0 * i for i in range(4)),
               frequency_deviation=75_000.0, decimation=4,
               low_pass_taps=_lowpass(33, 0.03), impl="xla")


def _jam():
    """am_d at 4 channels."""
    return JAm(sample_rate=FS, tuning_frequency=100_000_000.0,
               channel_frequencies=tuple(100_000_000.0 - 100_000.0
                                         + 50_000.0 * i for i in range(4)),
               decimation=4, low_pass_taps=_lowpass(32, 0.04), impl="xla")


def _stream_fm(pkg):
    """The stream_fm chain at a small block: mixer, 64-tap low-pass at
    D=4, discriminator, de-emphasis, an order-8 Butterworth as biquads."""
    rate = FS / 4
    b, a = fm_deemphasis_coeffs(75e-6, rate)
    sos = tuple(tuple(r) for r in
                ss.butter(8, 15e3, fs=rate, output="sos").tolist())
    return pkg.Chain(stages=(
        pkg.MixerStream(freq_shift_hz=-100_000.0, sample_rate=FS),
        pkg.FirStream(taps=_lowpass(64, 0.03), decimation=4),
        pkg.QuadFmStream(gain=rate / (2 * math.pi * 75_000.0)),
        pkg.IirStream(b, a),
        pkg.SosStream(sos)))


def _fm_signal(shifts, n, seed=7, deviation=10_000.0):
    """Real FM carriers on every channel (no atan2 branch cut), each a
    tone at ``deviation`` Hz, inside the channel's low-pass."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / FS
    sig = np.zeros(n, np.complex128)
    for k, f in enumerate(shifts):
        tone = 700.0 + 370.0 * k
        msg = np.sin(2 * np.pi * tone * t + r.uniform(0, 6))
        sig += (0.5 / len(shifts)) * np.exp(
            1j * (2 * np.pi * f * t + deviation / tone * msg))
    return sig.real.astype(np.float32), sig.imag.astype(np.float32)


def _am_signal(freqs, n, tuning, seed=3):
    r = np.random.default_rng(seed)
    t = np.arange(n) / FS
    sig = np.zeros(n, np.complex128)
    for k, f in enumerate(freqs):
        env = 0.6 * (1.0 + 0.5 * np.sin(2 * np.pi * (500.0 + 310.0 * k) * t
                                         + r.uniform(0, 6)))
        sig += env * np.exp(1j * (2 * np.pi * (f - tuning) * t
                                  + r.uniform(0, 6)))
    return sig.real.astype(np.float32), sig.imag.astype(np.float32)


def _carrier(n):
    """stream_fm's input: an FM carrier at +100 kHz, a 1-kHz tone."""
    t = np.arange(n) / FS
    z = np.exp(1j * (2 * np.pi * 100_000.0 * t
                     + 10.0 * np.sin(2 * np.pi * 1000.0 * t)))
    return z.real.astype(np.float32), z.imag.astype(np.float32)


def _blocks(re, im, n_blocks):
    sl = [slice(i * BLOCK, (i + 1) * BLOCK) for i in range(n_blocks)]
    return ([JCA(jnp.asarray(re[s]), jnp.asarray(im[s])) for s in sl],
            [TCA(torch.from_numpy(re[s]), torch.from_numpy(im[s]))
             for s in sl])


def _np_leaves(tree):
    return [np.asarray(x) for x in tree_flatten(tree)[0]]


# ---------------------------------------------------------------------------
# state trees
# ---------------------------------------------------------------------------

def _fm_state():
    tm = fm_channelizer_from_fields(dataclasses.asdict(_jfm()), device="cpu")
    return tm.init()


def _am_state():
    tm = am_receiver_from_fields(dataclasses.asdict(_jam()), device="cpu")
    return tm.init()


def _chain_state():
    tc = _stream_fm(ts)
    re, im = _carrier(BLOCK)
    return tc.init(TCA(torch.from_numpy(re), torch.from_numpy(im)))


def _transmux_state():
    """pfb_channelize_block's carried tail after one block (K=8)."""
    taps = _lowpass(64, 0.5 / 8)
    re, im = _carrier(BLOCK)
    _, tail = pfb_channelize_block(
        TCA(torch.from_numpy(re), torch.from_numpy(im)), taps, 8)
    return tail


def _iir_state():
    return ts.IirStream((0.2, 0.3), (1.0, -0.5)).init(torch.zeros(BLOCK))


NT = collections.namedtuple("NT", "a b")

STATES = {
    "flagship": _fm_state,
    "am_receiver": _am_state,
    "stream_fm": _chain_state,
    "transmux_tail": _transmux_state,
    "qpsk256_rx": lambda: (),
    "iir_stream": _iir_state,
    "nested": lambda: {"z": NT(torch.arange(3), None), "a": [2.5, (TCA(
        torch.ones(2), torch.zeros(2)),)]},
}


@pytest.mark.parametrize("name", sorted(STATES))
def test_tree_round_trip_of_main_path_states(name):
    """Every main path's state flattens to its tensors (in JAX's order)
    and rebuilds to the same structure with the same leaf objects; the
    structure is hashable and a flatten of the rebuilt tree gives it
    again."""
    state = STATES[name]()
    leaves, treedef = tree_flatten(state)
    hash(treedef)
    back = tree_unflatten(treedef, leaves)
    again, treedef2 = tree_flatten(back)
    assert treedef2 == treedef
    assert len(again) == len(leaves)
    assert all(a is b for a, b in zip(again, leaves))
    assert type(back) is type(state)
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(treedef, leaves + [torch.zeros(1)])


def test_tree_leaves_in_jax_order():
    """The flagship state and a dict state: the port's leaves are JAX's
    ``tree_leaves`` of the JAX package's state, in order, value for
    value."""
    jm = _jfm()
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    re, im = _fm_signal(jm._shifts(), BLOCK)
    sj, _ = jm.step(jm.init(77), JCA(jnp.asarray(re), jnp.asarray(im)))
    st, _ = tm.step(tm.init(77), TCA(torch.from_numpy(re),
                                     torch.from_numpy(im)))
    got, want = _np_leaves(st), [np.asarray(x)
                                 for x in jax.tree_util.tree_leaves(sj)]
    assert len(got) == len(want) == 6
    for g, w in zip(got[:3], want[:3]):    # n0 and the raw RF tail: exact
        np.testing.assert_array_equal(g, w)
    d = {"b": torch.ones(2), "a": (torch.zeros(1), None)}
    jd = {"b": jnp.ones(2), "a": (jnp.zeros(1), None)}
    assert [x.shape for x in _np_leaves(d)] == \
        [x.shape for x in jax.tree_util.tree_leaves(jd)]
    assert list(tree_unflatten(tree_flatten(d)[1], tree_flatten(d)[0])) \
        == ["b", "a"]


# ---------------------------------------------------------------------------
# the signature
# ---------------------------------------------------------------------------

def test_signature_changes_with_block_length_not_with_state_passed_back():
    """The key of the graph: the same for the state a step returns (the
    state passed back), new for another block length, dtype or state
    structure, for another Python scalar in the state and for another
    TF32 setting; a leaf that is neither a tensor nor a scalar raises."""
    jm = _jfm()
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    re, im = _fm_signal(jm._shifts(), 2 * BLOCK)
    block = TCA(torch.from_numpy(re[:BLOCK]), torch.from_numpy(im[:BLOCK]))
    state = tm.init()
    key = signature(state, block)[0]
    hash(key)
    state2, _ = tm.step(state, block)
    assert signature(state2, block)[0] == key
    longer = TCA(torch.from_numpy(re), torch.from_numpy(im))
    assert signature(state2, longer)[0] != key
    assert signature(state, TCA(block.re.double(), block.im.double()))[0] \
        != key
    assert signature(state[:3], block)[0] != key
    assert signature((1, state), block)[0] != signature((2, state), block)[0]
    old = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = not old
        assert signature(state, block)[0] != key
    finally:
        torch.backends.cudnn.allow_tf32 = old
    with pytest.raises(TypeError, match="leaf of type"):
        signature((object(),), block)


# ---------------------------------------------------------------------------
# compile_step on the CPU
# ---------------------------------------------------------------------------

def _chained(step, state, blocks):
    outs = []
    for b in blocks:
        state, y = step(state, b)
        outs.append(y)
    return state, outs


def _assert_trees_equal(got, want):
    gl, gd = tree_flatten(got)
    wl, wd = tree_flatten(want)
    assert gd == wd
    for g, w in zip(gl, wl):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["flagship", "stream_fm"])
def test_compile_step_on_cpu_is_the_eager_step(name):
    """On the CPU a compiled step runs the step as it is: three chained
    blocks bit-equal to the eager step, outputs and states; with steps=k
    the state after k steps and the k-th output."""
    if name == "flagship":
        jm = _jfm()
        model = fm_channelizer_from_fields(dataclasses.asdict(jm),
                                           device="cpu")
        step, state = model.step, model.init()
        re, im = _fm_signal(jm._shifts(), 3 * BLOCK)
    else:
        chain = _stream_fm(ts)
        re, im = _carrier(3 * BLOCK)
        step = chain.step
        state = chain.init(TCA(torch.from_numpy(re[:BLOCK]),
                               torch.from_numpy(im[:BLOCK])))
    _, blocks = _blocks(re, im, 3)
    compiled = compile_step(step)
    assert isinstance(compiled, CompiledStep)
    s_eager, y_eager = _chained(step, state, blocks)
    s_comp, y_comp = _chained(compiled, state, blocks)
    for g, w in zip(y_comp, y_eager):
        _assert_trees_equal(g, w)
    _assert_trees_equal(s_comp, s_eager)
    assert compiled.graphs == 0
    k3 = compile_step(step, steps=3)
    s_k, y_k = k3(state, blocks[0])
    s_w, y_w = _chained(step, state, [blocks[0]] * 3)
    _assert_trees_equal(s_k, s_w)
    _assert_trees_equal(y_k, y_w[-1])
    with pytest.raises(ValueError, match="steps"):
        compile_step(step, steps=0)


def test_compiled_flagship_matches_jax_jit():
    """jax.jit(model.step) against compile_step(model.step) over 3 chained
    blocks: audio within 2e-4 of max|audio| after the warm-up (the XLA
    path's gate; jit's fusion itself moves JAX's audio up to ~2e-5 from
    its eager step, 4e-5 of max|audio| here), the raw tail and n0 exact,
    the carries within 1e-4."""
    jm = _jfm()
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    re, im = _fm_signal(jm._shifts(), 3 * BLOCK)
    jb, tb = _blocks(re, im, 3)
    sj, yj = _chained(jax.jit(jm.step), jm.init(), jb)
    st, yt = _chained(compile_step(tm.step), tm.init(), tb)
    yj = np.concatenate([np.asarray(y) for y in yj], -1)
    yt = torch.cat(yt, -1).numpy()
    assert yt.shape == yj.shape == (4, 3 * BLOCK // 4)
    err = np.max(np.abs(yt - yj)[:, SKIP:]) / np.max(np.abs(yj)[:, SKIP:])
    assert err <= FM_TOL
    got, want = _np_leaves(st), [np.asarray(x)
                                 for x in jax.tree_util.tree_leaves(sj)]
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_compiled_am_receiver_matches_jax_jit():
    """am_d at 4 channels, jitted against compiled over 3 chained blocks:
    envelopes within ENV_ATOL, the state exact."""
    jm = _jam()
    tm = am_receiver_from_fields(dataclasses.asdict(jm), device="cpu")
    re, im = _am_signal(jm.channel_frequencies, 3 * BLOCK,
                        jm.tuning_frequency)
    jb, tb = _blocks(re, im, 3)
    sj, yj = _chained(jax.jit(jm.step), jm.init(), jb)
    st, yt = _chained(compile_step(tm.step), tm.init(), tb)
    np.testing.assert_allclose(torch.cat(yt, -1).numpy(),
                               np.concatenate([np.asarray(y) for y in yj],
                                              -1), rtol=0, atol=ENV_ATOL)
    for g, w in zip(_np_leaves(st), jax.tree_util.tree_leaves(sj)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_compiled_stream_fm_chain_matches_jax_jit():
    """The five-stage stream_fm chain, jitted against compiled over 3
    chained blocks: audio within 1e-4 of max|audio| after the warm-up, the
    states at tests/test_torch_stream.py's gates."""
    jc, tc = _stream_fm(js), _stream_fm(ts)
    re, im = _carrier(3 * BLOCK)
    jb, tb = _blocks(re, im, 3)
    sj, yj = _chained(jax.jit(jc.step), jc.init(jb[0]), jb)
    st, yt = _chained(compile_step(tc.step), tc.init(tb[0]), tb)
    yj = np.concatenate([np.asarray(y) for y in yj])
    yt = torch.cat(yt).numpy()
    assert yt.shape == yj.shape == (3 * BLOCK // 4,)
    err = np.max(np.abs(yt - yj)[SKIP:]) / np.max(np.abs(yj)[SKIP:])
    assert err <= CHAIN_TOL
    got, want = _np_leaves(st), [np.asarray(x)
                                 for x in jax.tree_util.tree_leaves(sj)]
    assert len(got) == len(want)
    assert int(got[0]) == int(want[0])                     # mixer n0
    for g, w in zip(got[1:5], want[1:5]):                  # tail, carry
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4)
    for g, w in zip(got[5:], want[5:]):                    # IIR states
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def _fm_iq_file(path, fs, n, stations, dev):
    rng = np.random.default_rng(0)
    t = np.arange(n) / fs
    rf = np.zeros(n, np.complex128)
    for fc, tone in stations:
        rf += np.exp(1j * (2 * np.pi * fc * t + (dev / tone) * np.sin(
            2 * np.pi * tone * t + rng.uniform(0, 6))))
    rf *= 0.8 / len(stations)
    inter = np.empty(2 * n, np.float32)
    inter[0::2], inter[1::2] = rf.real, rf.imag
    path.write_bytes(np.clip(np.round(inter * 127), -127, 127)
                     .astype(np.int8).tobytes())
    return path


def test_stream_runner_on_cpu_matches_jax_runner(tmp_path, monkeypatch):
    """A two-station int8 file through JAX's StreamRunner (its jitted
    step, its host runtime on numpy) and the port's with device='cpu'
    (eager, the C++ host runtime), chunks of 3000 into blocks of 4096:
    the same blocks and stats, audio within 2e-4 of max|audio| after the
    warm-up."""
    monkeypatch.setattr(jhost, "_load", lambda: None)
    path = _fm_iq_file(tmp_path / "two.iq", 256_000.0, 40_960,
                       [(40_000.0, 900.0), (-60_000.0, 1_300.0)], 4_000.0)
    jm = JFm(sample_rate=256_000.0, tuning_frequency=0.0,
             channel_frequencies=(40_000.0, -60_000.0),
             frequency_deviation=4_000.0, decimation=4,
             low_pass_taps=_lowpass(33, 0.05))
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    runner = StreamRunner(tm.step, tm.init(), block_len=BLOCK, device="cpu")
    assert runner._step == tm.step            # eager on the CPU
    src = IqFileSource(str(path), fmt="int8", chunk_samples=3000)
    outs = runner.run_file(src)
    src.close()
    jr = JRunner(jm.step, jm.init(), block_len=BLOCK)
    jsrc = JSource(str(path), fmt="int8", chunk_samples=3000)
    jouts = jr.run_file(jsrc)
    jsrc.close()
    assert len(outs) == len(jouts) == 10
    assert runner.stats == jr.stats
    got = torch.cat(outs, -1).numpy()[:, SKIP:]
    want = np.concatenate([np.asarray(o) for o in jouts], -1)[:, SKIP:]
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= FM_TOL * np.max(np.abs(want))


def test_time_step_keeps_its_api():
    """time_step(step, state, block, iters=20, reps=3) as before, with the
    eager burst behind a keyword; on the CPU a positive time for any
    setting, and iters or reps below 1 raise; device_of stays importable
    from utils.timing."""
    params = inspect.signature(timing.time_step).parameters
    assert list(params)[:5] == ["step", "state", "block", "iters", "reps"]
    assert params["iters"].default == 20 and params["reps"].default == 3
    assert params["eager"].default is False
    assert params["eager"].kind is inspect.Parameter.POSITIONAL_OR_KEYWORD
    calls = []

    def step(state, block):
        calls.append(1)
        return state + 1, block * 2.0

    for eager in (False, True):
        calls.clear()
        sec = timing.time_step(step, torch.zeros(()), torch.ones(8),
                               iters=3, reps=2, eager=eager)
        assert sec > 0 and len(calls) == 1 + 3 * 2
    for bad in ({"iters": 0}, {"reps": 0}):
        with pytest.raises(ValueError, match=">= 1"):
            timing.time_step(step, torch.zeros(()), torch.ones(8), **bad)
    assert timing.device_of(TCA(torch.ones(1), torch.ones(1))).type == "cpu"
    assert timing.device_of(None).type == "cpu"


def test_qpsk256_rx_compiles_as_a_stateless_step():
    """The table-exact QPSK256 receiver as a step with an empty state, on
    the CPU: the compiled step returns () and the modem's decisions."""
    modem = Qpsk256Modem(exact_tables=True, device="cpu")
    r = np.random.default_rng(4)
    x = TCA(torch.from_numpy(r.standard_normal(512).astype(np.float32)),
            torch.from_numpy(r.standard_normal(512).astype(np.float32)))
    state, dec = compile_step(lambda s, b: (s, modem.rx(b)))((), x)
    assert state == () and torch.equal(dec, modem.rx(x))


def test_hold_for_graph_keeps_objects_for_the_capture():
    """Inside graph_refs a held object joins that capture's list; outside
    it is kept for the process (a capture compile_step did not start)."""
    from gsdr_tpu_torch.kernels import chain

    a, b = object(), object()
    refs = []
    with graph_refs(refs):
        hold_for_graph(a)
    hold_for_graph(b)
    assert refs == [a]
    assert chain._unowned_refs.pop(id(b)) is b


def test_compile_step_refuses_a_gloo_mesh_on_cuda_blocks():
    """compile_step raises before any warm-up or capture where the step's
    mesh runs over gloo and the block lies on the card (gloo's collectives
    are host calls no CUDA graph holds): a check over the mesh's backend
    and the block's device, so a stand-in block whose device is cuda shows
    it without a card, and the step is never called. A bound method's
    object's mesh counts too; an NCCL mesh, a mesh with no process group
    and a CPU block pass the check. ``tally`` adds at once outside a
    capture."""
    import types

    from gsdr_tpu_torch.parallel.mesh import Mesh
    from gsdr_tpu_torch.utils.compile import check_capturable, tally

    def mesh(backend):
        return Mesh(1, 1, 0, {"channel": None, "time": None},
                    torch.device("cpu"), backend)

    class Step:
        def __init__(self, backend):
            self.mesh, self.calls = mesh(backend), 0

        def __call__(self, state, x):
            self.calls += 1
            return state, x

        def method(self, state, x):
            return self(state, x)

    cuda_block = types.SimpleNamespace(device=torch.device("cuda"))
    for backend in ("gloo",):
        step = Step(backend)
        for fn in (step, step.method):
            with pytest.raises(RuntimeError, match="over gloo"):
                compile_step(fn)(torch.zeros(1), cuda_block)
        assert step.calls == 0
    for backend in ("nccl", None):
        check_capturable(Step(backend), cuda_block)
    step = Step("gloo")
    check_capturable(step, torch.zeros(3))
    state, out = compile_step(step)(torch.zeros(1), torch.ones(3))
    assert step.calls == 1 and torch.equal(out, torch.ones(3))
    sent = {"all_gather": 0}
    tally(sent, "all_gather", 5)
    assert sent == {"all_gather": 5}
