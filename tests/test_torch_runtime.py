"""Port parity for the deployment path: the native host runtime (the C++
of native/src, built by the port) against its numpy versions and JAX's
functions, checkpoints across the packages, the stream runner, the fm_rx
command line, and the timing and profiling helpers (JAX on CPU; JAX's
host runtime on its numpy versions, so that no test here runs its make)."""

import dataclasses

import numpy as np
import pytest
import torch

from jax.tree_util import tree_leaves

import gsdr_tpu.runtime.host as jhost
from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.pipelines import AmReceiver as JAm
from gsdr_tpu.pipelines import FmChannelizer as JFm
from gsdr_tpu.runtime import IqFileSource as JSource
from gsdr_tpu.runtime import StreamRunner as JRunner
from gsdr_tpu.tools import fm_rx as jfm_rx
from gsdr_tpu.utils import checkpoint as jckpt
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels import _build
from gsdr_tpu_torch.runtime import host
from gsdr_tpu_torch.runtime import (
    Framer,
    HostLib,
    IqFileSource,
    RingBuffer,
    StreamRunner,
    int8_iq_to_planar,
    int16_iq_to_planar,
    native_available,
    pack_2bit,
    unpack_2bit,
)
from gsdr_tpu_torch.tools import fm_rx
from gsdr_tpu_torch.utils import checkpoint as tckpt
from gsdr_tpu_torch.utils.convert import (
    am_receiver_from_fields,
    fm_channelizer_from_fields,
)
from gsdr_tpu_torch.utils.profiling import throughput_report, trace

RNG = np.random.default_rng(5)
SKIP = 256  # zero-primed warm-up outputs
# FM audio, of max|audio| after the warm-up: the parity gate of
# tests/test_torch_fm_radio.py
FM_TOL = 2e-4


@pytest.fixture
def jax_numpy_host(monkeypatch):
    """JAX's host runtime on its numpy versions: no make of native/."""
    monkeypatch.setattr(jhost, "_load", lambda: None)


def _lowpass(num_taps, cutoff):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def _fm_iq_file(path, fs, n, stations, dev=3000.0, seed=0):
    """An int8 IQ capture of FM stations ((carrier, tone) pairs)."""
    rng = np.random.default_rng(seed)
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


# ---------------------------------------------------------------------------
# The native host runtime
# ---------------------------------------------------------------------------

def test_native_library_builds_into_the_port_build_dir():
    assert native_available()
    assert _build.host_library_path().exists()
    assert _build.host_library_path().parent == _build.BUILD_DIR
    assert HostLib.get() is HostLib.get()
    assert RingBuffer(16).native


def test_build_failure_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """A host library that does not compile makes every native entry point
    raise; only native=False runs the numpy versions."""
    (tmp_path / "gsdr_host.cc").write_text("this is not C++\n")
    (tmp_path / "gsdr_host.h").write_text("\n")
    monkeypatch.setattr(_build, "HOST_SRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    host._library.cache_clear()
    try:
        assert not native_available()
        with pytest.raises(RuntimeError, match="failed to build"):
            RingBuffer(16)
        with pytest.raises(RuntimeError, match="failed to build"):
            int8_iq_to_planar(np.zeros(4, np.int8))
        with pytest.raises(RuntimeError, match="failed to build"):
            StreamRunner(lambda s, x: (s, x), None, 64, device="cpu")
        assert not RingBuffer(16, native=False).native
        re, _ = int8_iq_to_planar(np.array([127, 0], np.int8), native=False)
        assert re[0] == 1.0
    finally:
        monkeypatch.undo()
        host._library.cache_clear()
    assert native_available()


def _ring_trace(ring):
    """Writes and reads with wrap-around and back-pressure."""
    rng = np.random.default_rng(1)
    log = []
    for _ in range(10):
        chunk = rng.standard_normal(180).astype(np.float32)
        log.append(ring.write(chunk))
        re, im = ring.read_planar(70)
        log += [re.copy(), im.copy(), ring.readable]
    re, im = ring.read_planar(ring.readable)
    return log + [re, im]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_ring_buffer_matches_numpy_and_jax(jax_numpy_host):
    native = _ring_trace(RingBuffer(200))
    assert RingBuffer(200).capacity == RingBuffer(200, native=False).capacity
    _same(native, _ring_trace(RingBuffer(200, native=False)))
    _same(native, _ring_trace(jhost.RingBuffer(256)))


def _frames(ring, framer):
    ring.write(np.random.default_rng(2).standard_normal(2 * 520)
               .astype(np.float32))
    return list(iter(lambda: framer.next(ring), None))


def test_framer_matches_numpy_and_jax(jax_numpy_host):
    native = _frames(RingBuffer(4096), Framer(128, 16))
    assert len(native) == 4 and [b[2] for b in native] == [0, 128, 256, 384]
    np.testing.assert_array_equal(native[0][0][:16], np.zeros(16))
    np.testing.assert_array_equal(native[1][0][:16], native[0][0][-16:])
    for other in (_frames(RingBuffer(4096, native=False),
                          Framer(128, 16, native=False)),
                  _frames(jhost.RingBuffer(4096), jhost.Framer(128, 16))):
        _same([x for b in native for x in b], [x for b in other for x in b])
    with pytest.raises(ValueError, match="native RingBuffer"):
        Framer(8, 2).next(RingBuffer(64, native=False))


def test_staging_and_packing_match_numpy_and_jax(jax_numpy_host):
    i8 = np.arange(-128, 128, dtype=np.int8).repeat(3)
    i16 = np.concatenate([[-32768, -32767, 32767, 0],
                          RNG.integers(-32768, 32768, 2000)]).astype(np.int16)
    for fn, jfn, data in ((int8_iq_to_planar, jhost.int8_iq_to_planar, i8),
                          (int16_iq_to_planar, jhost.int16_iq_to_planar,
                           i16)):
        got = fn(data)
        _same(got, fn(data, native=False))
        # JAX's numpy int16 divides where the C++ multiplies by 1/32767:
        # one float32 rounding apart
        for g, w in zip(got, jfn(data)):
            np.testing.assert_allclose(g, w, rtol=1.2e-7, atol=0)
    np.testing.assert_array_equal(int8_iq_to_planar(i8)[0],
                                  jhost.int8_iq_to_planar(i8)[0])
    syms = RNG.integers(0, 4, 333).astype(np.uint8)
    packed = pack_2bit(syms)
    _same([packed], [pack_2bit(syms, native=False)])
    _same([packed], [jhost.pack_2bit(syms)])
    assert pack_2bit(np.array([1, 2, 3, 0, 3, 3], np.uint8)).tolist() == \
        [0b00111001, 0b00001111]
    for nat in (True, False):
        np.testing.assert_array_equal(unpack_2bit(packed, 333, native=nat),
                                      syms)


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

def _jax_models():
    fm = JFm(sample_rate=100_000.0, tuning_frequency=0.0,
             channel_frequencies=(10_000.0, -20_000.0),
             frequency_deviation=5_000.0, decimation=4,
             low_pass_taps=_lowpass(33, 0.05))
    am = JAm(sample_rate=100_000.0, tuning_frequency=0.0,
             channel_frequencies=(10_000.0, -20_000.0, 30_000.0),
             decimation=4, low_pass_taps=_lowpass(32, 0.05))
    return fm, am


def _leaves(state):
    return [np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                       else v) for _, v in tckpt.flatten_with_keys(state)]


@pytest.mark.parametrize("which", ["fm", "am"])
def test_checkpoints_cross_load_bit_exactly(tmp_path, which):
    """A mid-stream state saved by JAX loads in the port and the reverse,
    every leaf bit-equal, under the same keys."""
    jm = dict(zip(("fm", "am"), _jax_models()))[which]
    make = fm_channelizer_from_fields if which == "fm" \
        else am_receiver_from_fields
    tm = make(dataclasses.asdict(jm), device="cpu")
    z = (RNG.standard_normal(2000) + 1j * RNG.standard_normal(2000))
    z = z.astype(np.complex64)
    jstate, _ = jm.step(jm.init(), JCA.from_complex(z))
    tstate, _ = tm.step(tm.init(), TCA.from_complex(z))

    jckpt.save_state(tmp_path / "j.npz", jstate)
    got = tckpt.load_state(tmp_path / "j.npz", tm.init())
    _same(_leaves(got), [np.asarray(x) for x in tree_leaves(jstate)])
    assert got[0].dtype == torch.int32 and isinstance(got[1], TCA)

    tckpt.save_state(tmp_path / "t.npz", tstate)
    back = jckpt.load_state(tmp_path / "t.npz", jm.init())
    _same([np.asarray(x) for x in tree_leaves(back)], _leaves(tstate))
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)


def test_checkpoint_resumes_and_rejects_mismatches(tmp_path):
    jm, _ = _jax_models()
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    rf = TCA.from_complex((RNG.standard_normal(4096)
                           + 1j * RNG.standard_normal(4096))
                          .astype(np.complex64))
    st, _ = tm.step(tm.init(), rf[..., :2048])
    tckpt.save_state(tmp_path / "s.npz", st)
    restored = tckpt.load_state(tmp_path / "s.npz", tm.init())
    _, y1 = tm.step(st, rf[..., 2048:])
    _, y2 = tm.step(restored, rf[..., 2048:])
    assert torch.equal(y1, y2)
    one = fm_channelizer_from_fields(
        dict(dataclasses.asdict(jm), channel_frequencies=(10_000.0,)),
        device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_state(tmp_path / "s.npz", one.init())
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.load_state(tmp_path / "s.npz", (*tm.init(), 7))


# ---------------------------------------------------------------------------
# The stream runner and fm_rx
# ---------------------------------------------------------------------------

def _fm_close(got, want, skip):
    got, want = got[..., skip:], want[..., skip:]
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= FM_TOL * np.max(np.abs(want))


def test_stream_runner_matches_jax(tmp_path, jax_numpy_host):
    """int8 IQ file -> runner -> FmChannelizer, chunks of 5000 into blocks
    of 8192, against JAX's runner on the same file."""
    path = _fm_iq_file(tmp_path / "x.iq", 256_000.0, 1 << 16,
                       [(50_000.0, 1_000.0)], dev=4_000.0)
    jm = JFm(sample_rate=256_000.0, tuning_frequency=0.0,
             channel_frequencies=(50_000.0,), frequency_deviation=4_000.0,
             decimation=4, low_pass_taps=_lowpass(65, 0.04))
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    runner = StreamRunner(tm.step, tm.init(), block_len=8192, device="cpu")
    src = IqFileSource(str(path), fmt="int8", chunk_samples=5000)
    outs = runner.run_file(src)
    src.close()
    jr = JRunner(jm.step, jm.init(), block_len=8192)
    jsrc = JSource(str(path), fmt="int8", chunk_samples=5000)
    jouts = jr.run_file(jsrc)
    jsrc.close()
    assert len(outs) == len(jouts) == 8
    assert runner.stats == jr.stats
    got = torch.cat(outs, dim=-1).numpy()
    _fm_close(got, np.concatenate([np.asarray(o) for o in jouts], -1), SKIP)
    with pytest.raises(RuntimeError, match="ring overflow"):
        runner.feed_planar(np.zeros(5 * 8192, np.float32),
                           np.zeros(5 * 8192, np.float32))


def _run_fm_rx(main, tmp_path, name, extra):
    out = tmp_path / name
    main([str(tmp_path / "cap.iq"), "-o", str(out), "--fs", "128000",
          "--channels", "20000,-30000", "--deviation", "3000",
          "--decim", "4", "--taps", "65", "--block", "8192", *extra])
    return np.frombuffer(out.read_bytes(), np.float32)


@pytest.mark.parametrize("audio_rate", [None, "48000"])
def test_fm_rx_matches_jax(tmp_path, jax_numpy_host, audio_rate):
    """The port's fm_rx on the CPU and JAX's on the same 2-channel int8
    capture, with and without the 48-kHz resampler: frames interleaved
    alike, audio within the FM parity gate."""
    _fm_iq_file(tmp_path / "cap.iq", 128_000.0, 1 << 15,
                [(20_000.0, 800.0), (-30_000.0, 1_300.0)])
    extra = ["--audio-rate", audio_rate] if audio_rate else []
    got = _run_fm_rx(fm_rx.main, tmp_path, "t.f32", extra + ["--device",
                                                              "cpu"])
    want = _run_fm_rx(jfm_rx.main, tmp_path, "j.f32", extra)
    if not audio_rate:
        assert len(got) == 2 * (1 << 15) // 4
    got, want = got.reshape(-1, 2).T, want.reshape(-1, 2).T
    _fm_close(got, want, SKIP if not audio_rate else 3 * SKIP // 2)


def test_fm_rx_resume_is_bit_equal(tmp_path):
    """Two halves of a capture, the state saved after the first and loaded
    for the second, give the whole file's audio bit for bit."""
    _fm_iq_file(tmp_path / "cap.iq", 128_000.0, 1 << 15,
                [(20_000.0, 800.0), (-30_000.0, 1_300.0)])
    whole = _run_fm_rx(fm_rx.main, tmp_path, "w.f32", ["--device", "cpu"])
    raw = (tmp_path / "cap.iq").read_bytes()
    full = tmp_path / "cap.iq"
    (tmp_path / "all.iq").write_bytes(raw)
    state = tmp_path / "st.npz"
    full.write_bytes(raw[:len(raw) // 2])
    first = _run_fm_rx(fm_rx.main, tmp_path, "a.f32",
                       ["--device", "cpu", "--save-state", str(state)])
    full.write_bytes(raw[len(raw) // 2:])
    second = _run_fm_rx(fm_rx.main, tmp_path, "b.f32",
                        ["--device", "cpu", "--load-state", str(state)])
    np.testing.assert_array_equal(np.concatenate([first, second]), whole)


# ---------------------------------------------------------------------------
# Timing and profiling
# ---------------------------------------------------------------------------

def test_throughput_report_and_trace(tmp_path):
    def step(st, x):
        return st + x.sum() * 1e-30, x * 2.0

    rep = throughput_report(step, torch.zeros(()), torch.ones(1024),
                            samples_per_step=1024, iters=3, label="x2")
    assert rep["label"] == "x2" and rep["backend"] == "cpu"
    assert rep["samples_per_second"] > 0
    assert rep["msamples_per_second"] == rep["samples_per_second"] / 1e6
    assert rep["timing_resolved"] is True and rep["iters"] == 3
    with trace(tmp_path / "tr"):
        step(torch.zeros(()), torch.ones(16))
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
