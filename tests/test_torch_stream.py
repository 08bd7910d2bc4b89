"""Port parity: the streaming layer (gsdr_tpu_torch.stream) against
gsdr_tpu.stream on the same numpy inputs, on the CPU: every stage on the
cases of tests/test_stream.py, the single-station FM receiver chain,
state hand-offs between the packages through numpy, scan_stream and a
checkpoint resume."""

import dataclasses
import math
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.signal as ss
import torch

import gsdr_tpu.stream as js
import gsdr_tpu_torch.stream as ts
from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.ops.iir import iir as j_iir
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.pipelines import fm_deemphasis_coeffs
from gsdr_tpu_torch.utils.convert import (
    chain_from_fields,
    chain_state_from_numpy,
    chain_state_to_numpy,
    stream_stage_from_fields,
)

# the LO's float32 phase is bounded at ~6e-5 cycles in either package
# (utils/phase.py); a mixed sample may differ by 2*pi*6e-5*|x| + 2e-5
PHASE_BOUND = 6e-5
TRIG_ATOL = 2e-5
SKIP = 256  # zero-primed warm-up outputs of the FM chain


def _planar(n, lead=(), seed=0):
    """(jax planar, torch planar, complex128) of complex Gaussian noise."""
    r = np.random.default_rng(seed)
    z = (r.standard_normal(lead + (n,))
         + 1j * r.standard_normal(lead + (n,))).astype(np.complex64)
    re, im = np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)
    return (JCA(jnp.asarray(re), jnp.asarray(im)),
            TCA(torch.from_numpy(re), torch.from_numpy(im)),
            z.astype(np.complex128))


def _np(y):
    if isinstance(y, TCA):
        return y.to_numpy()
    if isinstance(y, JCA):
        return np.asarray(y.re) + 1j * np.asarray(y.im)
    if isinstance(y, torch.Tensor):
        return y.numpy()
    return np.asarray(y)


def _blocks(x, block_len):
    return [x[..., i * block_len:(i + 1) * block_len]
            for i in range(x.shape[-1] // block_len)]


def _run(op, state, blocks):
    outs = []
    for blk in blocks:
        state, y = op.step(state, blk)
        outs.append(_np(y))
    return state, np.concatenate(outs, axis=-1)


def _jax_np(state):
    """A JAX chain or stage state as numpy leaves."""
    if isinstance(state, tuple):
        return tuple(_jax_np(s) for s in state)
    if isinstance(state, JCA):
        return (np.asarray(state.re), np.asarray(state.im))
    return np.asarray(state)


def _jax_from_np(states_np):
    return tuple(JCA(jnp.asarray(l[0]), jnp.asarray(l[1]))
                 if isinstance(l, tuple) else jnp.asarray(l)
                 for l in states_np)


# ---------------------------------------------------------------------------
# MixerStream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f,fs,n0,bl", [(12_345.0, 1e6, 0, 512),
                                        (777.0, 10_000.0, 9_000, 4096),
                                        (0.5, 1000.0, 0, 1500)])
def test_mixer_stream_matches_jax(f, fs, n0, bl):
    """The stream and its carried n0 against JAX's over blocks that cross
    the wrap; samples within the LO phase bound."""
    jop, top = js.MixerStream(f, fs), ts.MixerStream(f, fs)
    assert top._wrap_modulus() == jop._wrap_modulus()
    jx, tx, z = _planar(6000 if bl == 1500 else 4096, seed=1)
    sj, yj = _run(jop, jop.init(n0), _blocks(jx, bl))
    st, yt = _run(top, top.init(n0, device="cpu"), _blocks(tx, bl))
    assert st.dtype == torch.int32 and int(st) == int(sj)
    assert np.all(np.abs(yt - yj)
                  <= 2 * np.pi * PHASE_BOUND * np.abs(z) + TRIG_ATOL)
    # complex64 in, complex64 out
    st2, yc = top.step(top.init(n0, device="cpu"), tx.to_complex())
    assert yc.dtype == torch.complex64
    np.testing.assert_array_equal(yc.numpy(), top.step(
        top.init(n0, device="cpu"), tx)[1].to_numpy().astype(np.complex64))


@pytest.mark.parametrize("f,fs", [(0.5, 1000.0), (1.0, 20_000_000.0),
                                  (0.125, 48_000.0), (-100_000.0, 1e6),
                                  (1000.0, 0.0)])
def test_mixer_wrap_modulus_matches_jax(f, fs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jop, top = js.MixerStream(f, fs), ts.MixerStream(f, fs)
    assert top._wrap_modulus() == jop._wrap_modulus()
    assert top._wrap_is_exact() == jop._wrap_is_exact()


def test_mixer_warnings_match_jax():
    with pytest.warns(UserWarning, match="APPROXIMATE"):
        ts.MixerStream(freq_shift_hz=0.1, sample_rate=1000.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        op = ts.MixerStream(freq_shift_hz=1.0, sample_rate=20_000_000.0)
        ts.MixerStream(freq_shift_hz=-100_000.0, sample_rate=1e6)
    assert op._wrap_modulus() == 20_000_000 and op._wrap_is_exact()


# ---------------------------------------------------------------------------
# FirStream, IirStream, SosStream, QuadFmStream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dec", [1, 2, 4])
def test_fir_stream_matches_jax(dec):
    taps = tuple(np.random.default_rng(2).standard_normal(33)
                 .astype(np.float32).tolist())
    jop, top = js.FirStream(taps, dec), ts.FirStream(taps, dec)
    assert top.warmup_outputs == jop.warmup_outputs
    jx, tx, _ = _planar(2048, lead=(3,), seed=3)
    sj, yj = _run(jop, jop.init(jx[..., :256]), _blocks(jx, 256))
    st, yt = _run(top, top.init(tx[..., :256]), _blocks(tx, 256))
    assert yt.shape == yj.shape == (3, 2048 // dec)
    # float32 sums of 33 products in another order
    np.testing.assert_allclose(yt, yj, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(_np(st), _np(sj))   # the raw input tail


def test_fir_stream_real_signal_and_decimation_phase():
    taps = tuple(np.ones(8, np.float32) / 8.0)
    top = ts.FirStream(taps, 4)
    x = np.random.default_rng(4).standard_normal(512).astype(np.float32)
    st, y = _run(top, top.init(torch.from_numpy(x[:256])),
                 _blocks(torch.from_numpy(x), 256))
    want = np.convolve(np.concatenate([np.zeros(7), x]), np.ones(8) / 8.0,
                       "valid")[::4]
    np.testing.assert_allclose(y, want, atol=1e-5)
    with pytest.raises(ValueError, match="multiple"):
        top.step(st, torch.zeros(6))


@pytest.mark.parametrize("planar", [False, True])
def test_iir_stream_matches_jax(planar):
    b, a = (0.2, 0.3, 0.1), (1.0, -0.4, 0.2)
    jop, top = js.IirStream(b, a), ts.IirStream(b, a)
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 1024)).astype(np.float32)
    if planar:
        xi = r.standard_normal((2, 1024)).astype(np.float32)
        jx = JCA(jnp.asarray(x), jnp.asarray(xi))
        tx = TCA(torch.from_numpy(x), torch.from_numpy(xi))
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    sj, yj = _run(jop, jop.init(jx[..., :128]), _blocks(jx, 128))
    st, yt = _run(top, top.init(tx[..., :128]), _blocks(tx, 128))
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(_np(st), _np(sj), rtol=1e-5, atol=2e-5)
    if not planar:   # and the single shot
        want = np.asarray(j_iir(jnp.asarray(b), jnp.asarray(a), jnp.asarray(x)))
        np.testing.assert_allclose(yt, want, rtol=2e-4, atol=1e-5)


def test_sos_stream_matches_jax():
    sos = tuple(tuple(r) for r in ss.butter(6, 0.2, output="sos").tolist())
    jop, top = js.SosStream(sos), ts.SosStream(sos, block_len=64)
    x = np.random.default_rng(6).standard_normal(1500).astype(np.float32)
    sj, yj = _run(jop, jop.init(jnp.asarray(x)), _blocks(jnp.asarray(x), 500))
    st, yt = _run(top, top.init(torch.from_numpy(x)),
                  _blocks(torch.from_numpy(x), 500))
    assert tuple(st.shape) == (3, 2)
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=2e-5)


def test_quad_fm_stream_matches_jax():
    jop, top = js.QuadFmStream(2.5), ts.QuadFmStream(2.5)
    # a slowly turning phasor, clear of the atan2 branch cut
    t = np.arange(1024)
    z = (0.7 + 0.2 * np.sin(t / 50.0)) * np.exp(1j * (0.3 * np.sin(t / 40.0) + t * 0.01))
    re, im = z.real.astype(np.float32), z.imag.astype(np.float32)
    jx = JCA(jnp.asarray(re), jnp.asarray(im))
    tx = TCA(torch.from_numpy(re), torch.from_numpy(im))
    sj, yj = _run(jop, jop.init(jx[..., :256]), _blocks(jx, 256))
    st, yt = _run(top, top.init(tx[..., :256]), _blocks(tx, 256))
    assert yt.shape == (1024,) and yt[0] == 0.0
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-6)
    # complex64 blocks take the same discriminator
    _, yc = _run(top, top.init(tx.to_complex()[:256]),
                 _blocks(tx.to_complex(), 256))
    np.testing.assert_allclose(yc, yt, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Chains
# ---------------------------------------------------------------------------

def _mix_fir_disc(pkg):
    taps = tuple((np.ones(16, np.float32) / 16.0).tolist())
    return pkg.Chain(stages=(pkg.MixerStream(1000.0, 48_000.0),
                             pkg.FirStream(taps, 2),
                             pkg.QuadFmStream(1.0)))


def test_chain_matches_jax():
    jc, tc = _mix_fir_disc(js), _mix_fir_disc(ts)
    t = np.arange(2048)
    z = np.exp(1j * (2 * np.pi * 0.02 * t + 0.5 * np.sin(2 * np.pi * t / 300.0)))
    re, im = z.real.astype(np.float32), z.imag.astype(np.float32)
    jx = JCA(jnp.asarray(re), jnp.asarray(im))
    tx = TCA(torch.from_numpy(re), torch.from_numpy(im))
    sj, yj = _run(jc, jc.init(jx[..., :512]), _blocks(jx, 512))
    st, yt = _run(tc, tc.init(tx[..., :512]), _blocks(tx, 512))
    assert yt.shape == yj.shape == (1024,)
    np.testing.assert_allclose(yt[1:], yj[1:], atol=5e-4)
    assert int(st[0]) == int(sj[0])


def test_state_is_checkpointable():
    """A chain state saved to numpy and restored resumes bit for bit."""
    tc = _mix_fir_disc(ts)
    _, tx, _ = _planar(1024, seed=7)
    blocks = _blocks(tx, 256)
    st = tc.init(blocks[0])
    st, _ = tc.step(st, blocks[0])
    snapshot = chain_state_to_numpy(st)
    _, y_direct = tc.step(st, blocks[1])
    _, y_restored = tc.step(chain_state_from_numpy(snapshot, "cpu"), blocks[1])
    np.testing.assert_array_equal(y_direct.numpy(), y_restored.numpy())


def test_scan_stream_matches_run_stream():
    tc = ts.Chain(stages=(ts.MixerStream(1000.0, 48_000.0),
                          ts.FirStream(tuple((np.ones(16) / 16.0).tolist()), 2)))
    _, tx, _ = _planar(4096, seed=8)
    stacked = TCA(tx.re.reshape(8, 512), tx.im.reshape(8, 512))
    st0 = tc.init(tx[..., :512])
    st, outs = ts.run_stream(tc, st0, _blocks(tx, 512))
    st2, got = ts.scan_stream(tc.step, st0, stacked)
    assert tuple(got.shape) == (8, 256)
    np.testing.assert_array_equal(got.re.numpy(), torch.stack([o.re for o in outs]).numpy())
    np.testing.assert_array_equal(got.im.numpy(), torch.stack([o.im for o in outs]).numpy())
    assert int(st2[0]) == int(st[0])
    np.testing.assert_array_equal(st2[1].re.numpy(), st[1].re.numpy())


# ---------------------------------------------------------------------------
# The single-station FM receiver (chip_smoke.py's stream_fm) at a small size
# ---------------------------------------------------------------------------

FS = 1_000_000.0
BLOCK = 1 << 12


def _lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def _stream_fm(pkg):
    rate = FS / 4
    b, a = fm_deemphasis_coeffs(75e-6, rate)
    sos = tuple(tuple(r) for r in ss.butter(8, 15e3, fs=rate, output="sos").tolist())
    return pkg.Chain(stages=(
        pkg.MixerStream(freq_shift_hz=-100_000.0, sample_rate=FS),
        pkg.FirStream(taps=_lowpass(64, 0.03), decimation=4),
        pkg.QuadFmStream(gain=rate / (2 * math.pi * 75_000.0)),
        pkg.IirStream(b, a),
        pkg.SosStream(sos)))


def _fm_blocks(n_blocks):
    """An FM carrier at +100 kHz, a 1-kHz tone at 10-kHz deviation (inside
    the 30-kHz low-pass: a real carrier keeps the discriminator off the
    atan2 branch cut), as (jax, torch) planar blocks."""
    t = np.arange(n_blocks * BLOCK) / FS
    z = np.exp(1j * (2 * np.pi * 100_000.0 * t + 10.0 * np.sin(2 * np.pi * 1000.0 * t)))
    re, im = z.real.astype(np.float32), z.imag.astype(np.float32)
    jb = _blocks(JCA(jnp.asarray(re), jnp.asarray(im)), BLOCK)
    tb = _blocks(TCA(torch.from_numpy(re), torch.from_numpy(im)), BLOCK)
    return jb, tb


def _assert_fm_states_close(st_t, st_j):
    t_np, j_np = chain_state_to_numpy(st_t), _jax_np(st_j)
    assert int(t_np[0]) == int(j_np[0])                      # mixer n0
    for r in range(2):                                      # FIR tail, disc carry
        np.testing.assert_allclose(t_np[1][r], j_np[1][r], atol=2e-4)
        np.testing.assert_allclose(t_np[2][r], j_np[2][r], atol=2e-4)
    np.testing.assert_allclose(t_np[3], j_np[3], atol=1e-4)   # de-emphasis zi
    np.testing.assert_allclose(t_np[4], j_np[4], atol=1e-4)   # SOS (4, 2)


def test_stream_fm_chain_matches_jax():
    """The five-stage receiver over 4 blocks of 2^12 samples, held to 1e-4
    of max|audio| after the warm-up (the FM parity rule of ROADMAP C)."""
    jc, tc = _stream_fm(js), _stream_fm(ts)
    assert chain_from_fields([(type(s).__name__, dataclasses.asdict(s))
                              for s in jc.stages]) == tc
    jb, tb = _fm_blocks(4)
    sj, yj = _run(jc, jc.init(jb[0]), jb)
    st, yt = _run(tc, tc.init(tb[0]), tb)
    assert yt.shape == yj.shape == (4 * BLOCK // 4,)
    err = np.max(np.abs(yt - yj)[SKIP:]) / np.max(np.abs(yj)[SKIP:])
    assert err <= 1e-4
    _assert_fm_states_close(st, sj)


def test_stream_fm_state_hands_off_both_ways():
    """A state taken after 2 blocks continues in the other package: JAX to
    the port and the port to JAX, each equal to staying put within the
    parity tolerance."""
    jc, tc = _stream_fm(js), _stream_fm(ts)
    jb, tb = _fm_blocks(4)
    sj, _ = _run(jc, jc.init(jb[0], first_sample_index=123_456), jb[:2])
    st, _ = _run(tc, tc.init(tb[0], first_sample_index=123_456), tb[:2])
    sj_end, yj = _run(jc, sj, jb[2:])
    st_end, yt = _run(tc, st, tb[2:])
    # JAX -> port
    sx_end, yx = _run(tc, chain_state_from_numpy(_jax_np(sj), "cpu"), tb[2:])
    scale = np.max(np.abs(yj))
    assert np.max(np.abs(yx - yj)) <= 1e-4 * scale
    _assert_fm_states_close(sx_end, sj_end)
    # port -> JAX
    sy_end, yy = _run(jc, _jax_from_np(chain_state_to_numpy(st)), jb[2:])
    assert np.max(np.abs(yy - yt)) <= 1e-4 * scale
    _assert_fm_states_close(st_end, sy_end)


def test_stream_stage_from_fields():
    stage = stream_stage_from_fields(
        "IirStream", {"b": (np.float32(0.5), 0.5), "a": [1.0, np.float64(-0.2)],
                      "block_len": 64})
    assert stage == ts.IirStream((0.5, 0.5), (1.0, -0.2), 64)
    with pytest.raises(NotImplementedError):
        stream_stage_from_fields("ResampleStream", {})
