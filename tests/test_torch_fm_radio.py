"""Port parity for the flagship slice: FmChannelizer and the fused-chain
contract (gsdr_tpu_torch against gsdr_tpu, JAX on CPU)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.kernels.fm_chain_pallas import fm_chain_pallas
from gsdr_tpu.pipelines import FmChannelizer as JFm
from gsdr_tpu.pipelines import fm_deemphasis_coeffs as j_deemph
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels.fm_chain import fm_chain, fm_chain_reference
from gsdr_tpu_torch.pipelines import fm_deemphasis_coeffs as t_deemph
from gsdr_tpu_torch.utils.convert import (
    fm_channelizer_from_fields,
    state_from_numpy,
    state_to_numpy,
)

FS = 1_000_000.0
BLOCK = 4096
SKIP = 256  # zero-primed warm-up outputs


def _lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def _flagship(num_channels=16, num_taps=64, decimation=4):
    """The flagship configuration of __graft_entry__._model()."""
    return JFm(
        sample_rate=FS, tuning_frequency=100_000_000.0,
        channel_frequencies=tuple(100_000_000.0 - 480_000.0 + 60_000.0 * i
                                  for i in range(num_channels)),
        frequency_deviation=75_000.0, decimation=decimation,
        low_pass_taps=_lowpass(num_taps, 0.03), impl="xla")


def _fm_signal(shifts, n, seed=7, amp=0.5):
    """Real FM carriers on every channel: white noise would put samples on
    the atan2 branch cut, where two correct implementations differ by
    2*pi*gain."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / FS
    sig = np.zeros(n, np.complex128)
    for k, f in enumerate(shifts):
        msg = np.sin(2 * np.pi * (700.0 + 370.0 * k) * t + r.uniform(0, 6))
        sig += (amp / len(shifts)) * np.exp(1j * (2 * np.pi * f * t + 0.35 * msg))
    return sig.real.astype(np.float32), sig.imag.astype(np.float32)


def _jax_state_np(state):
    n0, tail, disc, zi = state
    return (np.asarray(n0), (np.asarray(tail.re), np.asarray(tail.im)),
            (np.asarray(disc.re), np.asarray(disc.im)), np.asarray(zi))


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _stream_jax(model, state, re, im, blocks):
    outs = []
    for i in blocks:
        sl = slice(i * BLOCK, (i + 1) * BLOCK)
        state, y = model.step(state, JCA(jnp.asarray(re[sl]), jnp.asarray(im[sl])))
        outs.append(np.asarray(y))
    return state, np.concatenate(outs, axis=-1)


def _stream_torch(model, state, re, im, blocks):
    outs = []
    for i in blocks:
        sl = slice(i * BLOCK, (i + 1) * BLOCK)
        state, y = model.step(state, TCA(torch.from_numpy(re[sl]),
                                         torch.from_numpy(im[sl])))
        outs.append(y.numpy())
    return state, np.concatenate(outs, axis=-1)


def _assert_states_close(st_t, st_j):
    t_np, j_np = state_to_numpy(st_t), _jax_state_np(st_j)
    assert int(t_np[0]) == int(j_np[0])
    np.testing.assert_array_equal(t_np[1][0], j_np[1][0])   # raw RF tail
    np.testing.assert_array_equal(t_np[1][1], j_np[1][1])
    np.testing.assert_allclose(t_np[2][0], j_np[2][0], atol=1e-4)
    np.testing.assert_allclose(t_np[2][1], j_np[2][1], atol=1e-4)
    np.testing.assert_allclose(t_np[3], j_np[3], atol=1e-4)


@pytest.mark.parametrize("tau,rate", [(75e-6, 250_000.0), (50e-6, 48_000.0),
                                      (90e-6, 4000.0)])
def test_deemphasis_coeffs_equal(tau, rate):
    assert t_deemph(tau, rate) == j_deemph(tau, rate)


def test_deemphasis_unstable_tau_raises():
    with pytest.raises(ValueError, match="unstable"):
        t_deemph(75e-6, 4000.0)


def test_flagship_stream_matches_jax_xla():
    """C=16, T=64, D=4 over 4 streamed blocks; measured max-abs/max|audio|
    is ~1e-6 (libm atan2 and conv summation order), held to 1e-4."""
    jm = _flagship()
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    assert tm.impl == "torch"
    re, im = _fm_signal(jm._shifts(), 4 * BLOCK)
    sj, yj = _stream_jax(jm, jm.init(), re, im, range(4))
    st, yt = _stream_torch(tm, tm.init(), re, im, range(4))
    assert yt.shape == yj.shape == (16, 4 * BLOCK // 4)
    assert _rel(yt, yj) <= 1e-4
    _assert_states_close(st, sj)


def test_midstream_handoff_from_jax():
    """A JAX state taken after block 2 continues identically in the port."""
    jm = _flagship()
    re, im = _fm_signal(jm._shifts(), 4 * BLOCK, seed=11)
    sj, _ = _stream_jax(jm, jm.init(123_456), re, im, range(2))
    sj_end, yj = _stream_jax(jm, sj, re, im, range(2, 4))
    tm = fm_channelizer_from_fields(
        dataclasses.asdict(dataclasses.replace(jm, impl="auto")), device="cpu")
    st = state_from_numpy(_jax_state_np(sj), "cpu")
    st_end, yt = _stream_torch(tm, st, re, im, range(2, 4))
    assert _rel(yt, yj) <= 1e-4
    _assert_states_close(st_end, sj_end)


def test_block_invariance_and_impls_on_cpu():
    jm = _flagship(num_channels=4, num_taps=33)
    auto = fm_channelizer_from_fields(
        dataclasses.asdict(dataclasses.replace(jm, impl="auto")), device="cpu")
    plain = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    re, im = _fm_signal(jm._shifts(), 2 * BLOCK, seed=5)
    _, y_one = auto.step(auto.init(), TCA(torch.from_numpy(re), torch.from_numpy(im)))
    _, y_two = _stream_torch(plain, plain.init(), re, im, range(2))
    assert _rel(y_one.numpy(), y_two) < 1e-5
    with pytest.raises(ValueError, match="multiple of decimation"):
        auto.step(auto.init(), TCA(torch.zeros(10), torch.zeros(10)))


@pytest.mark.parametrize("n", [5000, 1024])
def test_fm_chain_reference_matches_jax_fused_interpret(n):
    """The plain chain against the JAX fused kernel in interpret mode at a
    small shape, over two steps with the carries each side exported."""
    jm = JFm(sample_rate=FS, tuning_frequency=0.0,
             channel_frequencies=(100_000.0, -50_000.0, 37_000.0),
             frequency_deviation=75_000.0, decimation=4,
             low_pass_taps=_lowpass(32, 0.04), precision="f32")
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    re, im = _fm_signal(jm._shifts(), n, seed=3, amp=0.9)
    t, fs = jm.num_taps, int(FS)
    b, a = jm._deemph()
    jstate, tstate = jm.init(), tm.init()
    for step in range(2):
        n0, tail, cf, cz = jstate
        buf = JCA(jnp.concatenate([tail.re, jnp.asarray(re)]),
                  jnp.concatenate([tail.im, jnp.asarray(im)]))
        rot0 = (n0 + jnp.int32(fs - (t - 1) % fs)) % fs
        yj, cfj, czj = fm_chain_pallas(
            buf, jm._tap_bank(), jm._lo_table(), rot0, 4, jm.gain, b, a, cf,
            cz, shifts_hz=tuple(jm._shifts()), sample_rate=FS,
            precision="f32", interpret=True)
        tn0, ttail, tcf, tcz = tstate
        tbuf = TCA(torch.cat([ttail.re, torch.from_numpy(re)]),
                   torch.cat([ttail.im, torch.from_numpy(im)]))
        trot0 = torch.remainder(tn0 + (fs - (t - 1) % fs), fs).to(torch.int32)
        yt, cft, czt = fm_chain_reference(tbuf, tm.tap_bank, tm.lo_table, trot0,
                                          4, tm.gain, tm.deemph, tcf, tcz)
        assert tuple(yt.shape) == yj.shape == (3, n // 4)
        # step 1 starts zero-primed: atan2 of the first product (+-0, -0)
        # reads +-pi in the plain chain and 0 in the fused kernel, and the
        # de-emphasis carries that for a few hundred outputs (bench.py:101)
        skip = SKIP if step == 0 else 0
        if yt.shape[-1] > skip:
            assert _rel(yt.numpy()[:, skip:], np.asarray(yj)[:, skip:]) < 2e-4
        np.testing.assert_allclose(cft.re.numpy(), np.asarray(cfj.re), atol=2e-4)
        np.testing.assert_allclose(cft.im.numpy(), np.asarray(cfj.im), atol=2e-4)
        np.testing.assert_allclose(czt.numpy(), np.asarray(czj), atol=2e-4)
        jstate = ((n0 + n % fs) % fs, buf[..., buf.shape[-1] - (t - 1):], cfj, czj)
        tstate = (torch.remainder(tn0 + n % fs, fs).to(torch.int32),
                  tbuf[..., tbuf.shape[-1] - (t - 1):], cft, czt)


def test_fm_chain_wrapper_takes_plain_version_on_cpu():
    jm = _flagship(num_channels=3, num_taps=16)
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    re, im = _fm_signal(jm._shifts(), 1024 + 15, seed=9)
    buf = TCA(torch.from_numpy(re), torch.from_numpy(im))
    n0, _, cf, cz = tm.init()
    args = (buf, tm.tap_bank, tm.lo_table, n0, 4, tm.gain, tm.deemph, cf, cz)
    before = fm_chain.launches
    got, want = fm_chain(*args), fm_chain_reference(*args)
    assert fm_chain.launches == before  # no kernel launched for CPU tensors
    for g, w in zip((got[0], got[1].re, got[2]), (want[0], want[1].re, want[2])):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
