"""Port parity for FmChannelizer and the fused-chain contract, dense and
PFB fronts (gsdr_tpu_torch against gsdr_tpu, JAX on CPU)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.kernels.fm_chain_pallas import fm_chain_pallas, pfb_fm_chain_pallas
from gsdr_tpu.pipelines import FmChannelizer as JFm
from gsdr_tpu.pipelines import fm_deemphasis_coeffs as j_deemph
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels.fm_chain import (
    fm_chain,
    fm_chain_reference,
    pfb_fm_chain,
    pfb_fm_chain_reference,
)
from gsdr_tpu_torch.pipelines import FmChannelizer as TFm
from gsdr_tpu_torch.pipelines import fm_deemphasis_coeffs as t_deemph
from gsdr_tpu_torch.utils.convert import (
    fm_channelizer_from_fields,
    state_from_numpy,
    state_to_numpy,
)

FS = 1_000_000.0
BLOCK = 4096
SKIP = 256  # zero-primed warm-up outputs
# The float32 digit-table phase is exact to PHASE_BOUND cycles, because a
# compiler may contract its acc + digit*frac into an FMA, depending on the
# host (tests/test_torch_channelize.py). The JAX fused kernels rotate by a
# base phasor from that table, evaluated by XLA at the step's first output,
# times exact host-built increments; the plain chain evaluates the table at
# every output. Within a step the base cancels in the discriminator's
# f[j]*conj(f[j-1]); at the step boundary the two steps' bases may each be
# off by PHASE_BOUND, which moves one discriminator output by up to
# gain*2*pi*2*PHASE_BOUND, and the de-emphasis passes that on as its
# impulse response h (h[0] = b0, h[n] = cc*a^(n-1)): at most 8.1e-5 here.
# Where 2e-4 of a test's max|audio| can lie below that (the PFB test's
# narrow channels, max|audio| ~0.03), its second step is held to the gate
# plus that term; the dense test's (max|audio| ~2.7) stays under its gate.
PHASE_BOUND = 6e-5


def _boundary_allowance(model, m):
    """Per output of a step after the first: the most the digit-table
    phase of the step boundary can move the audio (see PHASE_BOUND)."""
    b0, cc, a = (abs(float(v)) for v in model.deemph)
    h = np.concatenate([[b0], cc * a ** np.arange(m - 1)])
    return model.gain * 2 * np.pi * 2 * PHASE_BOUND * h


def _audio_within(yt, yj, model, step, tol=2e-4):
    """Audio parity: after the zero-primed first step's warm-up within tol
    of max|audio|; on the next step within tol of max|audio| plus the
    boundary's digit-table allowance."""
    if step == 0:
        return _rel(yt[:, SKIP:], yj[:, SKIP:]) < tol
    bound = (tol * np.max(np.abs(yj))
             + _boundary_allowance(model, yj.shape[-1])[None, :])
    return bool(np.all(np.abs(yt - yj) <= bound))


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
    # the plain version at its own default grade, f32, or at the grade
    # asked for
    for kw, want in (({}, fm_chain_reference(*args, precision="f32")),
                     ({"precision": "bf16x3"},
                      fm_chain_reference(*args, precision="bf16x3"))):
        got = fm_chain(*args, **kw)
        for g, w in zip((got[0], got[1].re, got[2]),
                        (want[0], want[1].re, want[2])):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert fm_chain.launches == before  # no kernel launched for CPU tensors


# -- wideband uniform grid: the PFB front ------------------------------------

def _wideband(k=16, decimation=16, q=8, impl="pfb", num_channels=None):
    """The wideband configuration of benchmarks/run_all.py
    (bench_fm_wideband) at a K=16 grid: channels -(Fs/K)*i, a Q*K-tap
    prototype with cutoff 0.4/K."""
    return JFm(
        sample_rate=FS, tuning_frequency=0.0,
        channel_frequencies=tuple(-(FS / k) * i
                                  for i in range(num_channels or k)),
        frequency_deviation=75_000.0, decimation=decimation,
        low_pass_taps=_lowpass(q * k - 3, 0.4 / k), impl=impl)


def _carriers(freqs, n, seed, amp=0.5):
    """FM carriers at the channel frequencies, a distinct tone on each."""
    return _fm_signal(freqs, n, seed=seed, amp=amp)


@pytest.mark.parametrize("decimation", [16, 4])
def test_wideband_pfb_stream_matches_jax(decimation):
    """FmChannelizer(impl='pfb') on the CPU against the JAX model's 'pfb'
    (its XLA fold and DFT), over two streamed blocks with state
    continuation; D=16 is critical (P=1), D=4 has P=4 phases. Both run the
    fold and the DFT bank in float32 in different orders: measured ~1e-6
    of max|audio|, held to 1e-4 after the warm-up; carries to 1e-4."""
    jm = _wideband(decimation=decimation)
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    assert tm.impl == "pfb" and tm.front == "pfb" and tm.pfb_grid[0] == 16
    re, im = _carriers(jm.channel_frequencies, 2 * BLOCK, seed=13)
    sj, yj = _stream_jax(jm, jm.init(), re, im, range(2))
    st, yt = _stream_torch(tm, tm.init(), re, im, range(2))
    assert yt.shape == yj.shape == (16, 2 * BLOCK // decimation)
    skip = SKIP // (decimation // 4)
    assert _rel(yt[:, skip:], yj[:, skip:]) <= 1e-4
    _assert_states_close(st, sj)


def test_wideband_pfb_matches_dense_and_shares_state():
    """The PFB and dense plain chains give the same audio on the same
    grid, and a stream may switch fronts at any block: dense, then PFB,
    then dense equals dense throughout (1e-4 of max|audio|)."""
    jm = _wideband(decimation=8)
    pfb = fm_channelizer_from_fields(
        dataclasses.asdict(dataclasses.replace(jm, impl="pfb")), device="cpu")
    dense = fm_channelizer_from_fields(
        dataclasses.asdict(dataclasses.replace(jm, impl="xla")), device="cpu")
    re, im = _carriers(jm.channel_frequencies, 3 * BLOCK, seed=17)
    _, y_dense = _stream_torch(dense, dense.init(), re, im, range(3))
    st, y0 = _stream_torch(dense, dense.init(), re, im, range(1))
    st, y1 = _stream_torch(pfb, st, re, im, range(1, 2))
    _, y2 = _stream_torch(dense, st, re, im, range(2, 3))
    mixed = np.concatenate([y0, y1, y2], axis=-1)
    assert _rel(mixed[:, SKIP:], y_dense[:, SKIP:]) <= 1e-4


def test_wideband_midstream_handoff_from_jax():
    """A JAX 'pfb' state taken after block 1 continues in the port's 'pfb'
    as it does in JAX."""
    jm = _wideband(decimation=4, num_channels=12)
    re, im = _carriers(jm.channel_frequencies, 3 * BLOCK, seed=19)
    sj, _ = _stream_jax(jm, jm.init(77_000), re, im, range(1))
    sj_end, yj = _stream_jax(jm, sj, re, im, range(1, 3))
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    st = state_from_numpy(_jax_state_np(sj), "cpu")
    st_end, yt = _stream_torch(tm, st, re, im, range(1, 3))
    assert _rel(yt, yj) <= 1e-4
    _assert_states_close(st_end, sj_end)


def test_pfb_fm_chain_reference_matches_jax_fused_interpret():
    """The plain PFB chain against the JAX PFB-fronted fused kernel in
    interpret mode at f32, over two steps with the carries exported each
    side. K=8, D=4 (P=2), T=29 (ragged fold), 6 of the 8 bins. Measured
    ~1e-6 after the warm-up (polynomial atan2 and phasor tables there),
    held to 2e-4 as the dense case."""
    k, d, t, n = 8, 4, 29, 2048
    jm = JFm(sample_rate=FS, tuning_frequency=0.0,
             channel_frequencies=tuple(-(FS / k) * i for i in (0, 1, 2, 3, 5, 7)),
             frequency_deviation=75_000.0, decimation=d,
             low_pass_taps=_lowpass(t, 0.4 / k), impl="pfb", precision="f32")
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    k_grid, bins = tm.pfb_grid
    assert k_grid == k
    re, im = _carriers(jm.channel_frequencies, 2 * n, seed=3, amp=0.9)
    fs = int(FS)
    b, a = jm._deemph()
    jstate, tstate = jm.init(), tm.init()
    for step in range(2):
        sl = slice(step * n, (step + 1) * n)
        n0, tail, cf, cz = jstate
        buf = JCA(jnp.concatenate([tail.re, jnp.asarray(re[sl])]),
                  jnp.concatenate([tail.im, jnp.asarray(im[sl])]))
        rot0 = (n0 + jnp.int32(fs - (t - 1) % fs)) % fs
        yj, cfj, czj = pfb_fm_chain_pallas(
            buf, jm.low_pass_taps, jm._lo_table(), rot0, d, jm.gain, b, a,
            cf, cz, tuple(jm._shifts()), FS, bins, k_grid, precision="f32",
            interpret=True)
        tn0, ttail, tcf, tcz = tstate
        tbuf = TCA(torch.cat([ttail.re, torch.from_numpy(re[sl])]),
                   torch.cat([ttail.im, torch.from_numpy(im[sl])]))
        trot0 = torch.remainder(tn0 + (fs - (t - 1) % fs), fs).to(torch.int32)
        yt, cft, czt = pfb_fm_chain_reference(
            tbuf, tm.poly_taps, tm.dft_bank, t, tm.lo_table, trot0, d,
            tm.gain, tm.deemph, tcf, tcz)
        assert tuple(yt.shape) == yj.shape == (6, n // d)
        assert _audio_within(yt.numpy(), np.asarray(yj), tm, step)
        np.testing.assert_allclose(cft.re.numpy(), np.asarray(cfj.re), atol=2e-4)
        np.testing.assert_allclose(cft.im.numpy(), np.asarray(cfj.im), atol=2e-4)
        np.testing.assert_allclose(czt.numpy(), np.asarray(czj), atol=2e-4)
        jstate = ((n0 + n % fs) % fs, buf[..., buf.shape[-1] - (t - 1):], cfj, czj)
        tstate = (torch.remainder(tn0 + n % fs, fs).to(torch.int32),
                  tbuf[..., tbuf.shape[-1] - (t - 1):], cft, czt)


def test_pfb_fm_chain_wrapper_takes_plain_version_on_cpu():
    jm = _wideband(decimation=4)
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    re, im = _carriers(jm.channel_frequencies, 1024 + tm.num_taps - 1, seed=9)
    buf = TCA(torch.from_numpy(re), torch.from_numpy(im))
    n0, _, cf, cz = tm.init()
    args = (buf, tm.poly_taps, tm.dft_bank, tm.num_taps, tm.lo_table, n0, 4,
            tm.gain, tm.deemph, cf, cz)
    before = pfb_fm_chain.launches
    got, want = pfb_fm_chain(*args), pfb_fm_chain_reference(*args)
    assert pfb_fm_chain.launches == before  # no kernel launched for CPU tensors
    for g, w in zip((got[0], got[1].re, got[2]), (want[0], want[1].re, want[2])):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_front_routing_on_cpu():
    """'auto' on the CPU keeps the dense plain chain, as the JAX model does
    off the TPU; 'pfb' and 'pfb_torch' take the PFB front on a grid and
    raise off it."""
    fields = _port_fields(_wideband(decimation=16))
    auto = TFm(**dict(fields, impl="auto"), device="cpu")
    assert auto.front == "toeplitz" and auto.pfb_grid is None
    for impl in ("pfb", "pfb_torch"):
        m = TFm(**dict(fields, impl=impl), device="cpu")
        assert m.front == "pfb" and m.pfb_grid == (16, list(range(16)))
    off_grid = dict(fields, channel_frequencies=(12_345.678, 0.0))
    with pytest.raises(ValueError, match="Fs/K grid"):
        TFm(**dict(off_grid, impl="pfb"), device="cpu")


def _port_fields(jm):
    fields = dataclasses.asdict(jm)
    fields.pop("precision")
    return fields
