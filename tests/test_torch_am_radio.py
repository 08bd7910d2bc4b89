"""Port parity for AmReceiver and the fused AM chain, dense and PFB fronts
(gsdr_tpu_torch against gsdr_tpu, JAX on CPU)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.kernels.fm_chain_pallas import am_chain_pallas, pfb_am_chain_pallas
from gsdr_tpu.pipelines import AmReceiver as JAm
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels.am_chain import (
    am_chain,
    am_chain_reference,
    pfb_am_chain,
    pfb_am_chain_reference,
)
from gsdr_tpu_torch.pipelines import AmReceiver as TAm
from gsdr_tpu_torch.utils.convert import (
    am_receiver_from_fields,
    state_from_numpy,
    state_to_numpy,
)

FS = 1_000_000.0
BLOCK = 4096
# The envelope is |y| of a float32 sum: the fronts, the rotor and the two
# packages' summation orders move it by a few ulps of |y| <= 1.
ENV_ATOL = 1e-5


def _lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def _am_d(impl="xla"):
    """The 8-channel AM receiver of __graft_entry__.py (am_d)."""
    return JAm(sample_rate=FS, tuning_frequency=100_000_000.0,
               channel_frequencies=tuple(100_000_000.0 - 200_000.0 + 50_000.0 * i
                                         for i in range(8)),
               decimation=4, low_pass_taps=_lowpass(32, 0.04), impl=impl)


def _wideband(k=16, decimation=16, impl="pfb", num_channels=None):
    """benchmarks/run_all.py's bench_am_wideband at a K=16 grid."""
    return JAm(sample_rate=FS, tuning_frequency=0.0,
               channel_frequencies=tuple(-(FS / k) * i
                                         for i in range(num_channels or k)),
               decimation=decimation, low_pass_taps=_lowpass(8 * k - 5, 0.4 / k),
               impl=impl)


def _am_signal(freqs, n, seed, tuning=0.0):
    """An AM carrier on every channel, 50% modulated by its own tone."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / FS
    sig = np.zeros(n, np.complex128)
    for k, f in enumerate(freqs):
        env = 0.6 * (1.0 + 0.5 * np.sin(2 * np.pi * (500.0 + 310.0 * k) * t
                                         + r.uniform(0, 6)))
        sig += env * np.exp(1j * (2 * np.pi * (f - tuning) * t + r.uniform(0, 6)))
    return sig.real.astype(np.float32), sig.imag.astype(np.float32)


def _stream(model, state, re, im, blocks, planar):
    outs = []
    for i in blocks:
        sl = slice(i * BLOCK, (i + 1) * BLOCK)
        state, y = model.step(state, planar(re[sl], im[sl]))
        outs.append(np.asarray(y))
    return state, np.concatenate(outs, axis=-1)


def _jax_planar(re, im):
    return JCA(jnp.asarray(re), jnp.asarray(im))


def _torch_planar(re, im):
    return TCA(torch.from_numpy(re), torch.from_numpy(im))


def _jax_state_np(state):
    n0, tail = state
    return (np.asarray(n0), (np.asarray(tail.re), np.asarray(tail.im)))


def _assert_states_equal(st_t, st_j):
    t_np, j_np = state_to_numpy(st_t), _jax_state_np(st_j)
    assert len(t_np) == 2 and int(t_np[0]) == int(j_np[0])
    np.testing.assert_array_equal(t_np[1][0], j_np[1][0])
    np.testing.assert_array_equal(t_np[1][1], j_np[1][1])


@pytest.mark.parametrize(
    "make,impl",
    [(_am_d, "xla"), (_wideband, "pfb"),
     (lambda **kw: _wideband(decimation=4, **kw), "pfb")],
    ids=["am_d_dense", "wideband_critical_pfb", "wideband_d4_pfb"])
def test_am_stream_matches_jax(make, impl):
    """The port's AmReceiver on the CPU against the JAX model's XLA path,
    dense ('xla' -> 'torch') and PFB ('pfb'), over two streamed blocks:
    envelopes within ENV_ATOL, the raw tail and n0 exact."""
    jm = make(impl=impl)
    tm = am_receiver_from_fields(dataclasses.asdict(jm), device="cpu")
    assert tm.impl == ("torch" if impl == "xla" else "pfb")
    assert tm.front == ("toeplitz" if impl == "xla" else "pfb")
    tuning = jm.tuning_frequency
    re, im = _am_signal(jm.channel_frequencies, 2 * BLOCK, seed=3,
                        tuning=tuning)
    sj, yj = _stream(jm, jm.init(), re, im, range(2), _jax_planar)
    st, yt = _stream(tm, tm.init(), re, im, range(2), _torch_planar)
    assert yt.shape == yj.shape == (jm.num_channels, 2 * BLOCK // jm.decimation)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=ENV_ATOL)
    _assert_states_equal(st, sj)


def test_am_pfb_matches_dense_front():
    """The same wideband grid through the port's plain PFB and dense AM
    chains: one function, two factorisations."""
    jm = _wideband(decimation=8)
    pfb = am_receiver_from_fields(dataclasses.asdict(jm), device="cpu")
    dense = am_receiver_from_fields(
        dataclasses.asdict(dataclasses.replace(jm, impl="xla")), device="cpu")
    re, im = _am_signal(jm.channel_frequencies, 2 * BLOCK, seed=5)
    _, y_pfb = _stream(pfb, pfb.init(), re, im, range(2), _torch_planar)
    _, y_dense = _stream(dense, dense.init(), re, im, range(2), _torch_planar)
    np.testing.assert_allclose(y_pfb, y_dense, rtol=0, atol=ENV_ATOL)


def test_am_midstream_handoff_from_jax():
    """A JAX AM state taken after block 1 continues in the port as in JAX."""
    jm = _am_d()
    re, im = _am_signal(jm.channel_frequencies, 3 * BLOCK, seed=7,
                        tuning=jm.tuning_frequency)
    sj, _ = _stream(jm, jm.init(999_000), re, im, range(1), _jax_planar)
    sj_end, yj = _stream(jm, sj, re, im, range(1, 3), _jax_planar)
    tm = am_receiver_from_fields(
        dataclasses.asdict(dataclasses.replace(jm, impl="auto")), device="cpu")
    st = state_from_numpy(_jax_state_np(sj), "cpu")
    st_end, yt = _stream(tm, st, re, im, range(1, 3), _torch_planar)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=ENV_ATOL)
    _assert_states_equal(st_end, sj_end)


@pytest.mark.parametrize("front", ["toeplitz", "pfb"])
def test_am_chain_reference_matches_jax_fused_interpret(front):
    """The plain chains against the JAX fused AM kernel in interpret mode
    at f32 (am_chain_pallas / pfb_am_chain_pallas): the am_d shape, and a
    K=8, D=4 grid with a ragged fold (T=29) and 6 of the 8 bins."""
    if front == "toeplitz":
        jm = _am_d()
    else:
        jm = JAm(sample_rate=FS, tuning_frequency=0.0,
                 channel_frequencies=tuple(-(FS / 8) * i for i in (0, 1, 2, 3, 5, 7)),
                 decimation=4, low_pass_taps=_lowpass(29, 0.05), impl="pfb")
    tm = am_receiver_from_fields(dataclasses.asdict(jm), device="cpu")
    t, d, fs = jm.num_taps, jm.decimation, int(FS)
    re, im = _am_signal(jm.channel_frequencies, 2048 + t - 1, seed=11,
                        tuning=jm.tuning_frequency)
    jbuf, tbuf = _jax_planar(re, im), _torch_planar(re, im)
    n0 = 123_457
    rot0 = torch.tensor((n0 + fs - (t - 1) % fs) % fs, dtype=torch.int32)
    if front == "toeplitz":
        want = am_chain_pallas(jbuf, jm._tap_bank(), d, precision="f32",
                               interpret=True)
        got = am_chain_reference(tbuf, tm.tap_bank, tm.lo_table, rot0, d)
    else:
        k, bins = tm.pfb_grid
        want = pfb_am_chain_pallas(jbuf, jm.low_pass_taps, d, bins, k,
                                   precision="f32", interpret=True)
        got = pfb_am_chain_reference(tbuf, tm.poly_taps, tm.dft_bank, t,
                                     tm.lo_table, rot0, d)
    assert tuple(got.shape) == want.shape == (jm.num_channels, 2048 // d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ENV_ATOL)


def test_am_wrappers_take_plain_version_on_cpu():
    jm = _wideband(decimation=4, num_channels=10)
    tm = am_receiver_from_fields(dataclasses.asdict(jm), device="cpu")
    dm = am_receiver_from_fields(
        dataclasses.asdict(dataclasses.replace(jm, impl="xla")), device="cpu")
    re, im = _am_signal(jm.channel_frequencies, 1024 + tm.num_taps - 1, seed=9)
    buf = _torch_planar(re, im)
    n0, _ = tm.init()
    before = (am_chain.launches, pfb_am_chain.launches)
    pairs = [(pfb_am_chain, pfb_am_chain_reference,
              (buf, tm.poly_taps, tm.dft_bank, tm.num_taps, tm.lo_table, n0, 4)),
             (am_chain, am_chain_reference,
              (buf, dm.tap_bank, dm.lo_table, n0, 4))]
    for wrapper, plain, args in pairs:
        torch.testing.assert_close(wrapper(*args), plain(*args), rtol=0, atol=0)
    assert (am_chain.launches, pfb_am_chain.launches) == before


def test_am_checks(monkeypatch):
    fields = dataclasses.asdict(_am_d())
    fields.pop("precision")
    fields.pop("impl")
    with pytest.raises(ValueError, match="impl='cuda'"):
        TAm(**fields, impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="Fs/K grid"):
        TAm(**dict(fields, channel_frequencies=(12_345.678,)), impl="pfb",
            device="cpu")
    # JAX's default grade is the port's default, and every grade is taken
    assert TAm(**fields, device="cpu").precision == "bf16x3"
    for grade in ("bf16x3", "bf16x2", "f32"):
        assert TAm(**fields, precision=grade, device="cpu").precision == grade
    with pytest.raises(ValueError, match="precision must be"):
        TAm(**fields, precision="bf16", device="cpu")
    with pytest.raises(ValueError, match="impl must be"):
        TAm(**fields, impl="xla", device="cpu")
    model = TAm(**fields, device="cpu")
    with pytest.raises(ValueError, match="multiple of decimation"):
        model.step(model.init(), TCA(torch.zeros(10), torch.zeros(10)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TAm(**fields)
