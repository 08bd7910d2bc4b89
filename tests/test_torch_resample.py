"""Port parity for the rational resampler: the phase bank (a host table)
array-equal to JAX's, resample and ResampleStream against gsdr_tpu's on
the same numpy inputs (JAX on CPU)."""

import importlib

import numpy as np
import pytest
import torch

from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu_torch.carray import ComplexArray as TCA

# the modules (each package's ops exports a function of the same name)
J = importlib.import_module("gsdr_tpu.ops.resample")
T = importlib.import_module("gsdr_tpu_torch.ops.resample")

# The same float32 phase bank, the product in full float32 on both sides
# (JAX's lax.conv at HIGHEST, the port's F.conv1d with TF32 off) in another
# summation order: 1e-6 of max|y|.
TOL = 1e-6
RATIOS = [(3, 2), (2, 3), (3, 16), (1, 4), (5, 1), (147, 160)]


def _signal(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))


@pytest.mark.parametrize("l,m", RATIOS)
def test_phase_bank_and_taps_equal_jax(l, m):
    np.testing.assert_array_equal(T.design_resampler_taps(l, m),
                                  J.design_resampler_taps(l, m))
    taps = J.design_resampler_taps(l, m, taps_per_phase=12)
    kt, st, wt = T._phase_bank(taps, l, m)
    kj, sj, wj = J._phase_bank(taps, l, m)
    assert (st, wt) == (sj, wj) and kt.dtype == kj.dtype == np.float32
    np.testing.assert_array_equal(kt, kj)


@pytest.mark.parametrize("l,m", RATIOS)
def test_resample_matches_jax(l, m):
    x = _signal((2, 999))
    _close(T.resample(torch.from_numpy(x), l, m).numpy(),
           J.resample(x, l, m))


def test_resample_representations_follow_input():
    """Planar in, planar out; real in, real out; complex in, complex out,
    each as JAX's."""
    x = _signal((700,), seed=1)
    got = T.resample(TCA.from_complex(x), 3, 2)
    want = J.resample(JCA.from_complex(x), 3, 2)
    assert isinstance(got, TCA)
    _close(got.re.numpy(), want.re)
    _close(got.im.numpy(), want.im)
    r = np.ascontiguousarray(x.real)
    got = T.resample(torch.from_numpy(r), 2, 3)
    assert not got.is_complex()
    _close(got.numpy(), J.resample(r, 2, 3))
    assert T.resample(torch.from_numpy(x), 2, 3).dtype == torch.complex64
    with pytest.raises(ValueError, match="L and M"):
        T.resample(torch.from_numpy(x), 0, 3)


@pytest.mark.parametrize("l,m", [(3, 16), (147, 160), (5, 1)])
def test_resample_stream_matches_jax_and_one_shot(l, m):
    """Uneven blocks through ResampleStream: the same block outputs as
    JAX's stream, and together the one-shot resample."""
    x = _signal((2, 4000), seed=2)
    cuts = [0, 7, 300, 301, 2200, 4000]
    ts, js = T.ResampleStream(l, m), J.ResampleStream(l, m)
    tst, jst = ts.init(torch.from_numpy(x)), js.init(x)
    outs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        tst, yt = ts.step(tst, torch.from_numpy(x[:, a:b]))
        jst, yj = js.step(jst, x[:, a:b])
        assert tuple(yt.shape) == np.asarray(yj).shape
        if yt.shape[-1]:
            _close(yt.numpy(), yj)
        outs.append(yt)
    assert tst[1] == jst[1]
    np.testing.assert_array_equal(tst[0].re.numpy(), np.asarray(jst[0].re))
    joined = torch.cat(outs, dim=-1).numpy()
    once = T.resample(torch.from_numpy(x), l, m).numpy()
    assert np.max(np.abs(joined[:, :once.shape[1]] - once)) <= \
        TOL * np.max(np.abs(once))


def test_resample_stream_real_planar_state():
    """A real (C, L) audio stream, as fm_rx feeds it: real out, the tail on
    the input's device."""
    rs = T.ResampleStream(3, 16)
    a = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 513)).astype(np.float32))
    st = rs.init(a)
    assert isinstance(st[0], TCA) and st[0].re.device == a.device
    st, y = rs.step(st, a)
    assert not y.is_complex() and y.shape[0] == 2
    js = J.ResampleStream(3, 16)
    _, yj = js.step(js.init(a.numpy()), a.numpy())
    _close(y.numpy(), yj)


def test_dc_gain_and_tone():
    """A DC input keeps its level; a tone keeps its frequency."""
    y = T.resample(torch.ones(4000), 3, 2).numpy()
    np.testing.assert_allclose(y[100:-100], 1.0, atol=2e-3)
    fs, f0 = 32_000.0, 1_000.0
    x = torch.from_numpy(np.cos(2 * np.pi * f0 * np.arange(8192) / fs)
                         .astype(np.float32))
    y = T.resample(x, 3, 2).numpy()[200:]
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    assert abs(np.argmax(spec) * 48_000.0 / len(y) - f0) < 10.0
