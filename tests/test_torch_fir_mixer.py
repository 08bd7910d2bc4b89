"""Port parity: FIR with decimation (gsdr_tpu_torch.ops.fir) and the
mixer (ops.mixer, utils.phase) against gsdr_tpu's on the same numpy
inputs, on the CPU."""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu_torch.carray import ComplexArray as TCA

jfir = importlib.import_module("gsdr_tpu.ops.fir")
tfir = importlib.import_module("gsdr_tpu_torch.ops.fir")
jmix = importlib.import_module("gsdr_tpu.ops.mixer")
tmix = importlib.import_module("gsdr_tpu_torch.ops.mixer")
jphase = importlib.import_module("gsdr_tpu.utils.phase")
tphase = importlib.import_module("gsdr_tpu_torch.utils.phase")

# the float32 digit-table phase is bounded at ~6e-5 cycles in either
# package (utils/phase.py); two correct implementations may differ by that
# much where one contracts a multiply-add into an FMA (ROADMAP C)
PHASE_BOUND = 6e-5
TRIG_ATOL = 2e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _signal(kind, shape, seed):
    """(jax x, torch x, complex128 numpy x) of one kind."""
    r = _rng(seed)
    re = r.standard_normal(shape).astype(np.float32)
    im = r.standard_normal(shape).astype(np.float32)
    if kind == "real":
        return jnp.asarray(re), torch.from_numpy(re), re.astype(np.float64)
    z = (re + 1j * im).astype(np.complex64)
    if kind == "complex":
        return jnp.asarray(z), torch.from_numpy(z), z.astype(np.complex128)
    return (JCA(jnp.asarray(re), jnp.asarray(im)),
            TCA(torch.from_numpy(re), torch.from_numpy(im)),
            z.astype(np.complex128))


def _to_numpy(y):
    if isinstance(y, (JCA, TCA)):
        return y.to_numpy() if isinstance(y, TCA) else np.asarray(y.to_complex())
    if isinstance(y, torch.Tensor):
        return y.numpy()
    return np.asarray(y)


@pytest.mark.parametrize("dec", [1, 2, 4])
@pytest.mark.parametrize("taps_kind", ["real", "complex", "planar"])
@pytest.mark.parametrize("x_kind", ["real", "complex", "planar"])
def test_fir_matches_jax(x_kind, taps_kind, dec):
    """Every combination of real, complex and planar signal and taps, with
    leading batch axes: float32 sums of 33 products in another order, so
    rtol = atol = 2e-5 (values of order 5). JAX's planar path drops the
    imaginary part of complex (not planar) taps; the port filters with
    them, so that case is held to JAX with the same taps as planar."""
    jx, tx, _ = _signal(x_kind, (2, 300), 1)
    jt, tt, _ = _signal(taps_kind, (33,), 2)
    if taps_kind == "real":
        tt = tuple(np.asarray(jt).tolist())
    if (x_kind, taps_kind) == ("planar", "complex"):
        jt = JCA.from_complex(jt)
    want = _to_numpy(jfir.fir(jx, jt, dec))
    got = _to_numpy(tfir.fir(tx, tt, dec))
    assert got.shape == want.shape == (2, (300 - 33) // dec + 1)
    assert type(tfir.fir(tx, tt, dec)).__name__ == (
        "ComplexArray" if x_kind == "planar" else "Tensor")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_fir_contract():
    assert tfir.fir_output_length(100, 33, 4) == \
        jfir.fir_output_length(100, 33, 4) == 17
    assert tfir.fir_output_length(10, 33) == 0
    with pytest.raises(ValueError):
        tfir.fir(torch.zeros(10), (1.0,) * 33)
    with pytest.raises(ValueError):
        tfir.fir(torch.zeros(100), (1.0,) * 3, decimation=0)


@pytest.mark.parametrize("n0", [0, 123_456_789])
def test_phase_fraction_and_offset_match_jax(n0):
    """phase_fraction_offset is exact on the host in both packages (equal
    floats); phase_fraction on the device within the float32 bound."""
    for f, fs in ((12_345.0, 1e6), (-777.0, 10_000.0), (0.5, 1000.0)):
        assert tphase.phase_fraction_offset(n0, f, fs) == \
            jphase.phase_fraction_offset(n0, f, fs)
        idx = (n0 % 100_000 + np.arange(5000)).astype(np.int32)
        want = np.asarray(jphase.phase_fraction(jnp.asarray(idx), f, fs))
        got = tphase.phase_fraction(torch.from_numpy(idx), f, fs).numpy()
        df = np.abs(got - want)
        assert np.max(np.minimum(df, 1.0 - df)) <= PHASE_BOUND


@pytest.mark.parametrize("f,fs,n0", [(12_345.0, 1e6, 0),
                                     (-100_000.0, 1e6, 999_999_000),
                                     (0.5, 1000.0, 1500)])
def test_lo_signal_and_freq_shift_match_jax(f, fs, n0):
    """The LO's phase fractions agree modulo 1 within PHASE_BOUND cycles;
    a shifted sample then within 2*pi*PHASE_BOUND*|x| + TRIG_ATOL."""
    n = 4096
    jlo = jmix.lo_signal(n, f, fs, n0, planar=True)
    tlo = tmix.lo_signal(n, f, fs, n0, planar=True, device="cpu")
    fj = np.angle(np.asarray(jlo.to_complex())) / (2 * np.pi) % 1.0
    ft = np.angle(tlo.to_numpy()) / (2 * np.pi) % 1.0
    df = np.abs(ft - fj)
    assert np.max(np.minimum(df, 1.0 - df)) <= PHASE_BOUND + 1e-6
    assert tmix.lo_signal(n, f, fs, n0, device="cpu").dtype == torch.complex64
    for kind in ("planar", "complex"):
        jx, tx, z = _signal(kind, (2, n), 3)
        got = tmix.freq_shift(tx, f, fs, n0)
        assert isinstance(got, TCA) == (kind == "planar")
        got, want = _to_numpy(got), _to_numpy(jmix.freq_shift(jx, f, fs, n0))
        bound = 2 * np.pi * PHASE_BOUND * np.abs(z) + TRIG_ATOL
        assert np.all(np.abs(got - want) <= bound)
