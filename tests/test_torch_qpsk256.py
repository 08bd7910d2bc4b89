"""Port parity: QPSK256 tables, modulators and demodulators
(gsdr_tpu_torch.ops.qpsk256 against gsdr_tpu.ops.qpsk256), and the
polynomials of gsdr_tpu_torch.kernels.kmath against gsdr_tpu.kernels.kmath,
JAX on CPU."""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.kernels import kmath as jk
from gsdr_tpu.kernels.qpsk256_pallas import qpsk256_demodulate_pallas
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels import kmath as tk
from gsdr_tpu_torch.kernels.qpsk256 import qpsk256_kernel

jq = importlib.import_module("gsdr_tpu.ops.qpsk256")
tq = importlib.import_module("gsdr_tpu_torch.ops.qpsk256")

GEOMETRIES = [(jq.RECTANGULAR, 1.0), (jq.RECTANGULAR, 1.7),
              (jq.CIRCULAR, 1.0), (jq.CIRCULAR, 2.0)]
# float32 polynomial evaluations: XLA on the CPU may contract a multiply
# and an add into one FMA where torch rounds twice, ~1 ulp of values <= 4
POLY_ATOL = 2e-7


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _noisy(ctype, amp, n, sigma, seed, shape=None):
    """Table points plus complex Gaussian noise of sigma*amp: planar numpy
    float32 (re, im), shaped ``shape`` (default (n,))."""
    rng = np.random.default_rng(seed)
    c = jq.qpsk256_constellation(ctype, amp)
    z = c[rng.integers(0, 256, n)] + sigma * amp * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    z = z.astype(np.complex64).reshape(shape or (n,))
    return np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)


def _both(re, im):
    return (JCA(jnp.asarray(re), jnp.asarray(im)),
            TCA(torch.from_numpy(re), torch.from_numpy(im)))


@pytest.mark.parametrize("ctype,amp", GEOMETRIES)
def test_constellation_equal(ctype, amp):
    want = jq.qpsk256_constellation(ctype, amp)
    got = tq.qpsk256_constellation(ctype, amp)
    assert got.dtype == np.complex64
    _eq(got, want)
    jp = jq.qpsk256_constellation(ctype, amp, planar=True)
    tp = tq.qpsk256_constellation(ctype, amp, planar=True, device="cpu")
    assert tp.re.dtype == torch.float32
    _eq(tp.re.numpy(), jp.re)
    _eq(tp.im.numpy(), jp.im)
    with pytest.raises(ValueError, match="unknown constellation"):
        tq.qpsk256_constellation(7)


@pytest.mark.parametrize("ctype,amp", GEOMETRIES)
def test_modulators_match_jax(ctype, amp):
    """The table lookup (complex and planar tables) is a gather: equal.
    The arithmetic modulators within 1e-6 (float32 products and the
    sincos polynomial, rounded in other places by XLA's FMAs)."""
    s = np.random.default_rng(1).integers(0, 256, (3, 300)).astype(np.uint8)
    ts = torch.from_numpy(s)
    table = jq.qpsk256_constellation(ctype, amp)
    _eq(tq.qpsk256_modulate(ts, table).numpy(), jq.qpsk256_modulate(s, table))
    tp = tq.qpsk256_modulate(ts, tq.qpsk256_constellation(ctype, amp, True))
    jp = jq.qpsk256_modulate(s, jq.qpsk256_constellation(ctype, amp, True))
    _eq(tp.re.numpy(), jp.re)
    _eq(tp.im.numpy(), jp.im)
    fast_t = (tq.qpsk256_modulate_rect if ctype == jq.RECTANGULAR
              else tq.qpsk256_modulate_circular)(ts, amp)
    fast_j = (jq.qpsk256_modulate_rect if ctype == jq.RECTANGULAR
              else jq.qpsk256_modulate_circular)(s, amp)
    np.testing.assert_allclose(fast_t.re.numpy(), np.asarray(fast_j.re),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(fast_t.im.numpy(), np.asarray(fast_j.im),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("ctype,amp", GEOMETRIES)
def test_exhaustive_demod_matches_jax_xla(ctype, amp):
    """The plain exhaustive demodulator against JAX impl='xla' and the TPU
    kernel interpreted, on noisy input with leading axes: bit-equal."""
    re, im = _noisy(ctype, amp, 3000, 0.02, 2, shape=(2, 1500))
    jx, tx = _both(re, im)
    table = jq.qpsk256_constellation(ctype, amp)
    want = np.asarray(jq.qpsk256_demodulate(jx, table, out_dtype=jnp.int32,
                                            impl="xla"))
    got = tq.qpsk256_demodulate(tx, table, out_dtype=torch.int32)
    assert got.shape == (2, 1500) and got.dtype == torch.int32
    _eq(got.numpy(), want)
    _eq(np.asarray(qpsk256_demodulate_pallas(jx, table, out_dtype=jnp.int32,
                                             interpret=True)), want)
    # the default bytes are uint8, from complex input as well
    z = (re + 1j * im).astype(np.complex64)
    got8 = tq.qpsk256_demodulate(torch.from_numpy(z),
                                 tq.qpsk256_constellation(ctype, amp, True))
    assert got8.dtype == torch.uint8
    _eq(got8.numpy(), want)


def test_tie_breaks_to_lowest_index():
    """tests/test_qpsk256.py:112-118: the midpoint of points 0 and 1 of the
    rectangular grid decides 0 (the first minimum)."""
    cn = jq.qpsk256_constellation(jq.RECTANGULAR, 1.0)
    mid = np.array([(cn[0] + cn[1]) / 2.0])
    got = tq.qpsk256_demodulate(mid, cn)
    want = np.asarray(jq.qpsk256_demodulate(mid, cn))
    assert int(got[0]) == int(want[0]) == 0


def test_midpoints_pick_a_nearest_point():
    """Exact midpoints of random point pairs: both points are nearest, and
    summation orders may pick either; the chosen point's distance equals
    JAX's within float32 rounding (rtol 2e-5, atol 2e-6, as the JAX
    kernel test holds it)."""
    cnp = jq.qpsk256_constellation(jq.CIRCULAR, 1.0)
    rng = np.random.default_rng(5)
    i, j = rng.integers(0, 256, 600), rng.integers(0, 256, 600)
    mids = ((cnp[i] + cnp[j]) / 2).astype(np.complex64)
    want = np.asarray(jq.qpsk256_demodulate(mids, cnp, out_dtype=jnp.int32,
                                            impl="xla"))
    got = tq.qpsk256_demodulate(torch.from_numpy(mids), cnp,
                                out_dtype=torch.int32).numpy()
    np.testing.assert_allclose(np.abs(mids - cnp[got]),
                               np.abs(mids - cnp[want]), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("amp", [1.0, 1.7])
def test_rect_demod_matches_jax(amp):
    re, im = _noisy(jq.RECTANGULAR, amp, 4096, 0.03, 3)
    # beyond the grid's edge as well: the clip to 0..15
    re[:16] *= 3.0
    jx, tx = _both(re, im)
    want = np.asarray(jq.qpsk256_demodulate_rect(jx, amp, out_dtype=jnp.int32))
    got = tq.qpsk256_demodulate_rect(tx, amp, out_dtype=torch.int32)
    _eq(got.numpy(), want)
    _eq(tq.qpsk256_demodulate(tx, jq.qpsk256_constellation(jq.RECTANGULAR,
                                                           amp),
                              out_dtype=torch.int32).numpy()[16:], want[16:])


@pytest.mark.parametrize("amp", [1.0, 2.0])
def test_circular_demod_matches_jax(amp):
    """The ring demodulator against JAX's on noisy input (and the origin,
    the remainder arc and its ends): bit-equal."""
    re, im = _noisy(jq.CIRCULAR, amp, 4096, 0.02, 4)
    re[:3], im[:3] = 0.0, 0.0
    jx, tx = _both(re, im)
    want = np.asarray(jq.qpsk256_demodulate_circular(jx, amp,
                                                     out_dtype=jnp.int32))
    got = tq.qpsk256_demodulate_circular(tx, amp, out_dtype=torch.int32)
    _eq(got.numpy(), want)
    assert set(range(225, 256)) <= set(want.tolist())


@pytest.mark.parametrize("ctype", [jq.RECTANGULAR, jq.CIRCULAR])
def test_ideal_loopback_all_symbols(ctype):
    """Every symbol through each modulator and each demodulator comes
    back exact."""
    s = torch.arange(256, dtype=torch.int32).repeat(3)
    table = tq.qpsk256_constellation(ctype, 1.5, planar=True)
    mods = [tq.qpsk256_modulate(s, table),
            (tq.qpsk256_modulate_rect if ctype == jq.RECTANGULAR
             else tq.qpsk256_modulate_circular)(s, 1.5)]
    for x in mods:
        _eq(tq.qpsk256_demodulate(x, table, torch.int32).numpy(), s.numpy())
        fast = (tq.qpsk256_demodulate_rect if ctype == jq.RECTANGULAR
                else tq.qpsk256_demodulate_circular)(x, 1.5, torch.int32)
        _eq(fast.numpy(), s.numpy())


def test_demod_checks():
    x = TCA(torch.zeros(8), torch.zeros(8))
    table = tq.qpsk256_constellation(planar=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq.qpsk256_demodulate(x, table, impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        tq.qpsk256_demodulate(x, table, impl="pallas")
    with pytest.raises(ValueError, match="256 points"):
        tq.qpsk256_demodulate(x, np.zeros(255, np.complex64))
    with pytest.raises(ValueError, match="256 points"):
        tq.qpsk256_modulate(torch.zeros(4, dtype=torch.int32),
                            np.zeros(16, np.complex64))
    # the kernel wrapper takes its plain version for CPU tensors, uncounted
    before = qpsk256_kernel.launches
    assert qpsk256_kernel(x, table).dtype == torch.int32
    assert qpsk256_kernel.launches == before


@pytest.mark.parametrize("order", [7, 11])
def test_atan_poly01_matches_jax(order):
    r = np.linspace(0.0, 1.0, 4001).astype(np.float32)
    np.testing.assert_allclose(
        tk.atan_poly01(torch.from_numpy(r), order).numpy(),
        np.asarray(jk.atan_poly01(jnp.asarray(r), order)), rtol=0,
        atol=POLY_ATOL)
    with pytest.raises(ValueError, match="order"):
        tk.atan_poly01(torch.from_numpy(r), 9)


def test_sincos_poly_matches_jax():
    ang = np.concatenate([
        np.linspace(-300.0, 300.0, 20001),
        np.pi / 4 * np.arange(-16, 17)]).astype(np.float32)
    c_t, s_t = tk.sincos_poly(torch.from_numpy(ang))
    c_j, s_j = jk.sincos_poly(jnp.asarray(ang))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0,
                               atol=POLY_ATOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0,
                               atol=POLY_ATOL)


@pytest.mark.parametrize("order", [7, 11])
def test_atan2_poly_matches_jax(order):
    rng = np.random.default_rng(9)
    y = rng.standard_normal(5000).astype(np.float32)
    x = rng.standard_normal(5000).astype(np.float32)
    y[:4], x[:4] = [0.0, 0.0, 1.0, -0.0], [0.0, -1.0, 0.0, 2.0]
    x[4:8] = y[4:8]                       # |y| == |x|
    got = tk.atan2_poly(torch.from_numpy(y), torch.from_numpy(x), order)
    want = np.asarray(jk.atan2_poly(jnp.asarray(y), jnp.asarray(x), order))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=POLY_ATOL)
    assert float(got[0]) == 0.0
