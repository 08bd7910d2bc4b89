"""Port parity for the single-channel demodulators and the elementwise
ops: fm_demod, am_demod (both routes), cosine_c/cosine_f, the arithmetic
ops and int8_to_norm_float (gsdr_tpu_torch against gsdr_tpu, JAX on CPU,
the same numpy inputs)."""

import numpy as np
import pytest
import torch

import gsdr_tpu as J
import gsdr_tpu_torch as T
from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels.fm_chain import deemphasis_triple
from gsdr_tpu_torch.ops.am import am_demod_fused
from gsdr_tpu_torch.ops.fm import fm_demod_fused
from gsdr_tpu_torch.pipelines import FmChannelizer, fm_deemphasis_coeffs

FS = 1_000_000.0
# The composed chains against JAX's XLA chains, of max|audio|: the same
# float32 ops but for the mixer's digit-table phase and libm's atan2.
CHAIN_TOL = 2e-4
# The kernel route rotates each output by the float32 digit-table phase,
# exact to PHASE_BOUND cycles (tests/test_torch_fm_radio.py), where the
# composed chain mixes by its own float32 phase and JAX's kernel by exact
# phasors: an output of the discriminator may move by gain*2*pi*2 *
# PHASE_BOUND. At a shift whose f/Fs is a short binary fraction (125 kHz
# at 1 MHz: 1/8) every digit fraction is exact, the phase has no rounding
# and the routes agree to their front's and atan2's rounding.
PHASE_BOUND = 6e-5


def _phase_allowance(gain):
    return gain * 2 * np.pi * 2 * PHASE_BOUND


def _lowpass(num_taps, cutoff):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff * n) * np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


def _fm(n, fc, f_mod, dev, n0=0):
    i = np.arange(n, dtype=np.float64) + n0
    ph = 2 * np.pi * fc * i / FS + (dev / f_mod) * np.sin(
        2 * np.pi * f_mod * i / FS)
    return np.exp(1j * ph).astype(np.complex64)


def _am(n, fc, n0=0):
    i = np.arange(n, dtype=np.float64) + n0
    env = 0.5 * (1.0 + 0.6 * np.cos(2 * np.pi * 1_000.0 * i / FS))
    return (env * np.exp(2j * np.pi * fc * i / FS)).astype(np.complex64)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_fm_demod_gain_matches_jax():
    assert T.fm_demod_gain(1e6, 75e3) == J.fm_demod_gain(1e6, 75e3)


@pytest.mark.parametrize("planar,n0", [(False, 0), (True, 12_345)])
def test_fm_demod_matches_jax_xla(planar, n0):
    """The composed chain (CPU, 'auto' and 'torch') against JAX 'xla'."""
    taps = _lowpass(65, 0.02)
    x = _fm(6000, 100_000.0, 1_000.0, 5_000.0, n0)
    xt = TCA.from_complex(x) if planar else torch.from_numpy(x)
    xj = JCA.from_complex(x) if planar else x
    want = np.asarray(J.fm_demod(xj, taps, FS, 0.0, 100_000.0, 5_000.0, 4,
                                 first_sample_index=n0, impl="xla"))
    for impl in ("auto", "torch"):
        got = T.fm_demod(xt, taps, FS, 0.0, 100_000.0, 5_000.0, 4,
                         first_sample_index=n0, impl=impl).numpy()
        assert got.shape == want.shape == ((6000 - 65) // 4,)
        assert _rel(got, want) < CHAIN_TOL


def test_fm_demod_batched_and_tensor_index():
    """A batched signal takes the composed chain; an int tensor as
    first_sample_index acts as the int."""
    taps = _lowpass(33, 0.05)
    x = np.stack([_fm(2048, 100_000.0, 700.0, 5_000.0),
                  _fm(2048, 100_000.0, 1_300.0, 5_000.0)])
    got = T.fm_demod(torch.from_numpy(x), taps, FS, 0.0, 100_000.0, 5_000.0,
                     4, first_sample_index=torch.tensor(99))
    want = np.asarray(J.fm_demod(x, taps, FS, 0.0, 100_000.0, 5_000.0, 4,
                                 first_sample_index=99, impl="xla"))
    assert got.shape == want.shape == (2, (2048 - 33) // 4)
    assert _rel(got.numpy(), want) < CHAIN_TOL


def test_deemphasis_triple():
    """The identity filter is (1, 0, 0), not the pipeline's b1 = b0
    shortcut (1, 1, 0); the bilinear de-emphasis gives FmChannelizer's
    operand."""
    assert deemphasis_triple((1.0, 0.0), (1.0, 0.0)) == (1.0, 0.0, 0.0)
    (b0, b1), (a0, a1) = fm_deemphasis_coeffs(75e-6, 250e3)
    assert b1 == b0 and a0 == 1.0
    assert deemphasis_triple((b0, b1), (a0, a1)) == (b0, b0 - a1 * b0, -a1)
    m = FmChannelizer(FS, 0.0, (1e5,), 75e3, 4, _lowpass(16, 0.1),
                      device="cpu")
    np.testing.assert_array_equal(
        m.deemph.numpy(),
        np.float32(deemphasis_triple(*fm_deemphasis_coeffs(75e-6, 250e3))))


@pytest.mark.parametrize("fc,n0,tol", [
    (-125_000.0, 3 * 1_000_000 + 777, 1e-5),
    (-150_000.0, 3 * 1_000_000 + 777, None)])
def test_fm_kernel_route_matches_composed_chain(fc, n0, tol):
    """The kernel route's arithmetic (fm_chain's plain version at f32, C=1,
    rot0 = first_sample_index % Fs, outputs 1..M-1) against the composed
    chain: one op, two routes; within 1e-5 of max|audio| where the phase
    is exact (measured 4.2e-6), within the phase bound elsewhere (measured
    6.8e-4 absolute, bound 0.024)."""
    taps = _lowpass(65, 0.02)
    gain = T.fm_demod_gain(FS, 5e3)
    x = _fm(5000, fc, 1_500.0, 5_000.0, n0)
    got = fm_demod_fused(TCA.from_complex(x), taps, FS, -fc, gain, 4, n0,
                         precision="f32").numpy()
    want = T.fm_demod(torch.from_numpy(x), taps, FS, 0.0, fc, 5e3, 4,
                      first_sample_index=n0, impl="torch").numpy()
    assert got.shape == want.shape == ((5000 - 65) // 4,)
    if tol is not None:
        assert _rel(got, want) < tol
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=_phase_allowance(gain))


# The kernel route's plain version at bf16x3 against JAX's Pallas kernel
# interpreted at bf16x3 (one call each, 2-4 s), at a shift with an exact
# phase: the JAX kernel's polynomial atan2 (~1e-6 rad, times this gain of
# 31.8 about 8e-6 of max|audio|) and the grade's summation order;
# measured 1.8e-5 of max|audio|, held to 5e-5.
def test_fm_kernel_route_matches_jax_pallas_interpret():
    taps = _lowpass(64, 0.03)
    n0 = 12_345
    x = _fm(5000, 125_000.0, 1_500.0, 5_000.0, n0)
    got = fm_demod_fused(TCA.from_complex(x), taps, FS, -125_000.0,
                         T.fm_demod_gain(FS, 5e3), 4, n0, precision="bf16x3")
    want = np.asarray(J.fm_demod(x, taps, FS, 0.0, 125_000.0, 5_000.0, 4,
                                 first_sample_index=n0, impl="pallas"))
    assert got.shape == want.shape == ((5000 - 64) // 4,)
    assert _rel(got.numpy(), want) < 5e-5


def test_am_kernel_route_matches_jax_pallas_interpret():
    """am_chain's plain version at bf16x3, C=1, row 0, against JAX's
    Pallas AM kernel interpreted at bf16x3; envelopes within 1e-5
    (measured 2.4e-7)."""
    taps = _lowpass(33, 0.05)
    x = _am(4096, 100_000.0, 4321)
    got = am_demod_fused(TCA.from_complex(x), taps, FS, -100_000.0, 4, 4321,
                         precision="bf16x3")
    want = np.asarray(J.am_demod(x, taps, FS, 0.0, 100_000.0, 4,
                                 first_sample_index=4321, impl="pallas"))
    assert got.shape == want.shape == ((4096 - 33) // 4 + 1,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("planar", [False, True])
def test_am_demod_matches_jax_xla(planar):
    taps = _lowpass(33, 0.05)
    x = _am(4096, 100_000.0, 999)
    xt = TCA.from_complex(x) if planar else torch.from_numpy(x)
    xj = JCA.from_complex(x) if planar else x
    want = np.asarray(J.am_demod(xj, taps, FS, 0.0, 100_000.0, 4,
                                 first_sample_index=999, impl="xla"))
    got = T.am_demod(xt, taps, FS, 0.0, 100_000.0, 4, first_sample_index=999)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the kernel route's plain version at f32 agrees with the chain
    fused = am_demod_fused(TCA.from_complex(x), taps, FS, -100_000.0, 4,
                           999, precision="f32")
    np.testing.assert_allclose(fused.numpy(), got.numpy(), atol=1e-5)


def test_cuda_impl_needs_a_cuda_tensor():
    x = torch.from_numpy(_fm(1024, 0.0, 500.0, 1e3))
    with pytest.raises(ValueError, match="impl='cuda'"):
        T.fm_demod(x, _lowpass(16, 0.1), FS, 0.0, 0.0, 1e3, 4, impl="cuda")
    with pytest.raises(ValueError, match="impl='cuda'"):
        T.am_demod(x, _lowpass(16, 0.1), FS, 0.0, 0.0, 4, impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        T.fm_demod(x, _lowpass(16, 0.1), FS, 0.0, 0.0, 1e3, 4, impl="xla")


@pytest.mark.parametrize("fits", [True, False])
def test_auto_route_on_card_takes_the_kernel_or_raises(monkeypatch, fits):
    """'auto' on a 1-D CUDA signal takes the kernel, never the composed
    chain, whether the whole bank fits one block (``fits``: T=65, D=4) or
    the kernel stages it in chunks (T=1021, D=128), and asks the card
    nothing to decide it; so does 'cuda'. A batched signal, too few
    outputs or a non-integral rate keep the composed chain under 'auto',
    as in the JAX package, and raise under 'cuda'. The signal stands in
    for a CUDA tensor."""
    import types

    from gsdr_tpu_torch.kernels import chain
    from gsdr_tpu_torch.ops import fm as fm_mod

    def no_card(*args):
        raise AssertionError(f"the route asked the card {args}")

    monkeypatch.setattr(chain, "_block_plan", no_card)
    t, d = (65, 4) if fits else (1021, 128)
    cuda = torch.device("cuda")

    def signal(n, ndim=1):
        return types.SimpleNamespace(device=cuda, shape=(2,) * (ndim - 1)
                                     + (n,), ndim=ndim)

    x1 = signal(t + 40 * d)
    for fn, lo in (("fm_demod", 2), ("am_demod", 1)):
        for impl in ("auto", "cuda"):
            assert fm_mod.route_to_kernel(fn, impl, x1, t, d, lo)
    for x, kw in ((signal(t + 40 * d, ndim=2), {}),    # batched
                  (signal(t + d - 1), {}),             # one filtered sample
                  (x1, {"rate_integral": False})):
        assert not fm_mod.route_to_kernel("fm_demod", "auto", x, t, d, 2,
                                          **kw)
        with pytest.raises(ValueError, match="impl='cuda' needs"):
            fm_mod.route_to_kernel("fm_demod", "cuda", x, t, d, 2, **kw)


@pytest.mark.parametrize("n", [1, 33, 1025])
def test_cosine_matches_jax(n):
    for phi0, phi1 in ((0.25, 7.75), (-1.5, 12.0)):
        np.testing.assert_allclose(
            T.cosine_f(phi0, phi1, n, device="cpu").numpy(),
            np.asarray(J.cosine_f(phi0, phi1, n)), rtol=1e-6, atol=1e-6)
        got = T.cosine_c(phi0, phi1, n, device="cpu")
        assert got.dtype == torch.complex64
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(J.cosine_c(phi0, phi1, n)),
                                   rtol=1e-6, atol=1e-6)
        p = T.cosine_c(phi0, phi1, n, planar=True, device="cpu")
        np.testing.assert_array_equal(p.to_complex().numpy(), got.numpy())


def test_cosine_frequency_content():
    out = T.cosine_c(0.0, 2 * np.pi * 8, 256, device="cpu").numpy()
    assert np.argmax(np.abs(np.fft.fft(out))) == 8


def _arith_inputs():
    rng = np.random.default_rng(42)
    c = (rng.normal(size=65) + 1j * rng.normal(size=65)).astype(np.complex64)
    c[3] = 0
    r = rng.normal(size=65).astype(np.float32)
    return c, r


def test_arithmetic_matches_jax():
    c, r = _arith_inputs()
    c2 = np.ascontiguousarray(c[::-1])
    cases = [
        (lambda m, x, y: m.add_const(x, 2.5), r),
        (lambda m, x, y: m.add_const(x, 0.5 - 0.25j), c),
        (lambda m, x, y: m.add_const(x, 1.5), c),
        (lambda m, x, y: m.add_const(x, 1.0 + 2.0j), r),
        (lambda m, x, y: m.add_to_magnitude(x, 0.7), c),
        (lambda m, x, y: m.add_to_magnitude(x, 0.7), r),
        (lambda m, x, y: m.multiply(x, y), c),
        (lambda m, x, y: m.multiply(x, 3.0), r),
        (lambda m, x, y: m.magnitude(x), c),
        (lambda m, x, y: m.absolute(x), r),
    ]
    for fn, x in cases:
        want = np.asarray(fn(J, x, c2))
        got = fn(T, torch.from_numpy(x), torch.from_numpy(c2)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_arithmetic_planar_matches_jax():
    c, r = _arith_inputs()
    jp, tp = JCA.from_complex(c), TCA.from_complex(c)
    for fn in (lambda m, x: m.add_const(x, 0.5 - 0.25j),
               lambda m, x: m.add_to_magnitude(x, 0.7),
               lambda m, x: m.multiply(x, x),
               lambda m, x: m.multiply(x, r)):
        want, got = fn(J, jp), fn(T, tp)
        np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(T.magnitude(tp).numpy(),
                               np.asarray(J.magnitude(jp)), rtol=1e-6)
    got = T.multiply(torch.from_numpy(r), tp)
    np.testing.assert_allclose(got.re.numpy(),
                               np.asarray(J.multiply(r, jp).re), rtol=1e-6)


def test_int8_to_norm_float_matches_jax():
    x = np.arange(-128, 128, dtype=np.int8)
    got = T.int8_to_norm_float(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(J.int8_to_norm_float(x)))
    assert got[0] == got[1] == -1.0 and got[-1] == 1.0
