"""Port parity: complex tap bank, mix+FIR+decimate, LO rotation,
channelize and the quadrature demodulators (JAX on CPU as reference)."""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.utils import phase as jphase
from gsdr_tpu.utils.phase import phase_digit_table as j_table
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.utils import phase as tphase

# the packages' ops/__init__ re-export functions under the module names
jch = importlib.import_module("gsdr_tpu.ops.channelize")
jqd = importlib.import_module("gsdr_tpu.ops.quad_demod")
tch = importlib.import_module("gsdr_tpu_torch.ops.channelize")
tqd = importlib.import_module("gsdr_tpu_torch.ops.quad_demod")

FS = 1_000_000.0
SHIFTS = [float(-480_000 + 60_000 * i) for i in range(16)]


def _taps(t, cut=0.03):
    k = np.arange(t) - (t - 1) / 2.0
    h = np.sinc(2 * cut * k) * np.hamming(t)
    return (h / h.sum()).astype(np.float32)


def _planar(n, seed, lead=()):
    rng = np.random.default_rng(seed)
    re = rng.standard_normal(lead + (n,)).astype(np.float32)
    im = rng.standard_normal(lead + (n,)).astype(np.float32)
    return re, im


def _both(re, im):
    return JCA(jnp.asarray(re), jnp.asarray(im)), TCA(torch.from_numpy(re),
                                                      torch.from_numpy(im))


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("shifts,fs", [(SHIFTS, FS), ([12.5, -3_333.3], 48_000.0)])
def test_tap_bank_array_equal(shifts, fs):
    taps = _taps(64)
    np.testing.assert_array_equal(tch.make_complex_tap_bank(taps, shifts, fs),
                                  jch.make_complex_tap_bank(taps, shifts, fs))


@pytest.mark.parametrize("t,d,lead", [(64, 4, ()), (33, 3, (2,)), (7, 1, ())])
def test_mix_fir_decimate_bank_matches_jax(t, d, lead):
    bank = jch.make_complex_tap_bank(_taps(t), SHIFTS[:5], FS)
    jx, tx = _both(*_planar(2048, 1, lead))
    want = jch.mix_fir_decimate_bank(jx, bank, d)
    got = tch.mix_fir_decimate_bank(tx, torch.from_numpy(bank), d)
    assert tuple(got.shape) == want.shape == lead + (5, (2048 - t) // d + 1)
    # f32 convolutions summed in different orders: ~T ulps of the output
    assert _rel(got.re.numpy(), np.asarray(want.re)) < 1e-5
    assert _rel(got.im.numpy(), np.asarray(want.im)) < 1e-5


# The float32 digit-table phase is exact to PHASE_BOUND cycles
# (gsdr_tpu_torch/utils/phase.py): acc = sum digit*frac stays below 1024, and
# a compiler that contracts acc + digit*frac into an FMA rounds it once where
# the other rounds twice, so two correct evaluations may differ by a few
# ulps of acc (measured up to 3.05e-5 cycles with one side contracted).
PHASE_BOUND = 6e-5
TRIG_ATOL = 2e-5  # cos/sin of one float32 phase: libm vs XLA, a few ulps


@pytest.mark.parametrize("n0", [0, 999_000, 123_457])
def test_rotate_bank_matches_jax(n0):
    """The port's rotor against JAX's. The phase fractions agree modulo 1
    within PHASE_BOUND cycles; each rotated sample then within
    2*pi*PHASE_BOUND*|y| + TRIG_ATOL, since a phase error of e radians
    moves y*e^{i phi} by |y|*e at most."""
    table = j_table(SHIFTS, FS)
    re, im = _planar(1000, 2, (16,))
    jy, ty = _both(re, im)
    idx = (n0 + 4 * np.arange(1000)).astype(np.int32)[None, :]
    f_want = np.asarray(jphase.phase_fraction_from_table(
        jnp.asarray(idx), jnp.asarray(table)[:, None, :]))
    f_got = tphase.phase_fraction_from_table(
        torch.from_numpy(idx), torch.from_numpy(table)[:, None, :]).numpy()
    df = np.abs(f_got - f_want)
    assert np.max(np.minimum(df, 1.0 - df)) <= PHASE_BOUND
    want = jch.rotate_bank(jy, jnp.asarray(table), jnp.int32(n0), 4)
    got = tch.rotate_bank(ty, torch.from_numpy(table),
                          torch.tensor(n0, dtype=torch.int32), 4)
    bound = 2 * np.pi * PHASE_BOUND * np.hypot(re, im) + TRIG_ATOL
    assert np.all(np.abs(got.re.numpy() - np.asarray(want.re)) <= bound)
    assert np.all(np.abs(got.im.numpy() - np.asarray(want.im)) <= bound)


def test_channelize_matches_jax():
    """channelize = the bank (within 1e-5 of max|y|, as
    test_mix_fir_decimate_bank_matches_jax) rotated by the digit-table
    phase, held as test_rotate_bank_matches_jax holds the rotor: the phase
    fractions of the outputs agree modulo 1 within PHASE_BOUND cycles, and
    each sample within 1e-5*max|y| + 2*pi*PHASE_BOUND*|y| + TRIG_ATOL."""
    taps = _taps(64)
    re, im = _planar(4096, 3)
    jx, tx = _both(re, im)
    want = jch.channelize(jx, taps, SHIFTS, FS, 4, first_sample_index=77)
    got = tch.channelize(tx, taps, SHIFTS, FS, 4, first_sample_index=77)
    m = (4096 - 64) // 4 + 1
    assert tuple(got.shape) == want.shape == (len(SHIFTS), m)
    table = j_table(SHIFTS, FS)
    idx = (77 + 4 * np.arange(m)).astype(np.int32)[None, :]
    f_want = np.asarray(jphase.phase_fraction_from_table(
        jnp.asarray(idx), jnp.asarray(table)[:, None, :]))
    f_got = tphase.phase_fraction_from_table(
        torch.from_numpy(idx), torch.from_numpy(table)[:, None, :]).numpy()
    df = np.abs(f_got - f_want)
    assert np.max(np.minimum(df, 1.0 - df)) <= PHASE_BOUND
    # |y| of the un-rotated bank output, which the rotor does not change
    y = tch.mix_fir_decimate_bank(tx, torch.from_numpy(
        tch.make_complex_tap_bank(taps, SHIFTS, FS)), 4)
    mag = np.hypot(y.re.numpy(), y.im.numpy())
    bound = 1e-5 * mag.max() + 2 * np.pi * PHASE_BOUND * mag + TRIG_ATOL
    assert np.all(np.abs(got.re.numpy() - np.asarray(want.re)) <= bound)
    assert np.all(np.abs(got.im.numpy() - np.asarray(want.im)) <= bound)


def test_quad_demods_match_jax():
    # slowly turning phasor, clear of the atan2 branch cut
    t = np.arange(3000)
    z = (0.7 + 0.2 * np.sin(t / 50.0)) * np.exp(1j * (0.3 * np.sin(t / 40.0) + t * 0.01))
    re, im = z.real.astype(np.float32), z.imag.astype(np.float32)
    jx, tx = _both(re, im)
    np.testing.assert_allclose(tqd.quad_fm_demod(tx, 2.1).numpy(),
                               np.asarray(jqd.quad_fm_demod(jx, 2.1)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tqd.quad_am_demod(tx).numpy(),
                               np.asarray(jqd.quad_am_demod(jx)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_mix_fir_decimate_bank_impls_match_jax(impl):
    """'auto' and 'torch' run the strided conv, as JAX's 'auto'/'xla' run
    its XLA conv: f32 sums in different orders, 1e-5 of max|y|."""
    bank = jch.make_complex_tap_bank(_taps(33), SHIFTS[:7], FS)
    jx, tx = _both(*_planar(2048, 6))
    want = jch.mix_fir_decimate_bank(jx, bank, 3, impl="auto")
    got = tch.mix_fir_decimate_bank(tx, torch.from_numpy(bank), 3, impl=impl)
    assert tuple(got.shape) == want.shape == (7, (2048 - 33) // 3 + 1)
    assert _rel(got.re.numpy(), np.asarray(want.re)) < 1e-5
    assert _rel(got.im.numpy(), np.asarray(want.im)) < 1e-5


def test_mix_fir_decimate_bank_cuda_needs_the_card():
    """impl='cuda' runs kernel B4 and raises for a tensor on the CPU: it
    never falls back to the conv."""
    from gsdr_tpu_torch.kernels.channelize import (
        channelize_kernel,
        channelize_reference,
    )

    bank = tch.make_complex_tap_bank(_taps(16), SHIFTS[:2], FS)
    _, tx = _both(*_planar(256, 7))
    before = channelize_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        tch.mix_fir_decimate_bank(tx, bank, 4, impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        tch.mix_fir_decimate_bank(tx, bank, 4, impl="pallas")
    # the wrapper itself takes its plain version for CPU tensors, uncounted,
    # at the plain version's default grade f32 or the one asked for
    y = channelize_kernel(tx, torch.from_numpy(bank), 4)
    want = tch.mix_fir_decimate_bank(tx, bank, 4, impl="torch")
    torch.testing.assert_close(y.re, want.re, rtol=0, atol=0)
    y = channelize_kernel(tx, torch.from_numpy(bank), 4, precision="bf16x3")
    want = channelize_reference(tx, torch.from_numpy(bank), 4, "bf16x3")
    torch.testing.assert_close(y.re, want.re, rtol=0, atol=0)
    assert channelize_kernel.launches == before
