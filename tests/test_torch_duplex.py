"""Port parity: the channelized QPSK link (transmultiplexer) of
gsdr_tpu_torch.examples.qpsk_transmux against examples/qpsk_transmux.py,
JAX on CPU, with the PFB banks' tails carried across packages mid-stream."""

import numpy as np
import jax.numpy as jnp
import torch

from examples.qpsk_transmux import lowpass as j_lowpass
from examples.qpsk_transmux import run_transmux as j_run_transmux
from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.ops.pfb import (
    pfb_channelize as j_channelize,
    pfb_channelize_block as j_channelize_block,
    pfb_synthesize as j_synthesize,
    pfb_synthesize_block as j_synthesize_block,
)
from gsdr_tpu.ops.qpsk import qpsk_modulate_symbols as j_modulate
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.examples import qpsk_transmux as T
from gsdr_tpu_torch.ops.pfb import (
    pfb_channelize,
    pfb_channelize_block,
    pfb_synthesize,
    pfb_synthesize_block,
)
from gsdr_tpu_torch.ops.qpsk import qpsk_modulate_symbols
from gsdr_tpu_torch.utils.convert import planar_from_numpy, planar_to_numpy


def _scale(a):
    return max(float(np.max(np.abs(a))), 1.0)


def planar_to_numpy_j(x):
    """A JAX planar pair -> (re, im) numpy arrays."""
    return np.asarray(x.re), np.asarray(x.im)


def _planar_np(z):
    return (np.ascontiguousarray(z.real, np.float32),
            np.ascontiguousarray(z.imag, np.float32))


def test_transmux_matches_jax_example():
    """K=16, M=2048 at 25 dB, the example's own draws (numpy seed 0): the
    port's synthesis within 1e-5 * scale of JAX's, its analysis of the
    same noisy stream within 2e-4 * scale, and SER 0 on both sides with
    the same EVMs (1e-4 relative: outputs that differ by f32 rounding)."""
    k, m, q, snr = 16, 2048, 8, 25.0
    j_ser, j_evm, j_tot = j_run_transmux(k, m, snr_db=snr)
    assert j_ser.max() == 0.0 and j_tot > 30_000

    rng = np.random.default_rng(0)               # the example's draw order
    taps = j_lowpass(q * k, 0.5 / k)
    np.testing.assert_array_equal(T.lowpass(q * k, 0.5 / k), taps)
    syms = rng.integers(0, 4, (k, m)).astype(np.int32)
    j_tx = j_modulate(jnp.asarray(syms), 1.0)
    t_tx = qpsk_modulate_symbols(torch.from_numpy(syms), 1.0)
    wide = j_synthesize(j_tx, taps, k).to_numpy()
    t_wide = pfb_synthesize(t_tx, taps, k).to_numpy()
    np.testing.assert_allclose(t_wide, wide, atol=1e-5 * _scale(wide))

    p_sig = float(np.mean(np.abs(wide) ** 2))
    sigma = np.sqrt(p_sig / (10.0 ** (snr / 10.0)) / 2.0)
    noisy = wide + sigma * (rng.standard_normal(wide.shape)
                            + 1j * rng.standard_normal(wide.shape))
    re, im = _planar_np(noisy)
    y_j = j_channelize(JCA(jnp.asarray(re), jnp.asarray(im)), taps, k)
    y_t = pfb_channelize(TCA(torch.from_numpy(re), torch.from_numpy(im)),
                         taps, k)
    np.testing.assert_allclose(y_t.to_numpy(), y_j.to_numpy(),
                               atol=2e-4 * _scale(y_j.to_numpy()))
    ser, evm, tot = T.link_quality(y_t, t_tx, q)
    assert tot == j_tot
    assert ser.max() == 0.0, ser
    np.testing.assert_allclose(evm, j_evm, rtol=1e-4)
    assert evm.max() < 0.3


def test_port_transmux_streams_error_free():
    """The port's own link, streamed in 4 blocks with torch.Generator
    draws: SER 0 and EVM < 0.3 at 25 dB (the critical cascade's EVM ~0.24
    sits inside QPSK's 0.707 margin)."""
    ser, evm, tot = T.run_transmux(16, 2048, snr_db=25.0, blocks=4,
                                   device="cpu")
    assert tot > 30_000
    assert ser.max() == 0.0, ser
    assert evm.max() < 0.3, evm


def test_port_transmux_degrades_with_noise():
    _, evm_hi, _ = T.run_transmux(8, 1024, snr_db=30.0, seed=2, device="cpu")
    _, evm_lo, _ = T.run_transmux(8, 1024, snr_db=5.0, seed=2, device="cpu")
    assert evm_lo.mean() > evm_hi.mean()


def test_link_tails_cross_packages_mid_stream():
    """Both banks start a stream in JAX and finish it in the port: the
    synthesis tail and the analysis tail cross through numpy
    (utils/convert.py). The joined output equals the port's one-shot link
    within 2e-4 * scale (f32 fold and DFT in other orders)."""
    k, q, m = 8, 8, 512
    taps = j_lowpass(q * k, 0.5 / k)
    syms = np.random.default_rng(7).integers(0, 4, (k, m)).astype(np.int32)
    j_tx = j_modulate(jnp.asarray(syms), 1.0)
    half = m // 2
    wide_a, j_stail = j_synthesize_block(j_tx[..., :half], taps, k)
    t_tx = qpsk_modulate_symbols(torch.from_numpy(syms), 1.0)
    wide_b, _ = pfb_synthesize_block(
        t_tx[..., half:], taps, k,
        tail=planar_from_numpy(planar_to_numpy_j(j_stail), "cpu"))
    wide = np.concatenate([wide_a.to_numpy(), wide_b.to_numpy()])
    one_shot = pfb_synthesize(t_tx, taps, k).to_numpy()
    np.testing.assert_allclose(wide, one_shot, atol=1e-5 * _scale(one_shot))

    re, im = _planar_np(wide)
    n = re.shape[0] // 2
    y_a, j_atail = j_channelize_block(
        JCA(jnp.asarray(re[:n]), jnp.asarray(im[:n])), taps, k)
    y_b, t_atail = pfb_channelize_block(
        TCA(torch.from_numpy(re[n:]), torch.from_numpy(im[n:])), taps, k,
        tail=planar_from_numpy(planar_to_numpy_j(j_atail), "cpu"))
    y = np.concatenate([y_a.to_numpy(), y_b.to_numpy()], axis=-1)[:, q - 1:]
    want = pfb_channelize(TCA(torch.from_numpy(re), torch.from_numpy(im)),
                          taps, k).to_numpy()
    np.testing.assert_allclose(y, want, atol=2e-4 * _scale(want))
    back = planar_to_numpy(t_atail)
    np.testing.assert_array_equal(back[0], re[-(q - 1) * k:])
    ser, _, _ = T.link_quality(TCA(torch.from_numpy(y.real.astype(np.float32)),
                                   torch.from_numpy(y.imag.astype(np.float32))),
                               t_tx, q, n_pilots=128)
    assert ser.max() == 0.0


