"""Port parity: the PFB analysis and synthesis banks of the channelized
link (gsdr_tpu_torch.ops.pfb against gsdr_tpu.ops.pfb, JAX on CPU), their
block forms, and the dense tap bank that the channelizer kernel runs for
``pfb_channelize``."""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels.channelize import channelize_reference
from gsdr_tpu_torch.utils.convert import planar_from_numpy, planar_to_numpy

jpfb = importlib.import_module("gsdr_tpu.ops.pfb")
tpfb = importlib.import_module("gsdr_tpu_torch.ops.pfb")


def _lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


def _planar(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _both(re, im):
    return (JCA(jnp.asarray(re), jnp.asarray(im)),
            TCA(torch.from_numpy(re), torch.from_numpy(im)))


def _scale(want):
    return max(float(np.max(np.abs(want))), 1.0)


def test_dft_matrices_equal():
    for k in (1, 8, 16, 32, 64):
        for got, want in zip(tpfb._dft_matrices(k), jpfb._dft_matrices(k)):
            np.testing.assert_array_equal(got, want)


# (K, Q) of tests/test_pfb.py
@pytest.mark.parametrize("k,q", [(16, 8), (8, 4), (64, 4)])
def test_pfb_channelize_matches_jax_xla(k, q):
    """The fold path against JAX's: both f32 fold + DFT, summed in other
    orders; held to the JAX tests' 2e-4 * scale."""
    taps = _lowpass(k * q, 0.4 / k)
    jx, tx = _both(*_planar(k * 64 + k * q, 1))
    want = jpfb.pfb_channelize(jx, taps, k, impl="xla").to_numpy()
    got = tpfb.pfb_channelize(tx, taps, k, impl="torch").to_numpy()
    assert got.shape == want.shape == (k, 65)
    np.testing.assert_allclose(got, want, atol=2e-4 * _scale(want))
    # on the CPU 'auto' is the fold path
    auto = tpfb.pfb_channelize(tx, taps, k).to_numpy()
    np.testing.assert_array_equal(auto, got)


@pytest.mark.parametrize("k,q", [(16, 8), (8, 4)])
def test_pfb_channelize_matches_jax_pallas(k, q):
    """Against the TPU kernel B4 interpreted (bf16x3, ~1e-4 relative):
    3e-4 * scale, as tests/test_pfb.py holds it to the XLA path."""
    taps = _lowpass(k * q, 0.4 / k)
    jx, tx = _both(*_planar(k * 256 + k * q, 2))
    want = jpfb.pfb_channelize(jx, taps, k, impl="pallas").to_numpy()
    got = tpfb.pfb_channelize(tx, taps, k, impl="torch").to_numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-4 * _scale(want))


@pytest.mark.parametrize("k,t", [(16, 128), (32, 256), (8, 29)])
def test_kernel_route_bank_matches_fold(k, t):
    """The bank that 'auto'/'cuda' hand the channelizer kernel (taps padded
    to Q*K, integral shifts -c over Fs = K), run through the kernel's plain
    version, against the fold path: one function, two factorisations, f32
    sums of T products in other orders (2e-5 * scale)."""
    taps = _lowpass(t, 0.5 / k)
    re, im = _planar(k * 40 + t, 3)
    x = TCA(torch.from_numpy(re), torch.from_numpy(im))
    bank, _, _, _ = tpfb._analysis_tables(tpfb._taps_key(taps), k,
                                          torch.device("cpu"))
    q = -(-t // k)
    assert tuple(bank.shape) == (2 * k, 2, q * k)
    dense = channelize_reference(x, bank, k).to_numpy()
    fold = tpfb.pfb_channelize(x, taps, k, impl="torch").to_numpy()
    assert dense.shape == fold.shape
    np.testing.assert_allclose(dense, fold, atol=2e-5 * _scale(fold))


def test_pfb_channelize_batched_matches_jax():
    k, q = 8, 4
    taps = _lowpass(k * q, 0.4 / k)
    jx, tx = _both(*_planar((3, 2, k * 50), 4))
    want = jpfb.pfb_channelize(jx, taps, k).to_numpy()
    got = tpfb.pfb_channelize(tx, taps, k).to_numpy()
    assert got.shape == want.shape == (3, 2, k, 47)
    np.testing.assert_allclose(got, want, atol=2e-4 * _scale(want))


def test_pfb_channelize_checks():
    taps = _lowpass(64, 0.05)
    x = TCA(torch.zeros(128), torch.zeros(128))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpfb.pfb_channelize(x, taps, 16, impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        tpfb.pfb_channelize(x, taps, 16, impl="pallas")
    with pytest.raises(ValueError, match="at least"):
        tpfb.pfb_channelize(TCA(torch.zeros(48), torch.zeros(48)), taps, 16)


@pytest.mark.parametrize("k,q,blocks", [(16, 8, [256, 512, 48, 208]),
                                        (8, 4, [8, 64, 16])])
def test_pfb_channelize_block_split_and_tail(k, q, blocks):
    """Block by block equals one shot (the same fold on the same joined
    samples: equal to f32 rounding, 1e-6 * scale); after every block the
    carried tail is JAX's, bit for bit (it is a copy of input samples);
    a block shorter than the tail keeps part of the previous tail."""
    taps = _lowpass(k * q, 0.4 / k)
    re, im = _planar(sum(blocks), 5)
    hist = (q - 1) * k
    zeros = np.zeros(hist, np.float32)
    jx, tx = _both(np.concatenate([zeros, re]), np.concatenate([zeros, im]))
    whole = tpfb.pfb_channelize(tx, taps, k).to_numpy()
    jtail = ttail = None
    outs, start = [], 0
    for b in blocks:
        jb, tb = _both(re[start:start + b], im[start:start + b])
        _, jtail = jpfb.pfb_channelize_block(jb, taps, k, tail=jtail)
        y, ttail = tpfb.pfb_channelize_block(tb, taps, k, tail=ttail)
        outs.append(y.to_numpy())
        np.testing.assert_array_equal(ttail.re.numpy(), np.asarray(jtail.re))
        np.testing.assert_array_equal(ttail.im.numpy(), np.asarray(jtail.im))
        start += b
    got = np.concatenate(outs, axis=-1)
    assert got.shape == whole.shape
    np.testing.assert_allclose(got, whole, atol=1e-6 * _scale(whole))


def test_pfb_channelize_block_checks_k_multiple():
    x = TCA(torch.zeros(100), torch.zeros(100))
    with pytest.raises(ValueError, match="multiple of num_channels"):
        tpfb.pfb_channelize_block(x, _lowpass(64, 0.05), 16)


def test_pfb_channelize_block_tail_crosses_packages():
    """A stream begun in JAX continues in the port: JAX's tail crosses
    through numpy (utils/convert.py) and the port's next block equals
    JAX's next block (2e-4 * scale, the fold tolerance)."""
    k, q = 16, 8
    taps = _lowpass(k * q, 0.4 / k)
    re, im = _planar(3 * 512, 6)
    jtail = None
    for i in range(2):
        jb, _ = _both(re[i * 512:(i + 1) * 512], im[i * 512:(i + 1) * 512])
        _, jtail = jpfb.pfb_channelize_block(jb, taps, k, tail=jtail)
    jb, tb = _both(re[1024:], im[1024:])
    want, _ = jpfb.pfb_channelize_block(jb, taps, k, tail=jtail)
    tail = planar_from_numpy((np.asarray(jtail.re), np.asarray(jtail.im)),
                             "cpu")
    got, new_tail = tpfb.pfb_channelize_block(tb, taps, k, tail=tail)
    want = want.to_numpy()
    np.testing.assert_allclose(got.to_numpy(), want, atol=2e-4 * _scale(want))
    back = planar_to_numpy(new_tail)
    np.testing.assert_array_equal(back[0], re[-(q - 1) * k:])
    np.testing.assert_array_equal(back[1], im[-(q - 1) * k:])


# (K, hop, T): critical, hops D | K, a ragged prototype, and hop = 1
SYNTH = [(16, None, 128), (8, None, 29), (16, 8, 128), (16, 4, 125),
         (8, 2, 64), (8, 1, 24)]


@pytest.mark.parametrize("k,hop,t", SYNTH)
def test_pfb_synthesize_matches_jax(k, hop, t):
    """Inverse DFT + per-lane causal FIR in f32, other summation orders:
    1e-5 * scale. Leading batch axes broadcast."""
    taps = _lowpass(t, 0.5 / k)
    jy, ty = _both(*_planar((2, k, 37 if hop is None else 40), 7))
    want = jpfb.pfb_synthesize(jy, taps, k, hop=hop).to_numpy()
    got = tpfb.pfb_synthesize(ty, taps, k, hop=hop).to_numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * _scale(want))


@pytest.mark.parametrize("k,hop,t", SYNTH)
def test_pfb_synthesize_block_matches_jax(k, hop, t):
    """Three streamed blocks (frame counts multiples of P = K/hop) against
    JAX's block form, 1e-5 * scale; each carried tail equals JAX's bit for
    bit (a copy of input frames); the blocks together equal the one-shot
    synthesis of the joined frames."""
    taps = _lowpass(t, 0.5 / k)
    p = 1 if hop is None else k // hop
    sizes = [4 * p, 12 * p, 2 * p]
    re, im = _planar((k, sum(sizes)), 8)
    jtail = ttail = None
    outs, start = [], 0
    for b in sizes:
        jb, tb = _both(re[:, start:start + b], im[:, start:start + b])
        jout, jtail = jpfb.pfb_synthesize_block(jb, taps, k, tail=jtail,
                                                hop=hop)
        tout, ttail = tpfb.pfb_synthesize_block(tb, taps, k, tail=ttail,
                                                hop=hop)
        want = jout.to_numpy()
        np.testing.assert_allclose(tout.to_numpy(), want,
                                   atol=1e-5 * _scale(want))
        np.testing.assert_array_equal(ttail.re.numpy(), np.asarray(jtail.re))
        np.testing.assert_array_equal(ttail.im.numpy(), np.asarray(jtail.im))
        outs.append(tout.to_numpy())
        start += b
    whole = tpfb.pfb_synthesize(TCA(torch.from_numpy(re), torch.from_numpy(im)),
                                taps, k, hop=hop).to_numpy()
    np.testing.assert_allclose(np.concatenate(outs), whole,
                               atol=1e-5 * _scale(whole))


def test_pfb_synthesize_checks():
    taps = _lowpass(64, 0.05)
    y = TCA(torch.zeros(16, 8), torch.zeros(16, 8))
    with pytest.raises(ValueError, match="positive divisor"):
        tpfb.pfb_synthesize(y, taps, 16, hop=5)
    with pytest.raises(ValueError, match="positive divisor"):
        tpfb.pfb_synthesize_block(y, taps, 16, hop=0)
    with pytest.raises(ValueError, match="channels axis"):
        tpfb.pfb_synthesize(y, taps, 8)
    # hop 4 at K=16: P = 4, so 6 frames would break the phase pattern
    with pytest.raises(ValueError, match="multiple of"):
        tpfb.pfb_synthesize_block(TCA(torch.zeros(16, 6), torch.zeros(16, 6)),
                                  taps, 16, hop=4)


def test_synthesis_then_analysis_round_trip():
    """A channel tone synthesized at bin c comes back in channel c: the
    banks invert each other (up to the prototype pair's response)."""
    k, q = 16, 8
    taps = _lowpass(k * q, 0.5 / k)
    y = np.zeros((k, 400), np.complex64)
    y[5] = 1.0
    wide = tpfb.pfb_synthesize(TCA.from_complex(y), taps, k)
    back = tpfb.pfb_channelize(wide, taps, k).to_numpy()[:, 2 * q:]
    power = np.mean(np.abs(back) ** 2, axis=-1)
    assert np.argmax(power) == 5
    assert power[5] > 100 * np.max(np.delete(power, 5))
