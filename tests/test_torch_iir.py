"""Port parity: the exact blocked IIR scan (gsdr_tpu_torch.ops.iir
against gsdr_tpu.ops.iir's XLA path on CPU, and against its own
sequential reference)."""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu_torch.carray import ComplexArray as TCA

jiir = importlib.import_module("gsdr_tpu.ops.iir")
tiir = importlib.import_module("gsdr_tpu_torch.ops.iir")

# flagship de-emphasis (75 us at 250 kHz audio) and a stable third order
DEEMPH = ((0.025955, 0.025955), (1.0, -0.94809))
ORDER3 = ((0.05, 0.1, 0.07, 0.02), (1.0, -1.3, 0.6, -0.1))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("block_len", [1, 37, 128, 256])
@pytest.mark.parametrize("ba", [DEEMPH, ORDER3], ids=["deemph", "order3"])
def test_iir_block_batched_matches_jax(ba, block_len):
    b, a = ba
    m = len(b) - 1
    x = _x((16, 1000), 1)
    zi = _x((16, m), 2)
    yj, zj = jiir.iir_block(jnp.asarray(b, jnp.float32),
                            jnp.asarray(a, jnp.float32), jnp.asarray(x),
                            zi=jnp.asarray(zi), block_len=block_len, impl="xla")
    yt, zt = tiir.iir_block(b, a, torch.from_numpy(x),
                            zi=torch.from_numpy(zi), block_len=block_len)
    assert tuple(yt.shape) == (16, 1000) and tuple(zt.shape) == (16, m)
    # both exact scans in f32, composed in another order: f32 rounding only
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("block_len", [16, 256])
def test_iir_block_matches_sequential_reference(block_len):
    b, a = ORDER3
    x = _x((3, 777), 3)
    zi = _x((3, 3), 4)
    y, zf = tiir.iir_block(b, a, torch.from_numpy(x), zi=torch.from_numpy(zi),
                           block_len=block_len)
    want = tiir.iir_reference(b, a, torch.from_numpy(x), zi=torch.from_numpy(zi))
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5, atol=2e-5)
    # continuation: the final state carries into the next block exactly
    x2 = _x((3, 300), 5)
    y2, _ = tiir.iir_block(b, a, torch.from_numpy(x2), zi=zf, block_len=block_len)
    whole = tiir.iir_reference(b, a, torch.from_numpy(np.concatenate([x, x2], -1)),
                               zi=torch.from_numpy(zi))
    np.testing.assert_allclose(y2.numpy(), whole[:, 777:].numpy(),
                               rtol=1e-5, atol=2e-5)


def test_iir_reference_matches_jax_1d():
    b, a = ORDER3
    x = _x((500,), 6)
    zi = _x((3,), 7)
    want = np.asarray(jiir.iir_reference(jnp.asarray(b, jnp.float32),
                                         jnp.asarray(a, jnp.float32),
                                         jnp.asarray(x), zi=jnp.asarray(zi)))
    got = tiir.iir_reference(b, a, torch.from_numpy(x), zi=torch.from_numpy(zi))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_iir_planar_and_coeff_checks():
    b, a = DEEMPH
    re, im = _x((2, 400), 8), _x((2, 400), 9)
    zr, zim = _x((2, 1), 10), _x((2, 1), 11)
    yj, zj = jiir.iir_block(jnp.asarray(b, jnp.float32), jnp.asarray(a, jnp.float32),
                            JCA(jnp.asarray(re), jnp.asarray(im)),
                            zi=JCA(jnp.asarray(zr), jnp.asarray(zim)),
                            block_len=64, impl="xla")
    yt, zt = tiir.iir_block(b, a, TCA(torch.from_numpy(re), torch.from_numpy(im)),
                            zi=TCA(torch.from_numpy(zr), torch.from_numpy(zim)),
                            block_len=64)
    np.testing.assert_allclose(yt.re.numpy(), np.asarray(yj.re), atol=2e-5)
    np.testing.assert_allclose(yt.im.numpy(), np.asarray(yj.im), atol=2e-5)
    np.testing.assert_allclose(zt.im.numpy(), np.asarray(zj.im), atol=2e-5)
    np.testing.assert_allclose(tiir.iir(b, a, torch.from_numpy(re)).numpy(),
                               np.asarray(jiir.iir(jnp.asarray(b, jnp.float32),
                                                   jnp.asarray(a, jnp.float32),
                                                   jnp.asarray(re), impl="xla")),
                               atol=2e-5)
    with pytest.raises(ValueError):
        tiir.iir_block((1.0,), (1.0,), torch.zeros(8))
    with pytest.raises(ValueError):
        tiir.iir_block((1.0, 0.5), (1.0, 0.1, 0.2), torch.zeros(8))
