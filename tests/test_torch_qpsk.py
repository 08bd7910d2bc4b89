"""Port parity: QPSK modulation, demodulation and 2-bit packing
(gsdr_tpu_torch.ops.qpsk against gsdr_tpu.ops.qpsk, JAX on CPU). Every
function is integer or sign arithmetic: bit-equal."""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu_torch.carray import ComplexArray as TCA

jq = importlib.import_module("gsdr_tpu.ops.qpsk")
tq = importlib.import_module("gsdr_tpu_torch.ops.qpsk")


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("amp", [1.0, 0.37, 2.5])
def test_constellation_equal(amp):
    _eq(tq.qpsk_constellation(amp).numpy(), jq.qpsk_constellation(amp))
    assert tq.qpsk_constellation(amp).dtype == torch.complex64
    # the float32 values, widened: JAX without x64 has no complex128
    _eq(tq.qpsk_constellation(amp, torch.complex128).numpy(),
        np.asarray(jq.qpsk_constellation(amp)).astype(np.complex128))


@pytest.mark.parametrize("shape,num", [((37,), None), ((3, 5), None),
                                       ((2, 2, 9), 31), ((8,), 29)])
def test_unpack_equal(shape, num):
    b = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    got = tq.unpack_2bit_symbols(torch.from_numpy(b), num)
    assert got.dtype == torch.int32
    _eq(got.numpy(), jq.unpack_2bit_symbols(b, num))


@pytest.mark.parametrize("n", [1, 4, 13, 64, 255])
@pytest.mark.parametrize("out_dtype", ["uint8", "int32"])
def test_pack_equal_including_partial_bytes(n, out_dtype):
    s = np.random.default_rng(n).integers(0, 4, (3, n)).astype(np.int32)
    got = tq.pack_2bit_symbols(torch.from_numpy(s),
                               out_dtype=getattr(torch, out_dtype))
    want = jq.pack_2bit_symbols(s, out_dtype=getattr(jnp, out_dtype))
    assert got.shape == want.shape == (3, -(-n // 4))
    assert str(got.dtype).endswith(out_dtype)
    _eq(got.numpy(), want)


def test_pack_defaults_to_uint8_and_round_trips():
    b = np.arange(256, dtype=np.uint8)
    sym = tq.unpack_2bit_symbols(torch.from_numpy(b))
    packed = tq.pack_2bit_symbols(sym)
    assert packed.dtype == torch.uint8
    _eq(packed.numpy(), b)


@pytest.mark.parametrize("amp", [1.0, 0.7071])
def test_modulate_symbols_equal(amp):
    s = np.random.default_rng(2).integers(0, 4, (4, 100)).astype(np.int32)
    got = tq.qpsk_modulate_symbols(torch.from_numpy(s), amp)
    want = jq.qpsk_modulate_symbols(s, amp)
    _eq(got.re.numpy(), want.re)
    _eq(got.im.numpy(), want.im)


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("num", [None, 17])
def test_modulate_equal(planar, num):
    b = np.random.default_rng(3).integers(0, 256, (2, 6)).astype(np.uint8)
    got = tq.qpsk_modulate(torch.from_numpy(b), 1.5, num, planar=planar)
    want = jq.qpsk_modulate(b, 1.5, num, planar=planar)
    if planar:
        _eq(got.re.numpy(), want.re)
        _eq(got.im.numpy(), want.im)
    else:
        assert got.dtype == torch.complex64
        _eq(got.numpy(), want)


def test_demodulate_symbols_equal_with_zero_boundaries():
    """Quadrant decisions on noise, exact zeros (toward bit 0) and signed
    zeros, planar and complex input."""
    rng = np.random.default_rng(4)
    re = rng.standard_normal((3, 64)).astype(np.float32)
    im = rng.standard_normal((3, 64)).astype(np.float32)
    re[0, :8] = 0.0
    im[1, :8] = -0.0
    got = tq.qpsk_demodulate_symbols(TCA(torch.from_numpy(re),
                                         torch.from_numpy(im)))
    want = jq.qpsk_demodulate_symbols(JCA(jnp.asarray(re), jnp.asarray(im)))
    assert got.dtype == torch.int32
    _eq(got.numpy(), want)
    z = (re + 1j * im).astype(np.complex64)
    _eq(tq.qpsk_demodulate_symbols(z).numpy(), jq.qpsk_demodulate_symbols(z))


@pytest.mark.parametrize("out_dtype", ["uint8", "int32"])
def test_demodulate_equal(out_dtype):
    rng = np.random.default_rng(5)
    z = (rng.standard_normal((2, 3, 41))
         + 1j * rng.standard_normal((2, 3, 41))).astype(np.complex64)
    got = tq.qpsk_demodulate(torch.from_numpy(z),
                             out_dtype=getattr(torch, out_dtype))
    want = jq.qpsk_demodulate(z, out_dtype=getattr(jnp, out_dtype))
    assert got.shape == want.shape == (2, 3, 11)
    _eq(got.numpy(), want)
    assert tq.qpsk_demodulate(torch.from_numpy(z)).dtype == torch.uint8


def test_loopback_with_noise():
    """Packed bytes through modulation, noise well inside the decision
    margin, and demodulation come back exact in both packages."""
    rng = np.random.default_rng(6)
    b = rng.integers(0, 256, 500).astype(np.uint8)
    x = tq.qpsk_modulate(torch.from_numpy(b), planar=True)
    noise = 0.2 * rng.standard_normal((2, 2000)).astype(np.float32)
    rx = TCA(x.re + torch.from_numpy(noise[0]), x.im + torch.from_numpy(noise[1]))
    _eq(tq.qpsk_demodulate(rx).numpy(), b)
