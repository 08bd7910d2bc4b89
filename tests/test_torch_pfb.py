"""Port parity: the uniform-grid PFB front and its host tables
(gsdr_tpu_torch.ops.pfb against gsdr_tpu.ops.pfb and the PFB tables of
gsdr_tpu/kernels/fm_chain_pallas.py, JAX on CPU), and the receivers'
choice of front (gsdr_tpu_torch.kernels.chain)."""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.kernels import fm_chain_pallas as jfc
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels import chain
from gsdr_tpu_torch.kernels.am_chain import am_chain, pfb_am_chain
from gsdr_tpu_torch.kernels.channelize import channelize_kernel
from gsdr_tpu_torch.kernels.fm_chain import fm_chain, pfb_fm_chain
from gsdr_tpu_torch.kernels.qpsk256 import qpsk256_kernel

jpfb = importlib.import_module("gsdr_tpu.ops.pfb")
tpfb = importlib.import_module("gsdr_tpu_torch.ops.pfb")
tch = importlib.import_module("gsdr_tpu_torch.ops.channelize")

FS = 1_000_000.0


def _taps(t, cut):
    k = np.arange(t) - (t - 1) / 2.0
    h = np.sinc(2 * cut * k) * np.hamming(t)
    return (h / h.sum()).astype(np.float32)


def _planar(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# (shifts, Fs, D): grids found, lifted to a D multiple, wrapped bins, and
# shifts on no grid (None)
GRIDS = [
    ([-(FS / 64) * i for i in range(64)], FS, 64),
    ([(FS / 64) * 2 * i for i in range(16)], FS, 64),
    ([(FS / 64) * i for i in range(64)], FS, 8),
    ([200_000.0 - 50_000.0 * i for i in range(8)], FS, 4),
    ([-FS / 2 + (FS / 32) * c for c in range(32)], FS, 32),
    ([12_345.678, 0.0], FS, 4),
    ([1.0, 3.0], 7.0, 1),
    ([], FS, 4),
]


@pytest.mark.parametrize("shifts,fs,d", GRIDS)
def test_uniform_grid_equal(shifts, fs, d):
    for kw in ({}, {"multiple_of": d}, {"multiple_of": d, "max_k": 32}):
        assert tpfb.uniform_grid(shifts, fs, **kw) == \
            jpfb.uniform_grid(shifts, fs, **kw)
    assert tpfb.uniform_grid(shifts, 0.0) is None


@pytest.mark.parametrize("shifts,fs,d", GRIDS)
@pytest.mark.parametrize("t", [512, 64, 2000])
def test_pfb_preferred_equal(shifts, fs, d, t):
    assert tpfb.pfb_preferred(shifts, fs, d, t) == \
        jpfb.pfb_preferred(shifts, fs, d, t)


def test_pfb_preferred_cases():
    """The wideband configurations route to the PFB front; short filters,
    P = 16 oversampling, a sparse grid and an off-grid bank do not."""
    wide = [(FS / 64) * i for i in range(64)]
    assert tpfb.pfb_preferred(wide, FS, 64, 512) == (64, list(range(64)))
    assert tpfb.pfb_preferred(wide, FS, 8, 512) is not None
    assert tpfb.pfb_preferred(wide, FS, 4, 512) is None          # P = 16
    assert tpfb.pfb_preferred(wide, FS, 64, 128) is None         # Q = 2
    assert tpfb.pfb_preferred(wide[:8], FS, 64, 512) is None     # C < K/2
    assert tpfb.pfb_preferred([12_345.678], FS, 4, 512) is None  # no grid


@pytest.mark.parametrize("t,k", [(512, 64), (29, 8), (7, 16), (64, 64)])
def test_polyphase_tables_equal(t, k):
    taps = _taps(t, 0.4 / k)
    np.testing.assert_array_equal(tpfb.pfb_taps_to_polyphase(taps, k),
                                  jpfb.pfb_taps_to_polyphase(taps, k))
    np.testing.assert_array_equal(tpfb._poly_taps(taps, k),
                                  jfc._poly_taps(taps, k))


@pytest.mark.parametrize("k,bins,c_eff", [(64, list(range(64)), 64),
                                          (8, [0, 3, 7, 5, 1], 8),
                                          (20, [4, 3, 2, 1, 0, 19, 18, 17], 8)])
def test_dft_banks_equal(k, bins, c_eff):
    """The port's banks equal JAX's; JAX pads the planes-major bank to
    c_eff rows per plane with zeros, the port keeps only its C rows."""
    np.testing.assert_array_equal(tpfb._dft_bank_matrix(bins, k),
                                  jpfb._dft_bank_matrix(bins, k))
    c = len(bins)
    got = tpfb._dft_bank_stacked(bins, k)
    want = jfc._dft_bank_stacked(bins, k, c_eff)
    assert got.shape == (2 * c, 2 * k)
    np.testing.assert_array_equal(got[:c], want[:c])
    np.testing.assert_array_equal(got[c:], want[c_eff:c_eff + c])
    assert not want[c:c_eff].any() and not want[c_eff + c:].any()


def test_pfb_front_supported():
    """On the CPU the plain chains take any grid with D | K, however long
    the fold; the shared-memory rule applies only on the card."""
    assert chain.front_supported("fm_chain", "cpu", 512, 64, 64)
    assert chain.front_supported("am_chain", "cpu", 512, 8, 64)
    assert chain.front_supported("fm_chain", "cpu", 8 * 1024, 1024, 1024)
    assert chain.front_supported("fm_chain", "cpu", 128 * 8 + 1, 8, 8)
    assert not chain.front_supported("fm_chain", "cpu", 64, 8, 12)
    assert not chain.front_supported("am_chain", "cpu", 64, 3, 16)
    assert chain.front_supported("fm_chain", "cpu", 64, 4)      # dense


WIDE = [-(FS / 64) * i for i in range(64)]


@pytest.mark.parametrize("impl,shifts,d,want", [
    ("auto", WIDE, 64, None),            # on the CPU 'auto' stays dense
    ("torch", WIDE, 64, None),
    ("pfb", WIDE, 64, 64),
    ("pfb_torch", WIDE, 8, 64),
    ("pfb", [200_000.0 - 50_000.0 * i for i in range(8)], 4, 20),
])
def test_select_front_on_cpu(impl, shifts, d, want):
    grid = chain.select_front("model", "fm_chain", impl, shifts, FS, d, 512,
                              torch.device("cpu"))
    assert (grid if grid is None else grid[0]) == want
    if grid is not None:
        assert grid == tpfb.uniform_grid(shifts, FS, multiple_of=d)


def test_select_front_rejects_off_grid_pfb():
    with pytest.raises(ValueError, match="Fs/K grid"):
        chain.select_front("model", "am_chain", "pfb", [12_345.678, 0.0], FS,
                           4, 64, torch.device("cpu"))


@pytest.mark.parametrize("kernel", [fm_chain, pfb_fm_chain, am_chain,
                                    pfb_am_chain, channelize_kernel,
                                    qpsk256_kernel], ids=lambda k: k.name)
def test_wrapper_rejects_a_device_other_than_cuda_or_cpu(kernel):
    """A wrapper takes its plain version only for CPU tensors and counts
    only kernel launches: tensors on any other device raise."""
    buf = TCA(torch.zeros(64, device="meta"), torch.zeros(64, device="meta"))
    before = kernel.launches
    with pytest.raises(ValueError, match="need cuda or cpu"):
        kernel(buf)
    assert kernel.launches == before


# (K, D, T = qK - r, C bins): D | K, ragged fold tails, C < K with wrapped
# and unordered bins
FRONTS = [(8, 4, 29, [0, 3, 7, 5, 1]), (16, 16, 64, list(range(16))),
          (12, 3, 35, [11, 0, 6, 2]), (8, 1, 23, [1, 2, 3, 4, 5, 6]),
          (32, 8, 127, list(range(0, 32, 3)))]


@pytest.mark.parametrize("k,d,t,bins", FRONTS)
def test_mix_fir_decimate_bank_uniform_matches_jax(k, d, t, bins):
    taps = _taps(t, 0.4 / k)
    re, im = _planar(1500, 4)
    want = jpfb.mix_fir_decimate_bank_uniform(
        JCA(jnp.asarray(re), jnp.asarray(im)), taps, bins, k, d)
    got = tpfb.mix_fir_decimate_bank_uniform(
        TCA(torch.from_numpy(re), torch.from_numpy(im)), taps, bins, k, d)
    assert tuple(got.shape) == want.shape == (len(bins), (1500 - t) // d + 1)
    # f32 fold and DFT summed in different orders: a few ulps of the output
    assert _rel(got.re.numpy(), np.asarray(want.re)) < 1e-5
    assert _rel(got.im.numpy(), np.asarray(want.im)) < 1e-5


@pytest.mark.parametrize("k,d,t,bins", FRONTS)
def test_pfb_front_matches_dense_front(k, d, t, bins):
    """The same channels through the port's PFB front and its dense tap
    bank (shift f_c = bins[c] * Fs / K): one function, two factorisations."""
    taps = _taps(t, 0.4 / k)
    re, im = _planar(1200, 5)
    x = TCA(torch.from_numpy(re), torch.from_numpy(im))
    shifts = [b * FS / k for b in bins]
    dense = tch.mix_fir_decimate_bank(
        x, torch.from_numpy(tch.make_complex_tap_bank(taps, shifts, FS)), d)
    pfb = tpfb.mix_fir_decimate_bank_uniform(x, taps, bins, k, d)
    assert pfb.shape == dense.shape
    assert _rel(pfb.re.numpy(), dense.re.numpy()) < 1e-5
    assert _rel(pfb.im.numpy(), dense.im.numpy()) < 1e-5


def test_uniform_front_rejects_bad_geometry():
    x = TCA(torch.zeros(100), torch.zeros(100))
    with pytest.raises(ValueError, match="D | K"):
        tpfb.mix_fir_decimate_bank_uniform(x, _taps(16, 0.05), [0, 1], 12, 8)
    with pytest.raises(ValueError, match="at least"):
        tpfb.mix_fir_decimate_bank_uniform(x, _taps(128, 0.05), [0, 1], 8, 8)
