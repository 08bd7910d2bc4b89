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


# ---------------------------------------------------------------------------
# Kernel B6's candidate grid (gsdr_tpu_torch.kernels.qpsk256.candidate_grid)
# ---------------------------------------------------------------------------

import re as _re
from pathlib import Path

from gsdr_tpu_torch.kernels import qpsk256 as tkq


def _random_table(seed=12):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(256) + 1j * rng.standard_normal(256)
    return z.astype(np.complex64)


GRID_TABLES = {
    "circular_1": lambda: jq.qpsk256_constellation(jq.CIRCULAR, 1.0),
    "circular_2": lambda: jq.qpsk256_constellation(jq.CIRCULAR, 2.0),
    "rectangular_1": lambda: jq.qpsk256_constellation(jq.RECTANGULAR, 1.0),
    "rectangular_2": lambda: jq.qpsk256_constellation(jq.RECTANGULAR, 2.0),
    "random": _random_table,
}


def _planar(z):
    z = np.asarray(z, np.complex64)
    return TCA(torch.from_numpy(np.ascontiguousarray(z.real)),
               torch.from_numpy(np.ascontiguousarray(z.imag)))


def _grid_search(x, table, grid):
    """The candidate search in plain torch, as csrc/qpsk256.cu runs it: a
    sample in the box takes the lowest score over its cell's list (the
    first minimum in ascending index), one outside it the lowest over all
    256 points; scores as qpsk256_reference forms them."""
    ct, c2 = tkq.score_table(table)
    xf = torch.stack([x.re.reshape(-1), x.im.reshape(-1)], dim=-1)
    with tkq.full_f32():
        scores = c2[None, :] - 2.0 * torch.matmul(xf, ct)
    cells = grid.cells(x.re.reshape(-1), x.im.reshape(-1))
    out = torch.argmin(scores, dim=-1)
    inside = cells >= 0
    if grid.g and bool(inside.any()):
        counts = np.diff(grid.offsets)
        lists = np.full((grid.g * grid.g, int(counts.max())), -1, np.int64)
        for cell, (a, b) in enumerate(zip(grid.offsets[:-1], grid.offsets[1:])):
            lists[cell, :b - a] = grid.cand[a:b]
        cand = torch.from_numpy(lists)[cells[inside]]
        s = torch.gather(scores[inside], 1, cand.clamp(min=0))
        s = torch.where(cand >= 0, s, torch.full_like(s, float("inf")))
        out[inside] = torch.gather(cand, 1, torch.argmin(s, 1, keepdim=True))[:, 0]
    return out.to(torch.int32).reshape(x.re.shape)


def _grid_inputs(kind, z, grid):
    """Samples of one kind for a table z and its grid (complex64)."""
    rng = np.random.default_rng(7)
    scale = float(np.max(np.abs(z)))
    if kind == "noisy":
        s = z[rng.integers(0, 256, 20000)]
        return s + 0.05 * scale * (rng.standard_normal(20000)
                                   + 1j * rng.standard_normal(20000))
    if kind == "midpoints":
        i, j = np.triu_indices(256, 1)
        return (z[i].astype(np.complex128) + z[j]) / 2
    cell = 1.0 / np.float64(grid.inv_cell)
    lines_x = np.float64(grid.x0) + cell * np.arange(grid.g + 1)
    lines_y = np.float64(grid.y0) + cell * np.arange(grid.g + 1)
    if kind == "cell_edges":
        # corners, edge midpoints and their float32 neighbours
        mid_x, mid_y = lines_x[:-1] + cell / 2, lines_y[:-1] + cell / 2
        pts = [lines_x[:, None] + 1j * lines_y[None, :],
               mid_x[:, None] + 1j * lines_y[None, :],
               lines_x[:, None] + 1j * mid_y[None, :]]
        base = np.concatenate([p.reshape(-1) for p in pts]).astype(np.complex64)
        re, im = base.real, base.imag
        out = [base]
        for d in (-np.inf, np.inf):
            out.append(np.nextafter(re, np.float32(d)) + 1j * im)
            out.append(re + 1j * np.nextafter(im, np.float32(d)))
        return np.concatenate(out)
    # outside: beyond each side of the box and far away
    span = lines_x[-1] - lines_x[0]
    t = rng.uniform(0, 1, 2000)
    return np.concatenate([
        lines_x[0] - 0.05 * span + 1j * (lines_y[0] + t * span),
        lines_x[-1] + 1e-3 * span + 1j * (lines_y[0] + t * span),
        lines_x[0] + t * span + 1j * (lines_y[-1] + 0.1 * span),
        (lines_x[0] + t * span) + 1j * (lines_y[0] - 1e-3 * span),
        1e3 * scale * np.exp(2j * np.pi * t)])


@pytest.mark.parametrize("kind", ["noisy", "midpoints", "cell_edges",
                                  "outside"])
@pytest.mark.parametrize("table", sorted(GRID_TABLES))
def test_candidate_search_equals_exhaustive(table, kind):
    """The candidate search (host grid, per-sample search of its cell's
    list) equals qpsk256_reference, the exhaustive float32 search, bit for
    bit: on noisy symbols, every pair's midpoint (exact ties), points on
    and one ulp off the cells' edges and corners, and samples outside the
    box."""
    z = GRID_TABLES[table]()
    grid = tkq.candidate_grid(z.real, z.imag)
    assert grid.g == tkq.GRID
    x = _planar(_grid_inputs(kind, z, grid))
    cells = grid.cells(x.re, x.im)
    if kind == "outside":
        assert bool((cells < 0).all())
    else:   # the box's far edges and their neighbours lie outside
        assert float((cells >= 0).float().mean()) > 0.95
    table_t = _planar(z)
    want = tkq.qpsk256_reference(x, table_t)
    got = _grid_search(x, table_t, grid)
    assert torch.equal(got, want)


def _qpsk256_cu_constants():
    src = (Path(tkq.__file__).parent / "csrc" / "qpsk256.cu").read_text()
    return {name: int(v) for name, v in _re.findall(
        r"^constexpr int (\w+) = (\d+);", src, _re.M)}


@pytest.mark.parametrize("table", sorted(GRID_TABLES))
def test_candidate_grid_layout_matches_kernel_source(table):
    """The grid's constants are csrc/qpsk256.cu's; its blob is the offsets
    as uint16 then the uint8 lists, padded, within the kernel's shared
    memory; every list is non-empty and ascending."""
    k = _qpsk256_cu_constants()
    assert (k["kPoints"], k["kMaxGrid"], k["kMaxCandidates"],
            k["kBlobAlign"]) == (tkq.NUM_POINTS, tkq.MAX_GRID,
                                 tkq.MAX_CANDIDATES, tkq.BLOB_ALIGN)
    assert tkq.GRID <= k["kMaxGrid"]
    z = GRID_TABLES[table]()
    grid = tkq.candidate_grid(z.real, z.imag)
    cells = grid.g * grid.g
    blob = grid.blob
    assert blob.dtype == np.uint8 and blob.size % k["kBlobAlign"] == 0
    offsets = np.frombuffer(blob[:2 * (cells + 1)].tobytes(), "<u2")
    np.testing.assert_array_equal(offsets, grid.offsets)
    total = int(offsets[-1])
    assert total <= k["kMaxCandidates"]
    np.testing.assert_array_equal(blob[2 * (cells + 1):2 * (cells + 1) + total],
                                  grid.cand)
    # shared memory: the float4 table and the blob, under 48 KB
    assert 16 * k["kPoints"] + blob.size <= 48 * 1024
    for a, b in zip(offsets[:-1], offsets[1:]):
        lst = grid.cand[a:b]
        assert b > a and np.all(np.diff(lst.astype(int)) > 0)


def test_candidate_grid_degenerate_tables():
    """A table that defeats the grid: all points in one place halves G
    until the lists fit (and the search stays exhaustive-equal); a table
    that is not finite gets no grid, every sample searching all points."""
    z = np.full(256, 0.3 + 0.1j, np.complex64)
    z[17] = 0.3 + 0.1000001j
    grid = tkq.candidate_grid(z.real, z.imag)
    assert 0 < grid.g < tkq.GRID and grid.offsets[-1] <= tkq.MAX_CANDIDATES
    x = _planar(_grid_inputs("noisy", z, grid))
    assert torch.equal(_grid_search(x, _planar(z), grid),
                       tkq.qpsk256_reference(x, _planar(z)))
    z[3] = np.nan
    none = tkq.candidate_grid(z.real, z.imag)
    assert none.g == 0 and bool((none.cells(x.re, x.im) < 0).all())


def test_kernel_wrapper_out_dtype_on_cpu():
    """On CPU tensors the wrapper takes its plain version in the requested
    dtype, uncounted; the op passes uint8 through."""
    table = tq.qpsk256_constellation(jq.CIRCULAR, 1.0, planar=True)
    re, im = _noisy(jq.CIRCULAR, 1.0, 500, 0.03, 8)
    x = TCA(torch.from_numpy(re), torch.from_numpy(im))
    before = qpsk256_kernel.launches
    want = tkq.qpsk256_reference(x, table)
    for dt in (torch.uint8, torch.int32):
        got = qpsk256_kernel(x, table, out_dtype=dt)
        assert got.dtype == dt and torch.equal(got.long(), want.long())
    assert qpsk256_kernel.launches == before
