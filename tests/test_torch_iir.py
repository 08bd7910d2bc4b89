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


# ---------------------------------------------------------------------------
# Kernel B5's host side and plain version (gsdr_tpu_torch.kernels.iir)
# against gsdr_tpu.kernels.iir_pallas, and the SOS cascade
# ---------------------------------------------------------------------------

import re
from pathlib import Path

from gsdr_tpu.kernels import iir_pallas as jpal
from gsdr_tpu_torch.kernels import iir as tk


def _butter2(fc):
    c = 1.0 / np.tan(np.pi * fc)
    sq2 = np.sqrt(2.0)
    a0 = c * c + sq2 * c + 1.0
    return (np.array([1.0, 2.0, 1.0]) / a0,
            np.array([1.0, 2.0 * (1.0 - c * c) / a0, (c * c - sq2 * c + 1.0) / a0]))


def _deemph(tau=75e-6, fs=250e3):
    k = np.tan(1.0 / (2.0 * tau * fs))
    b0 = k / (1.0 + k)
    return np.array([b0, b0]), np.array([1.0, (k - 1.0) / (k + 1.0)])


# the filters of tests/test_iir_pallas.py, and an order-8 filter of four
# distinct complex pole pairs (the kernel's limit)
DIAG_FILTERS = {
    "first_order_deemph": _deemph(),
    "biquad_complex_poles": _butter2(0.1),
    "biquad_wide": _butter2(0.35),
    "real_poles": (np.array([1.0, 0.3, 0.02]), np.poly(np.array([0.5, -0.3]))),
    "fourth_order": (np.convolve(_butter2(0.08)[0], _butter2(0.22)[0]),
                     np.convolve(_butter2(0.08)[1], _butter2(0.22)[1])),
    "third_order": (np.convolve(_deemph()[0], _butter2(0.15)[0]),
                    np.convolve(_deemph()[1], _butter2(0.15)[1])),
    "eighth_order": (
        np.convolve(np.convolve(_butter2(0.06)[0], _butter2(0.14)[0]),
                    np.convolve(_butter2(0.24)[0], _butter2(0.36)[0])),
        np.convolve(np.convolve(_butter2(0.06)[1], _butter2(0.14)[1]),
                    np.convolve(_butter2(0.24)[1], _butter2(0.36)[1]))),
}
REJECTS = {
    "double_pole": (np.array([1.0, 0.0, 0.0]), np.poly([0.5, 0.5])),
    "order_9": (np.eye(1, 10)[0], np.poly(0.9 * np.exp(1j * np.linspace(0.1, 3.0, 9))).real),
    "order_0": (np.array([1.0]), np.array([1.0])),
}


@pytest.mark.parametrize("name", sorted(DIAG_FILTERS) + sorted(REJECTS))
def test_diagonalize_array_equal_to_jax(name):
    b, a = {**DIAG_FILTERS, **REJECTS}[name]
    want, got = jpal.diagonalize(b, a), tk.diagonalize(b, a)
    assert tk.iir_kernel_supported(b, a) == jpal.iir_pallas_supported(b, a)
    if name in REJECTS:
        assert want is None and got is None
        return
    assert got.m == want.m and got.b0 == want.b0
    for field in ("poles", "w", "q", "wgt", "qcols", "qinv_rows"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)))


def test_kernel_supported_matches_jax_on_bad_shapes():
    for b, a in (((1.0, 0.5), (1.0, 0.1, 0.2)), (np.ones((2, 2)), np.ones((2, 2))),
                 ("ab", "cd")):
        assert tk.iir_kernel_supported(b, a) == jpal.iir_pallas_supported(b, a)


@pytest.mark.parametrize("name,n,with_zi", [("fourth_order", 2048, True),
                                            ("third_order", 1000, False),
                                            ("biquad_complex_poles", 257, True)])
def test_diag_reference_matches_jax_interpret(name, n, with_zi):
    """The kernel's formulation in torch against JAX's Pallas kernel in
    interpret mode (2-4 s a call here, so three calls): y and the final
    state within 1e-5 of max|y|, float32 scans in other orders."""
    b, a = DIAG_FILTERS[name]
    m = len(b) - 1
    x = _x((n,), 20)
    zi = _x((m,), 21) if with_zi else None
    yj, zj = jpal.iir_pallas(b, a, x, zi=None if zi is None else jnp.asarray(zi),
                             block_n=256, interpret=True)
    yt, zt = tk.iir_diag_reference(tk.diagonalize(b, a), torch.from_numpy(x),
                                   None if zi is None else torch.from_numpy(zi))
    scale = np.max(np.abs(np.asarray(yj)))
    assert np.max(np.abs(yt.numpy() - np.asarray(yj))) <= 1e-5 * scale
    assert np.max(np.abs(zt.numpy() - np.asarray(zj))) <= 1e-5 * scale


@pytest.mark.parametrize("n", [1, 7, 255, 256, 257, 1000])
@pytest.mark.parametrize("name", sorted(DIAG_FILTERS))
def test_diag_reference_matches_exact_scan(name, n):
    """iir_diag_reference against the exact blocked scan (the function B5
    must equal) at the edge sizes of its 256-sample blocks, from a nonzero
    state: y and zf within 1e-5 of max|y|."""
    b, a = DIAG_FILTERS[name]
    b32, a32 = np.float32(b), np.float32(a)
    x = _x((n,), n)
    zi = _x((len(b) - 1,), n + 1)
    want, zw = tiir.iir_block(b32, a32, torch.from_numpy(x),
                              zi=torch.from_numpy(zi), impl="torch")
    filt = tk.iir_filter(b32, a32, "cpu")
    got, zg = tk.iir_diag_reference(filt.diag, torch.from_numpy(x),
                                    torch.from_numpy(zi))
    scale = float(want.abs().max()) + 1e-6
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert float((zg - zw).abs().max()) <= 1e-5 * scale


def _cu_constants():
    """The namespace-level constexpr ints of csrc/iir.cu, evaluated in
    order (C's integer division)."""
    src = (Path(tk.__file__).parent / "csrc" / "iir.cu").read_text()
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src,
                                 re.M):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


def _geometry_from_source():
    k = _cu_constants()
    return tk.Geometry(k["kSpan"], k["kThreads"], k["kWindow"], k["kCoefLen"])


def _table(d, g):
    return tk.coef_table(d, g.span, g.threads, g.window)


def test_coef_table_layout_matches_kernel_source():
    """kernels/iir.py writes the table at the offsets csrc/iir.cu reads,
    with every constant, thread power p^(kSpan j) and look-back multiplier
    p^(kTile e) formed in float64 and rounded once."""
    k = _cu_constants()
    g = _geometry_from_source()
    assert (k["kB0"], k["kPole"], k["kW"], k["kQ"], k["kQcol"], k["kQinv"],
            k["kPow"], k["kLookPow"]) == (
        tk._B0, tk._POLE, tk._W, tk._Q, tk._QCOL, tk._QINV, tk._POW,
        tk._look_pow(g.threads))
    assert (k["kMaxPairs"], k["kMaxOrder"]) == (tk.MAX_PAIRS, tk.MAX_ORDER)
    assert (g.tile, g.window + 1, g.threads + 1) == (
        k["kTile"], k["kLookLen"], k["kPowLen"])
    d = tk.diagonalize(*DIAG_FILTERS["eighth_order"])
    t = _table(d, g)
    assert t.dtype == np.float32 and t.size == k["kCoefLen"]
    plen, llen = k["kPowLen"], k["kLookLen"]
    for i, p in enumerate(d.poles):
        assert t[tk._POLE + 2 * i] == np.float32(p.real)
        assert t[tk._Q + 2 * i + 1] == np.float32(d.wgt[i] * d.q[i].imag)
        assert t[tk._QINV + 2 * (8 * i + 7) + 1] == \
            np.float32(d.qinv_rows[i][7].imag)
        for off, unit, count in ((tk._POW + 2 * plen * i, g.span, plen),
                                 (k["kLookPow"] + 2 * llen * i, g.tile,
                                  llen)):
            want = np.power(np.complex128(p), unit * np.arange(count))
            np.testing.assert_array_equal(t[off:off + 2 * count:2],
                                          want.real.astype(np.float32))
            np.testing.assert_array_equal(t[off + 1:off + 2 * count:2],
                                          want.imag.astype(np.float32))


def _cx(t, off):
    return np.complex64(complex(t[off], t[off + 1]))


def _chained_scan(diag, t, g, x, zi, window, seed):
    """A numpy transliteration of csrc/iir.cu's one launch, in complex64:
    tiles of span * threads samples taken in ticket order; per tile the
    threads' zero-state spans, the weighted warp scans (multipliers
    p^(span d) from the table), the warp prefixes and the aggregate; the
    look-back over ``window`` predecessors a step, each seen as published
    inclusive or as aggregate only at random (the row start s0 = Q^-1 zi
    is always inclusive), up to the horizon of ``look_back_horizon``,
    combined with the table's p^(tile e) and the window carry
    p^(tile window); at one or two poles the outputs from a zero tile
    start, then the start state's share added, at more a replay from the
    tile's start.
    Returns (y, zf) in float32."""
    rng = np.random.default_rng(seed)
    span, threads, n = g.span, g.threads, x.shape[0]
    tile = g.tile
    horizon = tk.look_back_horizon(tuple(abs(p) for p in diag.poles), tile)
    ntiles = -(-n // tile)
    plen, llen = threads + 1, g.window + 1
    look_off = tk._look_pow(threads)
    xs = np.zeros(ntiles * tile, np.float32)
    xs[:n] = x
    xs = xs.reshape(ntiles, threads // 32, 32, span)
    z = np.zeros(diag.m, np.float32) if zi is None else zi
    b0 = np.float32(t[tk._B0])
    y = b0 * xs
    s_end = []
    for k in range(len(diag.poles)):
        pw = [_cx(t, tk._POW + 2 * (plen * k + j)) for j in range(plen)]
        lp = [_cx(t, look_off + 2 * (llen * k + j)) for j in range(llen)]
        p, w = _cx(t, tk._POLE + 2 * k), _cx(t, tk._W + 2 * k)
        qw = _cx(t, tk._Q + 2 * k)
        u = np.zeros(xs.shape[:3], np.complex64)
        for j in range(span):
            u = p * u + w * xs[..., j]
        d = 1
        while d < 32:
            o = u.copy()
            o[..., d:] = pw[d] * u[..., :-d] + u[..., d:]
            u, d = o, 2 * d
        wexc = np.zeros(u.shape[:2], np.complex64)
        acc = np.zeros(ntiles, np.complex64)
        for q in range(u.shape[1]):
            wexc[:, q] = acc
            acc = pw[32] * acc + u[:, q, 31]
        agg = acc
        s0 = np.complex64(sum(np.complex64(_cx(
            t, tk._QINV + 2 * (tk.MAX_ORDER * k + j))) * np.float32(z[j])
            for j in range(diag.m)))
        incl = np.zeros(ntiles, np.complex64)
        start = np.zeros(ntiles, np.complex64)
        for i in range(ntiles):          # ticket order
            excl, mult, look = np.complex64(0), np.complex64(1), i
            while True:
                total, found = np.complex64(0), False
                for e in range(window):
                    idx = look - 1 - e
                    if idx < -1 or i - 1 - idx >= horizon:
                        val, found = 0, True         # left out
                    elif idx == -1:
                        val, found = s0, True
                    elif rng.random() < 0.3:
                        val, found = incl[idx], True
                    else:
                        val, found = agg[idx], i - 1 - idx == horizon - 1
                    total = lp[e] * val + total
                    if found:
                        break
                excl = mult * total + excl
                if found:
                    break
                mult = mult * lp[window]
                look -= window
            start[i] = excl
            incl[i] = lp[1] * excl + agg[i]
        # each thread's zero-start state: the warp's prefix and its lanes;
        # at one or two poles y from a zero tile start, then the start
        # state's share Re(q p^t start); at more, a replay from the start
        lane = np.arange(32)
        before_end = np.asarray(pw)[lane + 1][None, None, :] * wexc[..., None] + u
        s = np.concatenate([wexc[..., None], before_end[..., :-1]], -1)
        tid = np.arange(threads).reshape(threads // 32, 32)
        c = np.asarray(pw)[tid][None] * start[:, None, None]
        split = len(diag.poles) <= 2
        if not split:
            s = c + s
        ys = []
        for j in range(span):
            y[..., j] = (y[..., j] + (qw * s).real).astype(np.float32)
            s = p * s + w * xs[..., j]
            ys.append(s)
        for j in range(span if split else 0):
            y[..., j] = (y[..., j] + (qw * c).real).astype(np.float32)
            c = p * c
            ys[j] = ys[j] + c
        s_end.append(np.stack(ys, -1).reshape(-1)[n - 1])
    zf = np.zeros(diag.m, np.float32)
    for i in range(diag.m):
        for k in range(len(diag.poles)):
            zf[i] += (_cx(t, tk._QCOL + 2 * (tk.MAX_ORDER * k + i))
                      * s_end[k]).real
    return y.reshape(-1)[:n], zf


# filters whose state outlives many tiles (|p|^1024 of 0.95 and 0.60), so
# the look-back's multipliers p^(tile e) and its window carry weigh in the
# output; the other filters forget a tile within float32's precision. (A
# narrower resonator, r = 0.9999 at 0.01 rad, leaves the exact blocked
# scan itself 0.18 of max|y| from scipy's float64 lfilter, where the
# diagonal form stays within 3e-7.)
_R = 0.9995
LONG_MEMORY = {
    "slow_real": ((5e-5, 0.0), (1.0, -0.99995)),
    "slow_resonator": ((1e-3, 0.0, 0.0), (1.0, -2 * _R * np.cos(1.0), _R * _R)),
}


def _check_chained(name, n, window):
    g = _geometry_from_source()
    b, a = (np.float32(v) for v in {**DIAG_FILTERS, **LONG_MEMORY}[name])
    d = tk.diagonalize(b, a)
    x = _x((n,), n + window)
    zi = _x((d.m,), n + 3)
    y, zf = _chained_scan(d, _table(d, g), g, x, zi, window, seed=n)
    want, zw = tiir.iir_block(b, a, torch.from_numpy(x),
                              zi=torch.from_numpy(zi), impl="torch")
    yr, zr = tk.iir_diag_reference(d, torch.from_numpy(x),
                                   torch.from_numpy(zi))
    scale = float(want.abs().max()) + 1e-6
    for ref_y, ref_z in ((want, zw), (yr, zr)):
        assert np.max(np.abs(y - ref_y.numpy())) <= 1e-5 * scale
        assert np.max(np.abs(zf - ref_z.numpy())) <= 1e-5 * scale


@pytest.mark.parametrize("tiles", ["1", "tile-1", "tile", "tile+1", "40"])
@pytest.mark.parametrize("name", sorted(DIAG_FILTERS) + sorted(LONG_MEMORY))
def test_chained_scan_transliteration_matches_plain(name, tiles):
    """The one-launch chained scan, transliterated, at the least tile
    (csrc/iir.cu's geometry, look-back window as the kernel's) against the
    exact scan and iir_diag_reference from a nonzero state: y and zf within
    1e-5 of max|y|, at n = 1, a tile - 1, a tile, a tile + 1 and 40
    tiles."""
    g = _geometry_from_source()
    n = {"1": 1, "tile-1": g.tile - 1, "tile": g.tile, "tile+1": g.tile + 1,
         "40": 40 * g.tile}[tiles]
    _check_chained(name, n, g.window)


@pytest.mark.parametrize("tiles", [9, 23, 70])
@pytest.mark.parametrize("name", ["eighth_order", "slow_real",
                                  "slow_resonator"])
def test_chained_scan_crosses_look_back_windows(name, tiles):
    """The transliteration with a look-back step of 4 tiles: most
    look-backs cross several windows, each carried by the table's
    p^(tile window); at 70 tiles the resonator's end at their horizon of
    65 tiles, the order-8 filter's always at 1."""
    g = _geometry_from_source()
    _check_chained(name, tiles * g.tile - 5, 4)


def _header_calls(period, slots, grids, refresh="all"):
    """csrc/iir.cu's scratch header over calls of ``grids`` (each a call's
    (tiles, poles)), transliterated at an epoch period of ``period``: each
    call's epoch is its head's index h + 1; its blocks write both states
    of every slot they own, as far as their poles; the block of the last
    ticket sets the next index and refreshes slot h mod ``slots``: every
    word outside the grid, the words past the poles inside it
    (``refresh`` 'all'), outside the grid only ('outside'), or none.
    Returns the first call (index, its epoch) that could read a word of
    its own epoch that it has not written, or None."""
    words = 2 * tk.MAX_PAIRS
    stamp = np.zeros((2, slots, words), np.int64)    # agg, incl; 0: zeroed
    index = 0
    for c, (grid, poles) in enumerate(grids):
        epoch = index + 1
        assert 1 <= epoch <= period
        if np.any(stamp[:, :grid, :2 * poles] == epoch):
            return c, epoch
        stamp[:, :grid, :2 * poles] = epoch
        cur = index % slots
        if refresh != "none" and cur >= grid:
            stamp[:, cur, :] = epoch
        elif refresh == "all":
            stamp[:, cur, 2 * poles:] = epoch
        index = (index + 1) % period
    return None


def test_scratch_header_never_serves_a_stale_epoch():
    """The device-side call counter of B5 (csrc/iir.cu's header, the
    machinery of csrc/lookback.cuh): with 2 * slots - 1 under the epoch
    period (the launch refuses more than 0x7fffffff slots, the period is
    2^32 - 1), no call can take a word
    stamped with its epoch by an earlier call, for random calls, across
    the index's wrap, and for the worst patterns (a call over every slot
    at four poles, then calls of one tile, or of one pole, until its
    epoch comes round, then a call over every slot at four poles again).
    Without the refresh, or with slots refreshed only outside the grid,
    those patterns do serve one: the check has teeth."""
    csrc = Path(tk.__file__).parent / "csrc"
    src = (csrc / "iir.cu").read_text()
    period = int(re.search(r"kStampPeriod = (0x[0-9a-f]+)ull",
                           (csrc / "lookback.cuh").read_text()).group(1), 16)
    assert period == (1 << 32) - 1
    assert "slots > 0x7fffffffL" in src and 2 * 0x7fffffff - 1 < period
    period, slots = 13, 6
    rng = np.random.default_rng(0)
    grids = [(int(rng.integers(1, slots + 1)), int(rng.integers(1, 5)))
             for _ in range(5000)]
    assert _header_calls(period, slots, grids) is None
    # the epoch of call 0 comes back at call `period`
    worst = [(slots, 4)] + [(1, 1)] * (period - 1) + [(slots, 4)]
    assert _header_calls(period, slots, worst) is None
    assert _header_calls(period, slots, worst, refresh="none") == (period, 1)
    wide = [(slots, 4)] + [(slots, 1)] * (period - 1) + [(slots, 4)]
    assert _header_calls(period, slots, wide) is None
    assert _header_calls(period, slots, wide, refresh="outside") == \
        (period, 1)


def test_routing_on_cpu():
    """'auto' on the CPU is the plain scan, bit for bit; 'cuda' raises off
    the card; the wrapper takes its plain version for CPU tensors and
    counts no launch."""
    b, a = (0.0675, 0.135, 0.0675), (1.0, -1.143, 0.413)
    x = torch.from_numpy(_x((3000,), 30))
    y_auto, z_auto = tiir.iir_block(b, a, x)
    y_plain, z_plain = tiir.iir_block(b, a, x, impl="torch")
    assert torch.equal(y_auto, y_plain) and torch.equal(z_auto, z_plain)
    assert torch.equal(tiir.iir(b, a, x), y_plain)
    with pytest.raises(ValueError, match="CUDA"):
        tiir.iir_block(b, a, x, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        tiir.iir_block(b, a, x, impl="pallas")
    assert tiir._concrete(b) and tiir._concrete(np.asarray(a))
    assert tiir._concrete(torch.tensor(b))
    assert not tiir._concrete(torch.empty(3, device="meta"))
    filt = tk.iir_filter(b, a, "cpu")
    assert filt.table is None and tk.iir_filter(b, a, "cpu") is filt
    assert tk.iir_filter((1.0, 0.0, 0.0), (1.0, -1.0, 0.25), "cpu") is None
    before = tk.iir_kernel.launches
    y_k, z_k = tk.iir_kernel(x, filt, z_plain)
    yr, zr = tk.iir_diag_reference(filt.diag, x, z_plain)
    assert torch.equal(y_k, yr) and torch.equal(z_k, zr)
    xp = TCA(x, torch.flip(x, [0]))
    yp, zp = tk.iir_kernel(xp, filt, None)
    assert torch.equal(yp.re, tk.iir_diag_reference(filt.diag, x)[0])
    assert isinstance(zp, TCA) and tuple(zp.im.shape) == (2,)
    assert tk.iir_kernel.launches == before


def test_diag_state_hands_off_to_exact_scan():
    """The kernel formulation's final state continues the exact scan (and
    back): three segments equal one pass within 1e-5 of max|y|."""
    b, a = np.float32(DIAG_FILTERS["fourth_order"][0]), \
        np.float32(DIAG_FILTERS["fourth_order"][1])
    x = _x((3000,), 31)
    d = tk.diagonalize(b, a)
    y1, z1 = tk.iir_diag_reference(d, torch.from_numpy(x[:1000]))
    y2, z2 = tiir.iir_block(b, a, torch.from_numpy(x[1000:2000]), zi=z1)
    y3, _ = tk.iir_diag_reference(d, torch.from_numpy(x[2000:]), z2)
    whole, _ = tiir.iir_block(b, a, torch.from_numpy(x))
    got = torch.cat([y1, y2, y3])
    assert float((got - whole).abs().max()) <= 1e-5 * float(whole.abs().max())


SOS = ((0.02, 0.04, 0.02, 1.0, -1.56, 0.64),
       (1.0, 2.0, 1.0, 1.0, -1.2, 0.5),
       (1.0, -1.0, 0.0, 1.0, -0.3, 0.1))


@pytest.mark.parametrize("lead", [(), (3,)])
def test_iir_sos_matches_jax(lead):
    """iir_sos / iir_sos_block against JAX on real and planar signals, from
    a nonzero (S,) + batch + (2,) state: f32 scans in other orders."""
    x = _x(lead + (600,), 40)
    zi = _x((3,) + lead + (2,), 41)
    sos_j = jnp.asarray(SOS, jnp.float32)
    yj, zj = jiir.iir_sos_block(sos_j, jnp.asarray(x), zi=jnp.asarray(zi))
    yt, zt = tiir.iir_sos_block(SOS, torch.from_numpy(x), zi=torch.from_numpy(zi))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(tiir.iir_sos(np.asarray(SOS), torch.from_numpy(x)).numpy(),
                               np.asarray(jiir.iir_sos(sos_j, jnp.asarray(x))),
                               rtol=1e-5, atol=2e-5)
    im = _x(lead + (600,), 42)
    zim = _x((3,) + lead + (2,), 43)
    yj, zj = jiir.iir_sos_block(sos_j, JCA(jnp.asarray(x), jnp.asarray(im)),
                                zi=JCA(jnp.asarray(zi), jnp.asarray(zim)))
    yt, zt = tiir.iir_sos_block(torch.tensor(SOS), TCA(torch.from_numpy(x), torch.from_numpy(im)),
                                zi=TCA(torch.from_numpy(zi), torch.from_numpy(zim)))
    np.testing.assert_allclose(yt.im.numpy(), np.asarray(yj.im), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(zt.re.numpy(), np.asarray(zj.re), rtol=1e-5, atol=2e-5)
    assert tuple(zt.im.shape) == (3,) + lead + (2,)
    with pytest.raises(ValueError, match="sos"):
        tiir.iir_sos_block(((1.0, 0.0, 0.0),), torch.from_numpy(x))
