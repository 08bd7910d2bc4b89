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
    """The constexpr ints of csrc/iir.cu, evaluated in order."""
    src = (Path(tk.__file__).parent / "csrc" / "iir.cu").read_text()
    env = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        env[name] = eval(expr, {}, dict(env))
    return env


def test_coef_table_layout_matches_kernel_source():
    """kernels/iir.py writes the table at the offsets csrc/iir.cu reads,
    with every constant and power formed in float64 and rounded once."""
    k = _cu_constants()
    assert (k["kB0"], k["kPole"], k["kW"], k["kQ"], k["kQcol"], k["kQinv"],
            k["kPow"]) == (tk._B0, tk._POLE, tk._W, tk._Q, tk._QCOL,
                           tk._QINV, tk._POW)
    assert (k["kMaxPairs"], k["kMaxOrder"]) == (tk.MAX_PAIRS, tk.MAX_ORDER)
    d = tk.diagonalize(*DIAG_FILTERS["eighth_order"])
    t = tk.coef_table(d, k["kSpan"], k["kThreads"])
    assert t.dtype == np.float32 and t.size == k["kCoefLen"]
    plen = k["kPowLen"]
    for i, p in enumerate(d.poles):
        assert t[tk._POLE + 2 * i] == np.float32(p.real)
        assert t[tk._Q + 2 * i + 1] == np.float32(d.wgt[i] * d.q[i].imag)
        assert t[tk._QINV + 2 * (8 * i + 7) + 1] == \
            np.float32(d.qinv_rows[i][7].imag)
        for j in (0, 1, 32, k["kThreads"]):
            want = np.complex128(p) ** (k["kSpan"] * j)
            off = tk._POW + 2 * (plen * i + j)
            assert t[off] == np.float32(want.real)
            assert t[off + 1] == np.float32(want.imag)


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
