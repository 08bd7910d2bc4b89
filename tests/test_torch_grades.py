"""The dense front's grades (bf16x3, bf16x2, f32) in the port against the
JAX package's (JAX on CPU, its Pallas kernels in interpret mode).

The port's tensor-core kernels run on the card only; here their host side
(the bf16 split of the taps, the B-operand table) and the plain versions
that emulate each grade are held to the JAX package's definitions.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.kernels.channelize_pallas import mix_fir_decimate_bank_pallas
from gsdr_tpu.kernels.fm_chain_pallas import _split_g, fm_chain_pallas
from gsdr_tpu.pipelines import AmReceiver as JAm
from gsdr_tpu.pipelines import FmChannelizer as JFm
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels.chain import (
    GRADES,
    dense_mma_tables,
    front_supported,
    graded_bank_front,
    split_bf16,
)
from gsdr_tpu_torch.kernels.channelize import (
    channelize_kernel,
    channelize_reference,
)
from gsdr_tpu_torch.kernels.fm_chain import fm_chain, fm_chain_reference
from gsdr_tpu_torch.ops.channelize import (
    make_complex_tap_bank,
    mix_fir_decimate_bank,
)
from gsdr_tpu_torch.utils.convert import (
    am_receiver_from_fields,
    fm_channelizer_from_fields,
)

FS = 1_000_000.0
SKIP = 256  # zero-primed warm-up outputs
BF16 = ("bf16x3", "bf16x2")


def _lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def _bank(c, t):
    """A (2C, 2, T) bank of C channels off any uniform grid."""
    return make_complex_tap_bank(_lowpass(t, 0.05),
                                 [-(FS / (2 * c + 3)) * i for i in range(c)],
                                 FS)


def _flagship_bank():
    """The flagship's bank: 16 channels 60 kHz apart, 64 taps."""
    return make_complex_tap_bank(
        _lowpass(64, 0.03), [-480_000.0 + 60_000.0 * i for i in range(16)], FS)


def _planar(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _bf16_floats(t):
    return t.float().numpy()


def test_tap_split_equals_jax_split_g():
    """The port's split of the taps is array-equal to _split_g's high and
    low parts on the flagship bank, for both grades; the window's split
    equals _window_dot's (w - wh.astype(f32)).astype(bf16)."""
    bank = _flagship_bank()
    hi, lo = split_bf16(torch.from_numpy(bank))
    for grade in BF16:
        gh, gl, f32_dot = _split_g(bank, grade)
        assert f32_dot == grade
        np.testing.assert_array_equal(_bf16_floats(hi), gh.astype(np.float32))
        np.testing.assert_array_equal(_bf16_floats(lo), gl.astype(np.float32))
    w = np.concatenate(_planar(4096, 1)) * np.float32(3.7)
    wh = jnp.asarray(w).astype(jnp.bfloat16)
    wl = (jnp.asarray(w) - wh.astype(jnp.float32)).astype(jnp.bfloat16)
    th, tl = split_bf16(torch.from_numpy(w))
    np.testing.assert_array_equal(_bf16_floats(th),
                                  np.asarray(wh).astype(np.float32))
    np.testing.assert_array_equal(_bf16_floats(tl),
                                  np.asarray(wl).astype(np.float32))
    # the host split rounds to nearest even, as ml_dtypes does
    np.testing.assert_array_equal(
        _bf16_floats(th), w.astype(ml_dtypes.bfloat16).astype(np.float32))


def _halves(words):
    """int32 words -> (low, high) bf16 halves as float32."""
    u = words.numpy().astype(np.int64) & 0xFFFFFFFF
    lo = ((u & 0xFFFF) << 16).astype(np.uint32).view(np.float32)
    hi = (u & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return lo, hi


@pytest.mark.parametrize("c,t", [(16, 64), (5, 61), (20, 33), (32, 256),
                                 (1, 3)])
def test_dense_mma_tables_layout(c, t):
    """The tensor-core front's B operand, as fronts.cuh reads it: entry
    [part][kb][nt][4*cl + q][i] holds the bf16 (gr, -gi) pair of channel
    4*nt + cl at tap 8*kb + q + 4*i (plane 0 in the low half), part 0 the
    high and part 1 the low parts; zero past T and C."""
    bank = torch.from_numpy(_bank(c, t))
    table = dense_mma_tables(bank)
    kb, nt = -(-t // 8), -(-c // 4)
    assert table.dtype == torch.int32
    assert tuple(table.shape) == (2, kb, nt, 16, 2)
    want = np.zeros((2, 4 * nt, 8 * kb, 2), np.float32)
    for part, p in enumerate(split_bf16(bank[0::2])):
        want[part, :c, :t] = _bf16_floats(p).transpose(0, 2, 1)
    lo, hi = _halves(table)
    for part in range(2):
        for k in range(kb):
            for n in range(nt):
                for e in range(16):
                    cl, q = divmod(e, 4)
                    for i in range(2):
                        tap, ch = 8 * k + q + 4 * i, 4 * n + cl
                        assert lo[part, k, n, e, i] == want[part, ch, tap, 0]
                        assert hi[part, k, n, e, i] == want[part, ch, tap, 1]


def test_dense_mma_tables_cached_per_bank_tensor():
    """Built once per bank tensor, and rebuilt after the tensor is written
    in place."""
    bank = torch.from_numpy(_bank(4, 16))
    first = dense_mma_tables(bank)
    assert dense_mma_tables(bank) is first
    bank.mul_(2.0)
    second = dense_mma_tables(bank)
    assert second is not first
    assert torch.equal(_halves_sum(second), 2.0 * _halves_sum(first))


def _halves_sum(table):
    lo, hi = _halves(table)
    return torch.from_numpy(lo + hi)


# The front alone: the port's emulation sums float32 products that are
# exact (bf16 x bf16) in another order than the JAX kernel's dot, measured
# ~3e-7 of max|y|; the grade's own gap from f32 is ~5e-6 (bf16x3) and
# ~2e-3 (bf16x2) here. Held to 1e-6.
FRONT_TOL = 1e-6


@pytest.mark.parametrize("grade", BF16)
def test_channelize_reference_matches_jax_kernel_interpret(grade):
    """channelize_reference at a grade against the TPU kernel B4
    (mix_fir_decimate_bank_pallas) interpreted at the same grade: C=5
    (not a multiple of 4), T=61 (not a multiple of 8 or of D), D=4."""
    c, t, d = 5, 61, 4
    re, im = _planar(t + d * 700, 2)
    bank = _bank(c, t)
    want = mix_fir_decimate_bank_pallas(
        JCA(jnp.asarray(re), jnp.asarray(im)), bank, d, precision=grade,
        interpret=True).to_numpy()
    x = TCA(torch.from_numpy(re), torch.from_numpy(im))
    got = channelize_reference(x, torch.from_numpy(bank), d, grade).to_numpy()
    f32 = channelize_reference(x, torch.from_numpy(bank), d).to_numpy()
    assert got.shape == want.shape == (c, 700 + 1)
    scale = float(np.max(np.abs(want)))
    assert float(np.max(np.abs(got - want))) <= FRONT_TOL * scale
    # the comparison tells the grade from f32
    assert float(np.max(np.abs(f32 - want))) >= 4 * FRONT_TOL * scale


# The whole FM chain: beyond the front's summation order, the JAX kernel's
# discriminator is a polynomial atan2 (11th order, ~1e-6 rad; 7th order at
# bf16x2, ~8.2e-5 rad, fm_chain_pallas.py:1069-1073) where the plain chain
# takes libm's. Measured after the warm-up: 7.4e-6 (bf16x3) and 4.1e-5
# (bf16x2) of max|audio|; held to 2e-5 and 1e-4.
FM_TOL = {"bf16x3": 2e-5, "bf16x2": 1e-4}


@pytest.mark.parametrize("grade", BF16)
def test_fm_chain_reference_matches_jax_fused_interpret_at_grade(grade):
    """fm_chain_reference at a grade against the JAX fused kernel
    (fm_chain_pallas) interpreted at the same grade over two streamed
    steps, the carries exported each side; the first 256 outputs of the
    zero-primed first step left out, as in the f32 test."""
    n = 5000
    jm = JFm(sample_rate=FS, tuning_frequency=0.0,
             channel_frequencies=(100_000.0, -50_000.0, 37_000.0),
             frequency_deviation=75_000.0, decimation=4,
             low_pass_taps=_lowpass(32, 0.04), precision=grade)
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    assert tm.precision == grade
    rng = np.random.default_rng(3)
    tt = np.arange(n) / FS
    sig = np.zeros(n, np.complex128)
    for k, f in enumerate(jm._shifts()):
        msg = np.sin(2 * np.pi * (700.0 + 370.0 * k) * tt + rng.uniform(0, 6))
        sig += 0.3 * np.exp(1j * (2 * np.pi * f * tt + 0.35 * msg))
    re, im = sig.real.astype(np.float32), sig.imag.astype(np.float32)
    t, fs = jm.num_taps, int(FS)
    b, a = jm._deemph()
    jstate, tstate = jm.init(), tm.init()
    for step in range(2):
        n0, tail, cf, cz = jstate
        buf = JCA(jnp.concatenate([tail.re, jnp.asarray(re)]),
                  jnp.concatenate([tail.im, jnp.asarray(im)]))
        rot0 = (n0 + jnp.int32(fs - (t - 1) % fs)) % fs
        yj, cfj, czj = fm_chain_pallas(
            buf, jm._tap_bank(), jm._lo_table(), rot0, 4, jm.gain, b, a, cf,
            cz, shifts_hz=tuple(jm._shifts()), sample_rate=FS,
            precision=grade, interpret=True)
        tn0, ttail, tcf, tcz = tstate
        tbuf = TCA(torch.cat([ttail.re, torch.from_numpy(re)]),
                   torch.cat([ttail.im, torch.from_numpy(im)]))
        trot0 = torch.remainder(tn0 + (fs - (t - 1) % fs), fs).to(torch.int32)
        yt, cft, czt = fm_chain_reference(
            tbuf, tm.tap_bank, tm.lo_table, trot0, 4, tm.gain, tm.deemph, tcf,
            tcz, precision=grade)
        assert tuple(yt.shape) == yj.shape == (3, n // 4)
        skip = SKIP if step == 0 else 0
        yj_np = np.asarray(yj)[:, skip:]
        err = np.max(np.abs(yt.numpy()[:, skip:] - yj_np)) / np.max(np.abs(yj_np))
        assert err <= FM_TOL[grade]
        for got, want in ((cft.re, cfj.re), (cft.im, cfj.im), (czt, czj)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
        jstate = ((n0 + n % fs) % fs, buf[..., buf.shape[-1] - (t - 1):],
                  cfj, czj)
        tstate = (torch.remainder(tn0 + n % fs, fs).to(torch.int32),
                  tbuf[..., tbuf.shape[-1] - (t - 1):], cft, czt)


def test_graded_front_f32_and_grade_order():
    """'f32' is the plain strided conv bit for bit; bf16x3 lies closer to
    it than bf16x2; both lie within their grade's reach of it."""
    c, t, d = 16, 64, 4
    re, im = _planar(t + d * 600, 5)
    x = TCA(torch.from_numpy(re), torch.from_numpy(im))
    bank = torch.from_numpy(_flagship_bank())
    f32 = graded_bank_front(x, bank, d)
    want = mix_fir_decimate_bank(x, bank, d, impl="torch")
    assert torch.equal(f32.re, want.re) and torch.equal(f32.im, want.im)
    scale = float(f32.re.abs().max())
    gaps = {}
    for grade in BF16:
        y = graded_bank_front(x, bank, d, grade)
        gaps[grade] = float((y.re - f32.re).abs().max()) / scale
    assert gaps["bf16x3"] < 1e-4 and gaps["bf16x2"] < 1e-2
    assert 10 * gaps["bf16x3"] < gaps["bf16x2"]


def test_unknown_grade_raises_on_cpu():
    """A grade the port lacks raises, also where the plain version runs."""
    bank = torch.from_numpy(_bank(2, 8))
    x = TCA(*(torch.from_numpy(p) for p in _planar(64, 1)))
    assert tuple(GRADES) == ("f32", "bf16x2", "bf16x3")
    with pytest.raises(ValueError, match="precision must be"):
        channelize_kernel(x, bank, 4, precision="tf32")
    with pytest.raises(ValueError, match="precision must be"):
        channelize_reference(x, bank, 4, "bf16")
    with pytest.raises(ValueError, match="precision must be"):
        front_supported("fm_chain", torch.device("cpu"), 8, 4,
                        precision="fp8")
    assert front_supported("fm_chain", torch.device("cpu"), 8, 4,
                           precision="bf16x2")
    tm = fm_channelizer_from_fields(dataclasses.asdict(_fm_model("f32")),
                                    device="cpu")
    n0, _, cf, cz = tm.init()
    buf = TCA(torch.zeros(1024 + tm.num_taps - 1),
              torch.zeros(1024 + tm.num_taps - 1))
    with pytest.raises(ValueError, match="precision must be"):
        fm_chain(buf, tm.tap_bank, tm.lo_table, n0, 4, tm.gain, tm.deemph,
                 cf, cz, precision="bf16x4")


def _fm_model(precision, impl="auto"):
    return JFm(sample_rate=FS, tuning_frequency=100_000_000.0,
               channel_frequencies=tuple(100_000_000.0 - 60_000.0 * i
                                         for i in range(4)),
               frequency_deviation=75_000.0, decimation=4,
               low_pass_taps=_lowpass(33, 0.03), impl=impl,
               precision=precision)


def test_models_run_plain_f32_on_cpu_at_any_grade():
    """On the CPU the FM model runs its plain float32 chain whatever its
    grade, as the JAX model's XLA path does: every grade gives the same
    audio and state, equal to the JAX model's."""
    re, im = _planar(4096, 7)
    outs = []
    for grade in ("bf16x3", "bf16x2", "f32"):
        tm = fm_channelizer_from_fields(
            dataclasses.asdict(_fm_model(grade)), device="cpu")
        assert tm.precision == grade and tm.front == "toeplitz"
        _, y = tm.step(tm.init(), TCA(torch.from_numpy(re),
                                      torch.from_numpy(im)))
        outs.append(y)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("grade", ["bf16x3", "bf16x2", "f32"])
def test_convert_carries_the_fm_grade(grade):
    """A JAX FmChannelizer's grade carries across as it is (bf16x2 used to
    raise), and so does a JAX AmReceiver's (bf16x3 used to become f32 and
    bf16x2 to raise)."""
    tm = fm_channelizer_from_fields(dataclasses.asdict(_fm_model(grade)),
                                    device="cpu")
    assert tm.precision == grade
    am = JAm(sample_rate=FS, tuning_frequency=100_000_000.0,
             channel_frequencies=(100_000_000.0,), decimation=4,
             low_pass_taps=_lowpass(32, 0.04), precision=grade)
    assert am_receiver_from_fields(dataclasses.asdict(am),
                                   device="cpu").precision == grade
