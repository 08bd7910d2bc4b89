"""The CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU and nvcc; elsewhere every test here skips. Imports
only the port, so it runs on a machine without JAX:
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels.am_chain import (
    am_chain,
    am_chain_reference,
    pfb_am_chain,
    pfb_am_chain_reference,
)
from gsdr_tpu_torch.kernels.chain import front_supported
from gsdr_tpu_torch.kernels.channelize import (
    channelize_kernel,
    channelize_reference,
)
from gsdr_tpu_torch.kernels.fm_chain import (
    fm_chain,
    fm_chain_reference,
    pfb_fm_chain,
    pfb_fm_chain_reference,
)
from gsdr_tpu_torch.kernels.qpsk256 import qpsk256_kernel, qpsk256_reference
from gsdr_tpu_torch.ops.channelize import make_complex_tap_bank
from gsdr_tpu_torch.ops.pfb import _analysis_tables, _taps_key, pfb_channelize
from gsdr_tpu_torch.ops.qpsk256 import (
    CIRCULAR,
    RECTANGULAR,
    qpsk256_constellation,
    qpsk256_demodulate,
)
from gsdr_tpu_torch.pipelines import AmReceiver, FmChannelizer, Qpsk256Modem

FS = 1_000_000.0
SKIP = 256  # zero-primed warm-up outputs


def _model(impl, num_channels, num_taps, decimation, **kw):
    k = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * 0.03 * k) * np.hamming(num_taps)
    return FmChannelizer(
        sample_rate=FS, tuning_frequency=0.0,
        channel_frequencies=tuple(-480_000.0 + 60_000.0 * i
                                  for i in range(num_channels)),
        frequency_deviation=75_000.0, decimation=decimation,
        low_pass_taps=tuple(h / h.sum()), impl=impl, device="cuda", **kw)


def _fm_signal(freqs, n, seed):
    r = np.random.default_rng(seed)
    t = np.arange(n) / FS
    sig = np.zeros(n, np.complex128)
    for k, f in enumerate(freqs):
        msg = np.sin(2 * np.pi * (700.0 + 370.0 * k) * t + r.uniform(0, 6))
        sig += (0.5 / len(freqs)) * np.exp(1j * (2 * np.pi * f * t + 0.35 * msg))
    return (torch.from_numpy(sig.real.astype(np.float32)).cuda(),
            torch.from_numpy(sig.imag.astype(np.float32)).cuda())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("c,t,d", [(16, 64, 4), (5, 61, 4), (20, 33, 3)])
def test_kernel_matches_plain_version_on_card(card, c, t, d):
    """Two streamed blocks through the kernel and through the plain chain;
    covers C not a multiple of 16, more than one channel group, and
    T % D != 0. Audio within 1e-4 of max|audio| after the warm-up, carries
    within 1e-4."""
    kern, plain = _model("cuda", c, t, d), _model("torch", c, t, d)
    n = 3 * 21_000  # not a multiple of the kernel's tile
    re, im = _fm_signal(kern.channel_frequencies, 3 * n, seed=4)
    sk, sp = kern.init(), plain.init()
    before = fm_chain.launches
    for i in range(2):
        rf = TCA(re[i * n:(i + 1) * n], im[i * n:(i + 1) * n])
        sk, yk = kern.step(sk, rf)
        sp, yp = plain.step(sp, rf)
        skip = SKIP if i == 0 else 0
        err = (yk - yp)[:, skip:].abs().max() / yp[:, skip:].abs().max()
        assert float(err) <= 1e-4
        for a, b in ((sk[2].re, sp[2].re), (sk[2].im, sp[2].im), (sk[3], sp[3])):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    assert fm_chain.launches == before + 2
    # a state from the plain chain continues through the kernel
    rf = TCA(re[2 * n:], im[2 * n:])
    _, y_plain = plain.step(sp, rf)
    _, y_kern = kern.step(sp, rf)
    err = (y_kern - y_plain).abs().max() / y_plain.abs().max()
    assert float(err) <= 1e-4


@pytest.mark.cuda
def test_wrapper_rejects_bad_input_on_card(card):
    model = _model("cuda", 2, 8, 4)
    n0, tail, cf, cz = model.init()
    buf = TCA(torch.zeros(1031, device="cuda"), torch.zeros(1031, device="cuda"))
    args = [buf, model.tap_bank, model.lo_table, n0, 4, model.gain,
            model.deemph, cf, cz]
    audio, _, _ = fm_chain(*args)
    torch.cuda.synchronize()
    assert tuple(audio.shape) == (2, 256) and float(audio.abs().max()) == 0.0
    bad = list(args)
    bad[1] = model.tap_bank.double()
    with pytest.raises(ValueError, match="float64"):
        fm_chain(*bad)
    bad = list(args)
    bad[0] = TCA(buf.re[::2], buf.im[::2])
    with pytest.raises(ValueError, match="contiguous"):
        fm_chain(*bad)


def _grid_model(cls, impl, k, decimation, num_taps, num_channels, **kw):
    """Channels -(Fs/K)*i on the uniform grid, a num_taps prototype."""
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * (0.4 / k) * n) * np.hamming(num_taps)
    return cls(sample_rate=FS, tuning_frequency=0.0,
               channel_frequencies=tuple(-(FS / k) * i
                                         for i in range(num_channels)),
               decimation=decimation, low_pass_taps=tuple(h / h.sum()),
               impl=impl, device="cuda", **kw)


def _grid_fm_signal(freqs, n, seed):
    """FM carriers at 1 kHz deviation, tones 200 + 40*k Hz: narrow enough
    that each stays inside its Fs/K channel and clear of the atan2 branch
    cut at the lowest output rate tested (7.8 kHz)."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / FS
    sig = np.zeros(n, np.complex128)
    for k, f in enumerate(freqs):
        tone = 200.0 + 40.0 * k
        msg = np.sin(2 * np.pi * tone * t + r.uniform(0, 6))
        sig += (0.5 / len(freqs)) * np.exp(
            1j * (2 * np.pi * f * t + (1_000.0 / tone) * msg))
    return (torch.from_numpy(sig.real.astype(np.float32)).cuda(),
            torch.from_numpy(sig.imag.astype(np.float32)).cuda())


def _am_signal(freqs, n, seed):
    r = np.random.default_rng(seed)
    t = np.arange(n) / FS
    sig = np.zeros(n, np.complex128)
    for k, f in enumerate(freqs):
        env = 0.6 * (1.0 + 0.5 * np.sin(2 * np.pi * (500.0 + 31.0 * k) * t))
        sig += env * np.exp(1j * (2 * np.pi * f * t + r.uniform(0, 6)))
    return (torch.from_numpy(sig.real.astype(np.float32)).cuda(),
            torch.from_numpy(sig.imag.astype(np.float32)).cuda())


# (K, D, T, C): critical, P = 8 phases, a ragged fold with C < K and more
# than one channel group, D = 1, and a K = 128 grid over two bank slices
PFB_GEOMETRIES = [(64, 64, 512, 64), (64, 8, 512, 64), (20, 4, 157, 13),
                  (8, 1, 61, 8), (128, 128, 1021, 70)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,t,c", PFB_GEOMETRIES)
def test_pfb_fm_kernel_matches_plain_and_dense_on_card(card, k, d, t, c):
    """B2 against the plain PFB chain and against the dense kernel B1 over
    two streamed blocks: audio within 1e-4 of max|audio| after the
    warm-up, carries within 1e-4; a plain-chain state continues through
    the kernel. Where B1's taps and window exceed a block's shared memory
    (K=128, T=1021: 400 KB), B2 is held against the dense plain chain."""
    # the library's own check, static shared memory included
    assert front_supported("fm_chain", "cuda", t, d, k)
    kw = dict(frequency_deviation=75_000.0)
    kern = _grid_model(FmChannelizer, "pfb", k, d, t, c, precision="f32", **kw)
    plain = _grid_model(FmChannelizer, "pfb_torch", k, d, t, c, **kw)
    dense_fits = front_supported("fm_chain", "cuda", t, d)
    dense = _grid_model(FmChannelizer, "cuda" if dense_fits else "torch",
                        k, d, t, c, precision="f32", **kw)
    n = d * 3 * 1_000
    re, im = _grid_fm_signal(kern.channel_frequencies, 3 * n, seed=6)
    sk, sp, sd = kern.init(), plain.init(), dense.init()
    before = pfb_fm_chain.launches
    # the zero-primed first output reads +-pi in the plain chain and 0 in
    # the kernels; skip until the de-emphasis has shrunk that below 1e-6
    a = abs(float(kern.deemph[2]))
    skip = int(np.ceil(np.log(1e-6) / np.log(max(a, 1e-3)))) + t // d + 8
    for i in range(2):
        rf = TCA(re[i * n:(i + 1) * n], im[i * n:(i + 1) * n])
        sk, yk = kern.step(sk, rf)
        sp, yp = plain.step(sp, rf)
        sd, yd = dense.step(sd, rf)
        s0 = skip if i == 0 else 0
        for other, so in ((yp, sp), (yd, sd)):
            err = (yk - other)[:, s0:].abs().max() / other[:, s0:].abs().max()
            assert float(err) <= 1e-4
            for a, b in ((sk[2].re, so[2].re), (sk[2].im, so[2].im),
                         (sk[3], so[3])):
                torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    assert pfb_fm_chain.launches == before + 2
    rf = TCA(re[2 * n:], im[2 * n:])
    _, y_plain = plain.step(sp, rf)
    _, y_kern = kern.step(sp, rf)
    err = (y_kern - y_plain).abs().max() / y_plain.abs().max()
    assert float(err) <= 1e-4


@pytest.mark.cuda
def test_auto_routes_wideband_to_pfb_kernel_on_card(card):
    """'auto' at the default grade, bf16x3, takes B2 and B3-PFB on the
    wideband Fs/64 grid: one launch per step, nothing else."""
    model = _grid_model(FmChannelizer, "auto", 64, 64, 512, 64,
                        frequency_deviation=75_000.0)
    assert model.front == "pfb" and model.precision == "bf16x3"
    before = (fm_chain.launches, pfb_fm_chain.launches)
    re, im = _grid_fm_signal(model.channel_frequencies, 64 * 512, seed=2)
    model.step(model.init(), TCA(re, im))
    assert (fm_chain.launches, pfb_fm_chain.launches) == \
        (before[0], before[1] + 1)
    am = _grid_model(AmReceiver, "auto", 64, 64, 512, 64)
    assert am.front == "pfb" and am.precision == "bf16x3"
    before = (am_chain.launches, pfb_am_chain.launches)
    _, y = am.step(am.init(), TCA(re, im))
    assert bool(torch.isfinite(y).all())
    assert (am_chain.launches, pfb_am_chain.launches) == \
        (before[0], before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,t,c", PFB_GEOMETRIES)
def test_am_kernels_match_plain_on_card(card, k, d, t, c):
    """B3 on both fronts at f32 against the plain chains and each other,
    over two streamed blocks: envelopes within 1e-5."""
    dense_fits = front_supported("am_chain", "cuda", t, d)
    models = {impl: _grid_model(AmReceiver, impl, k, d, t, c,
                                precision="f32")
              for impl in ("pfb", "pfb_torch", "torch")}
    models["cuda"] = _grid_model(AmReceiver, "cuda" if dense_fits else "torch",
                                 k, d, t, c, precision="f32")
    n = d * 3 * 1_000
    re, im = _am_signal(models["pfb"].channel_frequencies, 2 * n, seed=8)
    states = {impl: m.init() for impl, m in models.items()}
    before = (am_chain.launches, pfb_am_chain.launches)
    for i in range(2):
        rf = TCA(re[i * n:(i + 1) * n], im[i * n:(i + 1) * n])
        out = {}
        for impl, m in models.items():
            states[impl], out[impl] = m.step(states[impl], rf)
        for a, b in (("pfb", "pfb_torch"), ("cuda", "torch"), ("pfb", "cuda")):
            torch.testing.assert_close(out[a], out[b], rtol=0, atol=1e-5)
    assert (am_chain.launches, pfb_am_chain.launches) == \
        (before[0] + 2 * dense_fits, before[1] + 2)


@pytest.mark.cuda
def test_shared_memory_check_on_card(card):
    """The libraries count the tile kernels' static shared memory: a grid
    whose dynamic size alone fits but whose total does not (K=712, D=89,
    Q=4: 230,400 + 2,304 B for the FM kernel) is refused before launch,
    and a dense front too long for a block makes the model raise at
    construction."""
    assert not front_supported("fm_chain", "cuda", 4 * 712, 89, 712)
    assert front_supported("fm_chain", "cuda", 512, 64, 64)
    with pytest.raises(ValueError, match="shared memory"):
        _grid_model(AmReceiver, "cuda", 128, 128, 1021, 70)


@pytest.mark.cuda
def test_am_dense_kernel_at_am_d_shape_on_card(card):
    """B3-dense at f32 at the 8-channel, T=32, D=4 shape, off any
    preferred grid, where 'auto' takes the dense front."""
    n_ = np.arange(32) - 15.5
    h = np.sinc(2 * 0.04 * n_) * np.hamming(32)
    kw = dict(sample_rate=FS, tuning_frequency=100_000_000.0,
              channel_frequencies=tuple(100_000_000.0 - 200_000.0 + 50_000.0 * i
                                        for i in range(8)),
              decimation=4, low_pass_taps=tuple(h / h.sum()), device="cuda")
    auto = AmReceiver(impl="auto", precision="f32", **kw)
    plain = AmReceiver(impl="torch", **kw)
    assert auto.front == "toeplitz"
    re, im = _am_signal([f - 100_000_000.0 for f in kw["channel_frequencies"]],
                        40_000, seed=1)
    before = am_chain.launches
    _, ya = auto.step(auto.init(), TCA(re, im))
    _, yp = plain.step(plain.init(), TCA(re, im))
    assert am_chain.launches == before + 1
    torch.testing.assert_close(ya, yp, rtol=0, atol=1e-5)


def _planar_cuda(shape, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return TCA(torch.randn(shape, generator=g, device="cuda"),
               torch.randn(shape, generator=g, device="cuda"))


def _bank(c, t, fs=1000.0):
    k = np.arange(t) - (t - 1) / 2.0
    h = np.sinc(2 * 0.05 * k) * np.hamming(t)
    shifts = [-(fs / (2 * c + 3)) * i for i in range(c)]
    return torch.from_numpy(make_complex_tap_bank(h / h.sum(), shifts,
                                                  fs)).cuda()


# (C, T, D): C below, at and above one 16-channel group, T not a multiple
# of D, and the transmux shape (K=32, Q=8)
CHANNELIZE_GEOMETRIES = [(8, 32, 8), (13, 61, 4), (16, 128, 16),
                         (32, 256, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,t,d", CHANNELIZE_GEOMETRIES)
def test_channelize_kernel_matches_plain_on_card(card, c, t, d):
    """B4 against its plain version (the full-float32 strided conv): f32
    sums of T products in other orders, within 1e-5 of max|y|. N is chosen
    so that M is not a multiple of the 256-output tile; the launch counts."""
    n = t + d * (5 * 256 + 37)
    x = _planar_cuda(n, seed=c)
    bank = _bank(c, t)
    before = channelize_kernel.launches
    y = channelize_kernel(x, bank, d)   # the default grade, bf16x3
    want = channelize_reference(x, bank, d, "bf16x3")
    torch.cuda.synchronize()
    assert channelize_kernel.launches == before + 1
    m = (n - t) // d + 1
    assert tuple(y.shape) == tuple(want.shape) == (c, m) and m % 256 != 0
    scale = float(torch.maximum(want.re.abs().max(), want.im.abs().max()))
    for a, b in ((y.re, want.re), (y.im, want.im)):
        assert float((a - b).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_channelize_refuses_a_block_too_large_on_card(card):
    """K=32 with Q=127 (T=4064): the taps alone need 520 KB of a block's
    shared memory. The library's check refuses it, and 'auto' and 'cuda'
    raise before any launch instead of taking the fold path."""
    k, q = 32, 127
    assert not front_supported("channelize", "cuda", k * q, k)
    assert front_supported("channelize", "cuda", k * 8, k)
    taps = np.hamming(k * q) / np.hamming(k * q).sum()
    x = _planar_cuda(k * (q + 64), seed=3)
    before = channelize_kernel.launches
    for impl in ("auto", "cuda"):
        with pytest.raises(ValueError, match="shared memory"):
            pfb_channelize(x, taps, k, impl=impl)
    assert channelize_kernel.launches == before
    assert pfb_channelize(x, taps, k, impl="torch").shape == (k, 65)


@pytest.mark.cuda
def test_pfb_channelize_auto_routes_to_kernel_on_card(card):
    """'auto' launches B4 once for a 1-D signal at K=32, at bf16x3 as the
    JAX package's kernel route: within 2e-5 of max|y| of the kernel's
    plain version at that grade on the route's bank, and within 3e-4 of
    the fold path (the grade, as tests/test_torch_pfb_banks.py holds JAX's
    kernel route); the f32 grade on the same bank within 2e-5 of the fold
    path. At K=64, or for a batch, it takes the fold path."""
    k = 32
    n = np.arange(8 * k) - (8 * k - 1) / 2.0
    taps = np.sinc(2 * (0.5 / k) * n) * np.hamming(8 * k)
    x = _planar_cuda(k * 2000, seed=4)
    before = channelize_kernel.launches
    y = pfb_channelize(x, taps, k)
    assert channelize_kernel.launches == before + 1
    fold = pfb_channelize(x, taps, k, impl="torch")
    bank = _analysis_tables(_taps_key(taps), k, x.device)[0]
    graded = channelize_reference(x, bank, k, "bf16x3")
    y32 = channelize_kernel(x, bank, k, precision="f32")
    scale = float(fold.re.abs().max())
    for a, b, tol in ((y.re, graded.re, 2e-5), (y.im, graded.im, 2e-5),
                      (y.re, fold.re, 3e-4), (y.im, fold.im, 3e-4),
                      (y32.re, fold.re, 2e-5), (y32.im, fold.im, 2e-5)):
        assert float((a - b).abs().max()) <= tol * scale
    before = channelize_kernel.launches
    pfb_channelize(x, np.ones(4 * 64) / 256, 64)
    pfb_channelize(TCA(x.re.reshape(2, -1), x.im.reshape(2, -1)), taps, k)
    assert channelize_kernel.launches == before


# ---------------------------------------------------------------------------
# The dense front's grades: B1 and B4 at bf16x3 and bf16x2 on the tensor
# cores, f32 on the FP32 FMAs
# ---------------------------------------------------------------------------

GRADES = ("bf16x3", "bf16x2", "f32")
# the grade against the f32 plain chain: FM audio (of max|audio|, after the
# warm-up; bf16x3 as the f32 kernel, bf16x2 at JAX's own gate for the
# grade, tests/test_kernels.py test_fast_precision_grade) and B4 (of
# max|y|)
FM_GRADE_GAP = {"bf16x3": 1e-4, "bf16x2": 2e-2, "f32": 1e-4}
B4_GRADE_GAP = {"bf16x3": 3e-5, "bf16x2": 1e-2, "f32": 1e-5}


def _graded_plain_steps(model, blocks, precision):
    """The model's stream through the plain chain at the kernel's grade
    (fm_chain_reference with the front emulating the grade)."""
    n0, tail, cf, cz = model.init()
    fs, t = int(round(model.sample_rate)), model.num_taps
    outs = []
    for rf in blocks:
        buf = TCA(torch.cat([tail.re, rf.re]), torch.cat([tail.im, rf.im]))
        rot0 = torch.remainder(n0 + (fs - (t - 1) % fs), fs).to(torch.int32)
        audio, cf, cz = fm_chain_reference(
            buf, model.tap_bank, model.lo_table, rot0, model.decimation,
            model.gain, model.deemph, cf, cz, precision=precision)
        outs.append(audio)
        tail = buf[..., buf.shape[-1] - (t - 1):]
        n0 = torch.remainder(n0 + rf.shape[-1] % fs, fs).to(torch.int32)
    return outs, (cf, cz)


@pytest.mark.cuda
@pytest.mark.parametrize("grade", GRADES)
@pytest.mark.parametrize("c,t,d", [(16, 64, 4), (5, 61, 4), (20, 33, 3)])
def test_fm_kernel_grades_match_plain_on_card(card, c, t, d, grade):
    """B1 at each grade, two streamed blocks through FmChannelizer(impl=
    'cuda', precision=grade): within 1e-4 of max|audio| of the plain chain
    at that grade after the warm-up, carries within 1e-4; and within the
    grade's gap of the f32 plain chain (FM_GRADE_GAP)."""
    kern = _model("cuda", c, t, d, precision=grade)
    plain = _model("torch", c, t, d)
    n = 3 * 21_000
    re, im = _fm_signal(kern.channel_frequencies, 2 * n, seed=6)
    blocks = [TCA(re[i * n:(i + 1) * n], im[i * n:(i + 1) * n])
              for i in range(2)]
    sk, sp = kern.init(), plain.init()
    before = fm_chain.launches
    graded, (gcf, gcz) = _graded_plain_steps(kern, blocks, grade)
    for i, rf in enumerate(blocks):
        sk, yk = kern.step(sk, rf)
        sp, yp = plain.step(sp, rf)
        skip = SKIP if i == 0 else 0
        for want, tol in ((graded[i], 1e-4), (yp, FM_GRADE_GAP[grade])):
            err = (yk - want)[:, skip:].abs().max() / want[:, skip:].abs().max()
            assert float(err) <= tol
    assert fm_chain.launches == before + 2
    for a, b in ((sk[2].re, gcf.re), (sk[2].im, gcf.im), (sk[3], gcz)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("grade", GRADES)
@pytest.mark.parametrize("c,t,d", CHANNELIZE_GEOMETRIES + [(20, 33, 3)])
def test_channelize_kernel_grades_match_plain_on_card(card, c, t, d, grade):
    """B4 at each grade against its plain version at that grade (within
    1e-5 of max|y|) and against the f32 plain version (B4_GRADE_GAP)."""
    n = t + d * (5 * 256 + 37)
    x = _planar_cuda(n, seed=c + 1)
    bank = _bank(c, t)
    y = channelize_kernel(x, bank, d, precision=grade)
    want = channelize_reference(x, bank, d, grade)
    exact = channelize_reference(x, bank, d)
    torch.cuda.synchronize()
    scale = float(torch.maximum(exact.re.abs().max(), exact.im.abs().max()))
    for ref, tol in ((want, 1e-5), (exact, B4_GRADE_GAP[grade])):
        for a, b in ((y.re, ref.re), (y.im, ref.im)):
            assert float((a - b).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_grades_fit_and_refuse_on_card(card):
    """Each library answers for each grade of its dense front: the
    flagship, the transmux, the FM wideband and the am_d shapes fit at
    every grade, T=1021 at D=128 fits at none (FmChannelizer and the
    wrappers raise before any launch); an unknown grade raises."""
    for grade in GRADES:
        for lib, t, d in (("fm_chain", 64, 4), ("fm_chain", 512, 64),
                          ("channelize", 256, 32), ("channelize", 128, 16)):
            assert front_supported(lib, "cuda", t, d, precision=grade)
        for lib in ("fm_chain", "channelize"):
            assert not front_supported(lib, "cuda", 1021, 128,
                                       precision=grade)
        with pytest.raises(ValueError, match="shared memory"):
            _model("cuda", 4, 1021, 128, precision=grade)
        x = _planar_cuda(1021 + 128 * 300, seed=2)
        before = channelize_kernel.launches
        with pytest.raises(ValueError, match="shared memory"):
            channelize_kernel(x, _bank(4, 1021), 128, precision=grade)
        assert channelize_kernel.launches == before
    for grade in GRADES:
        assert front_supported("am_chain", "cuda", 32, 4, precision=grade)
        assert not front_supported("am_chain", "cuda", 1021, 128,
                                   precision=grade)
    with pytest.raises(ValueError, match="precision must be"):
        front_supported("am_chain", "cuda", 32, 4, precision="fp8")
    x = _planar_cuda(4096, seed=5)
    with pytest.raises(ValueError, match="precision must be"):
        channelize_kernel(x, _bank(4, 32), 4, precision="tf32")
    model = _model("cuda", 2, 8, 4)
    n0, _, cf, cz = model.init()
    buf = TCA(torch.zeros(1031, device="cuda"), torch.zeros(1031, device="cuda"))
    before = fm_chain.launches
    with pytest.raises(ValueError, match="precision must be"):
        fm_chain(buf, model.tap_bank, model.lo_table, n0, 4, model.gain,
                 model.deemph, cf, cz, precision="bf16")
    assert fm_chain.launches == before


# (K, D, T, C) for the tensor-core PFB front: critical (P = 1, four phase
# chunks); P = 8 with Q*K > T and C = 40 (two 32-channel blocks, the second
# ragged); K not a multiple of 8; D = 20 > 16 (two chunks, the second of 4
# phases, 20 lanes); D = 1; the wideband examples' K = 32 critical shape
# (Q = 8). Every first block reads samples before 0 and every last
# tile samples past the buffer; M = 3000 per step fills no whole tile.
PFB_GRADE_GEOMETRIES = [(64, 64, 512, 64), (64, 8, 500, 40),
                        (20, 4, 157, 13), (100, 20, 190, 5), (8, 1, 61, 8),
                        (32, 32, 256, 32)]
# the grade against the f32 plain chain, AM envelopes (absolute): bf16x3
# at JAX's test_pfb_front_matches_xla gate, bf16x2 at its grade's 2e-2
AM_GRADE_GAP = {"bf16x3": 2e-3, "bf16x2": 2e-2}


def _graded_pfb_plain_steps(model, blocks, precision):
    """A PFB FM model's stream through pfb_fm_chain_reference at a grade."""
    n0, tail, cf, cz = model.init()
    fs, t = int(round(model.sample_rate)), model.num_taps
    outs = []
    for rf in blocks:
        buf = TCA(torch.cat([tail.re, rf.re]), torch.cat([tail.im, rf.im]))
        rot0 = torch.remainder(n0 + (fs - (t - 1) % fs), fs).to(torch.int32)
        audio, cf, cz = pfb_fm_chain_reference(
            buf, model.poly_taps, model.dft_bank, t, model.lo_table, rot0,
            model.decimation, model.gain, model.deemph, cf, cz,
            precision=precision)
        outs.append(audio)
        tail = buf[..., buf.shape[-1] - (t - 1):]
        n0 = torch.remainder(n0 + rf.shape[-1] % fs, fs).to(torch.int32)
    return outs, (cf, cz)


@pytest.mark.cuda
@pytest.mark.parametrize("grade", ["bf16x3", "bf16x2"])
@pytest.mark.parametrize("k,d,t,c", PFB_GRADE_GEOMETRIES)
def test_pfb_fm_kernel_grades_match_plain_on_card(card, k, d, t, c, grade):
    """B2 on the tensor cores, two streamed blocks through FmChannelizer(
    impl='pfb', precision=grade): within 1e-4 of max|audio| of the plain
    PFB chain at that grade after the warm-up, carries within 1e-4; and
    within the grade's gap of the f32 plain chain (FM_GRADE_GAP)."""
    kw = dict(frequency_deviation=75_000.0)
    kern = _grid_model(FmChannelizer, "pfb", k, d, t, c, precision=grade,
                       **kw)
    plain = _grid_model(FmChannelizer, "pfb_torch", k, d, t, c, **kw)
    n = d * 3 * 1_000
    re, im = _grid_fm_signal(kern.channel_frequencies, 2 * n, seed=6)
    blocks = [TCA(re[i * n:(i + 1) * n], im[i * n:(i + 1) * n])
              for i in range(2)]
    a = abs(float(kern.deemph[2]))
    skip = int(np.ceil(np.log(1e-6) / np.log(max(a, 1e-3)))) + t // d + 8
    graded, (gcf, gcz) = _graded_pfb_plain_steps(kern, blocks, grade)
    sk, sp = kern.init(), plain.init()
    before = pfb_fm_chain.launches
    for i, rf in enumerate(blocks):
        sk, yk = kern.step(sk, rf)
        sp, yp = plain.step(sp, rf)
        s0 = skip if i == 0 else 0
        for want, tol in ((graded[i], 1e-4), (yp, FM_GRADE_GAP[grade])):
            err = (yk - want)[:, s0:].abs().max() / want[:, s0:].abs().max()
            assert float(err) <= tol
    assert pfb_fm_chain.launches == before + 2
    for x, y in ((sk[2].re, gcf.re), (sk[2].im, gcf.im), (sk[3], gcz)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("grade", ["bf16x3", "bf16x2"])
@pytest.mark.parametrize("k,d,t,c", PFB_GRADE_GEOMETRIES)
def test_am_kernel_grades_match_plain_on_card(card, k, d, t, c, grade):
    """B3 on both fronts at a tensor-core grade, two streamed blocks: each
    within 1e-5 of its plain version at that grade, and within the grade's
    gap of the f32 plain chain (AM_GRADE_GAP); the dense front where its
    block fits at the grade."""
    kern = {"pfb": _grid_model(AmReceiver, "pfb", k, d, t, c,
                               precision=grade)}
    if front_supported("am_chain", "cuda", t, d, precision=grade):
        kern["cuda"] = _grid_model(AmReceiver, "cuda", k, d, t, c,
                                   precision=grade)
    plain = _grid_model(AmReceiver, "torch", k, d, t, c)
    n = d * 3 * 1_000
    re, im = _am_signal(plain.channel_frequencies, 2 * n, seed=8)
    before = (am_chain.launches, pfb_am_chain.launches)
    for impl, m in kern.items():
        sk, sp = m.init(), plain.init()
        for i in range(2):
            rf = TCA(re[i * n:(i + 1) * n], im[i * n:(i + 1) * n])
            n0, tail = sk
            buf = TCA(torch.cat([tail.re, rf.re]), torch.cat([tail.im, rf.im]))
            fs = int(FS)
            rot0 = torch.remainder(n0 + (fs - (t - 1) % fs), fs).to(
                torch.int32)
            if impl == "pfb":
                want = pfb_am_chain_reference(
                    buf, m.poly_taps, m.dft_bank, t, m.lo_table, rot0, d,
                    precision=grade)
            else:
                want = am_chain_reference(buf, m.tap_bank, m.lo_table, rot0,
                                          d, precision=grade)
            sk, yk = m.step(sk, rf)
            sp, yp = plain.step(sp, rf)
            torch.testing.assert_close(yk, want, rtol=0, atol=1e-5)
            assert float((yk - yp).abs().max()) <= AM_GRADE_GAP[grade]
    assert (am_chain.launches, pfb_am_chain.launches) == \
        (before[0] + 2 * ("cuda" in kern), before[1] + 2)


@pytest.mark.cuda
def test_pfb_grades_fit_and_refuse_on_card(card):
    """Both libraries answer for the PFB front at each grade: the wideband
    critical shape fits at every grade; K=640, D=64, T=1280 fits at f32
    (a 204-KB block) and at neither bf16 grade (its lane-ordered B table
    alone takes 160 KB): the models raise at construction, the wrappers
    on the ctypes path before any launch."""
    for lib in ("fm_chain", "am_chain"):
        for grade in GRADES:
            assert front_supported(lib, "cuda", 512, 64, 64, grade)
        assert front_supported(lib, "cuda", 1280, 64, 640, "f32")
        for grade in ("bf16x3", "bf16x2"):
            assert not front_supported(lib, "cuda", 1280, 64, 640, grade)
    kw = dict(frequency_deviation=75_000.0)
    for grade in ("bf16x3", "bf16x2"):
        with pytest.raises(ValueError, match="PFB kernel does not take"):
            _grid_model(FmChannelizer, "pfb", 640, 64, 1280, 8,
                        precision=grade, **kw)
        with pytest.raises(ValueError, match="PFB kernel does not take"):
            _grid_model(AmReceiver, "pfb", 640, 64, 1280, 8, precision=grade)
    m = _grid_model(FmChannelizer, "pfb", 640, 64, 1280, 8, precision="f32",
                    **kw)
    am = _grid_model(AmReceiver, "pfb", 640, 64, 1280, 8, precision="f32")
    n0, _, cf, cz = m.init()
    nb = 1280 - 1 + 64 * 300
    buf = TCA(torch.zeros(nb, device="cuda"), torch.zeros(nb, device="cuda"))
    before = (pfb_fm_chain.launches, pfb_am_chain.launches)
    for grade in ("bf16x3", "bf16x2"):
        with pytest.raises(ValueError, match="shared memory"):
            pfb_fm_chain(buf, m.poly_taps, m.dft_bank, 1280, m.lo_table, n0,
                         64, m.gain, m.deemph, cf, cz, precision=grade)
        with pytest.raises(ValueError, match="shared memory"):
            pfb_am_chain(buf, am.poly_taps, am.dft_bank, 1280, am.lo_table,
                         n0, 64, precision=grade)
    assert (pfb_fm_chain.launches, pfb_am_chain.launches) == before
    # the f32 grade of the same tables launches
    pfb_am_chain(buf, am.poly_taps, am.dft_bank, 1280, am.lo_table, n0, 64,
                 precision="f32")
    assert pfb_am_chain.launches == before[1] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("grade", ["bf16x3", "bf16x2"])
def test_channelize_block_follows_channels_on_card(card, grade):
    """At the bf16 grades B4 takes 16 channels per block up to C=16 and 32
    above, and its fits check answers for the block of the call: T=1024 at
    D=1 fits the 16-channel block only. C=16 launches and matches its plain
    version within 4e-5 of max|y|: float32 sums of 3*T products in other
    orders, whose error grows with T (1e-5 holds to T=256, and 1024 taps
    read 1.06e-5 at bf16x3 on the H100); C=17 is refused before any
    launch, and so is a check that names no C (any C)."""
    t, d = 1024, 1
    assert front_supported("channelize", "cuda", t, d, precision=grade,
                           num_channels=16)
    for c in (17, None):
        assert not front_supported("channelize", "cuda", t, d,
                                   precision=grade, num_channels=c)
    x = _planar_cuda(t + d * (2 * 256 + 37), seed=8)
    bank = _bank(16, t)
    y = channelize_kernel(x, bank, d, precision=grade)
    want = channelize_reference(x, bank, d, grade)
    scale = float(torch.maximum(want.re.abs().max(), want.im.abs().max()))
    for a, b in ((y.re, want.re), (y.im, want.im)):
        assert float((a - b).abs().max()) <= 4e-5 * scale
    before = channelize_kernel.launches
    with pytest.raises(ValueError, match="shared memory"):
        channelize_kernel(x, _bank(17, t), d, precision=grade)
    assert channelize_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("grade", GRADES)
def test_model_grade_routes_to_kernel_on_card(card, grade):
    """FmChannelizer(precision=grade) on the card: 'auto' takes the dense
    front at the flagship shape and launches B1 at that grade, one launch
    per step; the default grade is bf16x3."""
    assert _model("auto", 16, 64, 4).precision == "bf16x3"
    m = FmChannelizer(
        sample_rate=FS, tuning_frequency=0.0,
        channel_frequencies=tuple(-480_000.0 + 60_000.0 * i for i in range(16)),
        frequency_deviation=75_000.0, decimation=4,
        low_pass_taps=tuple(np.hamming(64) / np.hamming(64).sum()),
        precision=grade, device="cuda")
    assert m.front == "toeplitz" and m.precision == grade
    re, im = _fm_signal(m.channel_frequencies, 8192, seed=1)
    before = fm_chain.launches
    st = m.init()
    for i in range(2):
        st, y = m.step(st, TCA(re[i * 4096:(i + 1) * 4096],
                               im[i * 4096:(i + 1) * 4096]))
        assert bool(torch.isfinite(y).all())
    assert fm_chain.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("ctype", [RECTANGULAR, CIRCULAR])
def test_qpsk256_kernel_matches_plain_on_card(card, ctype):
    """B6 against its plain version: decisions bit-equal on noisy input
    with leading axes; on exact midpoints of point pairs the chosen
    point's distance equals the plain choice's within float32 rounding
    (rtol 2e-5, atol 2e-6), since the two round the cross term apart."""
    table = qpsk256_constellation(ctype, 2.0, planar=True, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(ctype)
    s = torch.randint(0, 256, (3, 40_001), generator=g, device="cuda")
    noise = 0.04 * torch.randn((2, 3, 40_001), generator=g, device="cuda")
    x = TCA(table.re[s] + noise[0], table.im[s] + noise[1])
    before = qpsk256_kernel.launches
    got = qpsk256_kernel(x, table)
    want = qpsk256_reference(x, table)
    torch.cuda.synchronize()
    assert qpsk256_kernel.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (3, 40_001)
    assert torch.equal(got, want)
    cn = torch.complex(table.re, table.im)
    i = torch.randint(0, 256, (4096,), generator=g, device="cuda")
    j = torch.randint(0, 256, (4096,), generator=g, device="cuda")
    mids = (cn[i] + cn[j]) / 2
    xm = TCA(mids.real.contiguous(), mids.imag.contiguous())
    dk = (mids - cn[qpsk256_kernel(xm, table).long()]).abs()
    dp = (mids - cn[qpsk256_reference(xm, table).long()]).abs()
    torch.testing.assert_close(dk, dp, rtol=2e-5, atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("ctype", [RECTANGULAR, CIRCULAR, "random"])
def test_qpsk256_kernel_dtypes_and_outside_box_on_card(card, ctype):
    """B6 writes uint8 or int32 itself, each equal to the plain version on
    noisy input and on samples outside the candidate grid's box (the
    exhaustive route), for the modem tables and a random one; exact
    midpoints pick an equally near point."""
    from gsdr_tpu_torch.kernels.qpsk256 import table_grid

    if ctype == "random":
        r = np.random.default_rng(3)
        z = torch.from_numpy((r.standard_normal(256)
                              + 1j * r.standard_normal(256)).astype(np.complex64))
        table = TCA(z.real.contiguous().cuda(), z.imag.contiguous().cuda())
    else:
        table = qpsk256_constellation(ctype, 1.0, planar=True, device="cuda")
    grid, _ = table_grid(table)
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    s = torch.randint(0, 256, (100_003,), generator=g, device="cuda")
    noise = 0.05 * torch.randn((2, 100_003), generator=g, device="cuda")
    far = 3.0 * torch.randn((2, 4099), generator=g, device="cuda")
    x = TCA(torch.cat([table.re[s] + noise[0], far[0]]),
            torch.cat([table.im[s] + noise[1], far[1]]))
    outside = grid.cells(x.re, x.im) < 0
    assert int(outside.sum()) > 1000 and bool(outside[:100_003].float().mean() < 0.01)
    want = qpsk256_reference(x, table)
    before = qpsk256_kernel.launches
    for dt in (torch.uint8, torch.int32):
        got = qpsk256_kernel(x, table, out_dtype=dt)
        torch.cuda.synchronize()
        assert got.dtype == dt and torch.equal(got.long(), want.long())
        assert torch.equal(qpsk256_demodulate(x, table, dt).long(), want.long())
    assert qpsk256_kernel.launches == before + 4
    cn = torch.complex(table.re, table.im)
    i = torch.randint(0, 256, (8192,), generator=g, device="cuda")
    j = torch.randint(0, 256, (8192,), generator=g, device="cuda")
    mids = (cn[i] + cn[j]) / 2
    xm = TCA(mids.real.contiguous(), mids.imag.contiguous())
    dk = (mids - cn[qpsk256_kernel(xm, table, out_dtype=torch.uint8).long()]).abs()
    dp = (mids - cn[qpsk256_reference(xm, table).long()]).abs()
    torch.testing.assert_close(dk, dp, rtol=2e-5, atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("ctype", [RECTANGULAR, CIRCULAR])
def test_qpsk256_modem_exact_tables_on_card(card, ctype):
    """All 256 symbols loop back exact through the table-exact modem, whose
    rx launches B6; uint8 by default, int32 on request."""
    modem = Qpsk256Modem(ctype, 1.5, exact_tables=True)
    s = torch.arange(256, device="cuda").repeat(4).reshape(2, 512)
    before = qpsk256_kernel.launches
    out = modem.rx(modem.tx(s))
    assert qpsk256_kernel.launches == before + 1
    assert out.dtype == torch.uint8 and torch.equal(out.long(), s)
    x = modem.tx(s)
    assert torch.equal(qpsk256_demodulate(x, modem.table, torch.int32).long(),
                       s)


@pytest.mark.cuda
def test_new_wrappers_reject_bad_input_on_card(card):
    x = _planar_cuda(4096, seed=5)
    bank = _bank(4, 32)
    table = qpsk256_constellation(CIRCULAR, planar=True, device="cuda")
    with pytest.raises(ValueError, match="float64"):
        channelize_kernel(x, bank.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        channelize_kernel(TCA(x.re[::2], x.im[::2]), bank, 4)
    with pytest.raises(ValueError, match="1-D"):
        channelize_kernel(TCA(x.re.reshape(2, -1), x.im.reshape(2, -1)),
                          bank, 4)
    with pytest.raises(ValueError, match="tap_bank shape"):
        channelize_kernel(x, bank[:, :1], 4)
    with pytest.raises(ValueError, match="float64"):
        qpsk256_kernel(TCA(x.re.double(), x.im.double()), table)
    with pytest.raises(ValueError, match="contiguous"):
        qpsk256_kernel(TCA(x.re[::2], x.im[::2]), table)
    with pytest.raises(ValueError, match="shape"):
        qpsk256_kernel(x, TCA(table.re[:128], table.im[:128]))
    # the op-level entry makes a strided input contiguous for the kernel
    strided = TCA(x.re[::2], x.im[::2])
    assert torch.equal(qpsk256_demodulate(strided, table, torch.int32),
                       qpsk256_reference(strided, table))


# ---------------------------------------------------------------------------
# B5: the pole-diagonalized IIR kernel
# ---------------------------------------------------------------------------

def _butter2(fc):
    c = 1.0 / np.tan(np.pi * fc)
    a0 = c * c + np.sqrt(2.0) * c + 1.0
    return (np.array([1.0, 2.0, 1.0]) / a0,
            np.array([1.0, 2.0 * (1.0 - c * c) / a0,
                      (c * c - np.sqrt(2.0) * c + 1.0) / a0]))


def _cascade(*fcs):
    b, a = np.array([1.0]), np.array([1.0])
    for fc in fcs:
        bb, aa = _butter2(fc)
        b, a = np.convolve(b, bb), np.convolve(a, aa)
    return b, a


IIR_FILTERS = {
    "bench_biquad": ((0.0675, 0.135, 0.0675), (1.0, -1.143, 0.413)),
    "parity_order4": ((0.05, 0.1, 0.12, 0.1, 0.05), (1.0, -1.2, 0.9, -0.33, 0.06)),
    "order8": _cascade(0.06, 0.14, 0.24, 0.36),
    "deemph": ((0.025955, 0.025955), (1.0, -0.94809)),
    "real_poles": ((1.0, 0.3, 0.02), tuple(np.poly([0.5, -0.3]))),
    "third_order": (np.convolve((0.025955, 0.025955), _butter2(0.15)[0]),
                    np.convolve((1.0, -0.94809), _butter2(0.15)[1])),
}
# filters whose state outlives many tiles, so the look-back's multipliers
# weigh in the output (tests/test_torch_iir.py's LONG_MEMORY)
LONG_MEMORY = {
    "slow_real": ((5e-5, 0.0), (1.0, -0.99995)),
    "slow_resonator": ((1e-3, 0.0, 0.0),
                       (1.0, -2 * 0.9995 * np.cos(1.0), 0.9995 ** 2)),
}
# row lengths: edges of the least tile, stream_fm's 2^18-sample blocks and
# bench_iir's 2^20
IIR_SIZES = ["1", "7", "tile-1", "tile", "tile+1", "2^18", "2^20"]


def _iir_plain(b, a, x, zi):
    from gsdr_tpu_torch.ops.iir import iir_block

    return iir_block(b, a, x, zi=zi, impl="torch")


def _iir_n(label):
    """A row length by label, the tile as csrc/iir.cu reports it."""
    from gsdr_tpu_torch.kernels.iir import _geometry

    tile = _geometry().tile
    return {"1": 1, "7": 7, "tile-1": tile - 1, "tile": tile,
            "tile+1": tile + 1, "2^18": 1 << 18, "2^20": 1 << 20}[label]


def _iir_check(b, a, x, zi, y, zf):
    """y and zf against the plain scan and scipy's float64 lfilter, within
    1e-5 of max|y| (float32 scans in other orders)."""
    import scipy.signal as ss

    yp, zp = _iir_plain(b, a, x, zi)
    y64, z64 = ss.lfilter(np.float64(b), np.float64(a), x.double().cpu().numpy(),
                          zi=zi.double().cpu().numpy())
    scale = float(yp.abs().max())
    assert float((y - yp).abs().max()) <= 1e-5 * scale
    assert float((zf - zp).abs().max()) <= 1e-5 * scale
    assert np.abs(y.double().cpu().numpy() - y64).max() <= 1e-5 * scale
    assert np.abs(zf.double().cpu().numpy() - z64).max() <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n", IIR_SIZES)
@pytest.mark.parametrize("name", sorted(IIR_FILTERS))
def test_iir_kernel_matches_plain_and_float64_on_card(card, name, n):
    """B5 from a nonzero state against the plain blocked scan and scipy's
    float64 lfilter: y and zf within 1e-5 of max|y| (float32 scans in
    other orders); one launch per call."""
    from gsdr_tpu_torch.ops.iir import iir_block
    from gsdr_tpu_torch.kernels.iir import iir_kernel

    n = _iir_n(n)
    b, a = (np.float32(v) for v in IIR_FILTERS[name])
    g = torch.Generator(device="cuda")
    g.manual_seed(n)
    x = torch.randn(n, generator=g, device="cuda")
    zi = torch.randn(len(b) - 1, generator=g, device="cuda")
    before = iir_kernel.launches
    y, zf = iir_block(b, a, x, zi=zi, impl="cuda")
    torch.cuda.synchronize()
    assert iir_kernel.launches == before + 1
    _iir_check(b, a, x, zi, y, zf)


@pytest.mark.cuda
@pytest.mark.parametrize("per_sm", [4, 8, 16])
@pytest.mark.parametrize("name", ["order8", "slow_real", "slow_resonator"])
def test_iir_look_back_crosses_windows_on_card(card, name, per_sm):
    """4, 8 and 16 tiles per SM plus one sample, so look-backs run past
    their first window (the filters whose state outlives many tiles; the
    resonator's end at their horizon of 65 tiles, order 8's at 1): y and
    zf as the plain scan and float64 lfilter."""
    from gsdr_tpu_torch.kernels.iir import _geometry, iir_filter, iir_kernel

    b, a = (np.float32(v) for v in {**IIR_FILTERS, **LONG_MEMORY}[name])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = per_sm * sms * _geometry().tile + 1
    assert -(-n // _geometry().tile) > 4 * _geometry().window
    g = torch.Generator(device="cuda")
    g.manual_seed(per_sm)
    x = torch.randn(n, generator=g, device="cuda")
    zi = torch.randn(len(b) - 1, generator=g, device="cuda")
    y, zf = iir_kernel(x, iir_filter(b, a, x.device), zi)
    _iir_check(b, a, x, zi, y, zf)


@pytest.mark.cuda
def test_iir_scratch_reused_without_reset_on_card(card):
    """Calls of every size and both row counts on one stream reuse one
    scratch, no reset between them (the flags carry the call's epoch):
    each call still matches the plain scan, and the scratch and its
    ticket count follow the calls."""
    from gsdr_tpu_torch.kernels import iir as tk

    b, a = (np.float32(v) for v in LONG_MEMORY["slow_real"])
    filt = tk.iir_filter(b, a, "cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    tk.iir_kernel(torch.randn(1 << 20, device="cuda"), filt, None)
    scr = tk._scratch[(0, stream)]
    buf, epoch, tickets = scr.buf, scr.epoch, scr.tickets
    expect = tickets
    for i, n in enumerate([1 << 18, 5000, 1 << 20, 1, (1 << 18) + 3] * 3):
        x = torch.randn(n, generator=g, device="cuda")
        zi = torch.randn(1, generator=g, device="cuda")
        if i % 2:
            xp = TCA(x, torch.flip(x, [0]).contiguous())
            y, zf = tk.iir_kernel(xp, filt, TCA(zi, -zi))
            _iir_check(b, a, x, zi, y.re, zf.re)
            _iir_check(b, a, xp.im, -zi, y.im, zf.im)
            rows = 2
        else:
            y, zf = tk.iir_kernel(x, filt, zi)
            _iir_check(b, a, x, zi, y, zf)
            rows = 1
        expect += rows * -(-n // tk._geometry().tile)
    assert tk._scratch[(0, stream)] is scr and scr.buf is buf
    assert scr.epoch == epoch + 15 and scr.tickets == expect


@pytest.mark.cuda
def test_iir_kernel_refuses_graph_capture_on_card(card):
    """B5's look-back counts calls on the host, so a captured call would
    replay a stale epoch: the wrapper raises inside a capture, and the
    stream's scratch goes on serving calls outside it."""
    from gsdr_tpu_torch.kernels.iir import iir_filter, iir_kernel

    b, a = IIR_FILTERS["bench_biquad"]
    filt = iir_filter(b, a, "cuda")
    x = torch.randn(1 << 18, device="cuda")
    iir_kernel(x, filt, None)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            iir_kernel(x, filt, None)
    zi = torch.randn(2, device="cuda")
    y, zf = iir_kernel(x, filt, zi)
    _iir_check(np.float32(b), np.float32(a), x, zi, y, zf)


@pytest.mark.cuda
@pytest.mark.parametrize("planar", [False, True])
def test_iir_kernel_is_one_grid_launch_on_card(card, planar):
    """torch.profiler counts one device kernel per B5 call, at stream_fm's
    2^18 and bench_iir's 2^20, one row and two: no reset launch."""
    from torch.profiler import ProfilerActivity, profile
    from gsdr_tpu_torch.kernels.iir import iir_filter, iir_kernel

    b, a = IIR_FILTERS["order8"]
    filt = iir_filter(b, a, "cuda")
    for n in (1 << 18, 1 << 20):
        x = torch.randn(n, device="cuda")
        x = TCA(x, x.flip(0).contiguous()) if planar else x
        iir_kernel(x, filt, None)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                iir_kernel(x, filt, None)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if str(e.device_type).endswith("CUDA")]
        assert len(kernels) == 5, [e.name for e in kernels]
        assert all("iir_chained" in e.name for e in kernels)


@pytest.mark.cuda
def test_iir_kernel_state_hands_off_with_plain_on_card(card):
    """kernel -> plain -> kernel over three segments equals one pass."""
    from gsdr_tpu_torch.ops.iir import iir_block

    b, a = IIR_FILTERS["parity_order4"]
    x = torch.randn(3 * 50_000 + 17, device="cuda")
    whole, zw = iir_block(b, a, x, impl="torch")
    y1, z1 = iir_block(b, a, x[:50_000], impl="cuda")
    y2, z2 = iir_block(b, a, x[50_000:100_000], zi=z1, impl="torch")
    y3, z3 = iir_block(b, a, x[100_000:], zi=z2, impl="cuda")
    scale = float(whole.abs().max())
    assert float((torch.cat([y1, y2, y3]) - whole).abs().max()) <= 1e-5 * scale
    assert float((z3 - zw).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_iir_kernel_planar_is_one_launch_on_card(card):
    from gsdr_tpu_torch.kernels.iir import iir_kernel
    from gsdr_tpu_torch.ops.iir import iir_block

    b, a = IIR_FILTERS["bench_biquad"]
    x = _planar_cuda(100_003, seed=9)
    zi = TCA(torch.randn(2, device="cuda"), torch.randn(2, device="cuda"))
    before = iir_kernel.launches
    y, zf = iir_block(b, a, x, zi=zi)
    torch.cuda.synchronize()
    assert iir_kernel.launches == before + 1
    yp, zp = iir_block(b, a, x, zi=zi, impl="torch")
    for got, want in ((y.re, yp.re), (y.im, yp.im), (zf.re, zp.re),
                      (zf.im, zp.im)):
        assert float((got - want).abs().max()) <= 1e-5 * float(yp.re.abs().max())


@pytest.mark.cuda
def test_iir_auto_routing_on_card(card):
    """'auto': a 1-D signal with host coefficients takes B5; a batched
    signal, coefficients on the card and a double pole take the plain
    scan; 'cuda' refuses the last three."""
    from gsdr_tpu_torch.kernels.iir import iir_kernel
    from gsdr_tpu_torch.ops.iir import iir_block

    b, a = IIR_FILTERS["bench_biquad"]
    x = torch.randn(5000, device="cuda")
    before = iir_kernel.launches
    iir_block(b, a, x)
    assert iir_kernel.launches == before + 1
    batched = x.reshape(2, 2500)
    y, _ = iir_block(b, a, batched)
    yp, _ = iir_block(b, a, batched, impl="torch")
    assert torch.equal(y, yp)
    bd, ad = torch.tensor(b, device="cuda"), torch.tensor(a, device="cuda")
    assert torch.equal(iir_block(bd, ad, x)[0], iir_block(b, a, x, impl="torch")[0])
    double = ((0.25, 0.5, 0.25), (1.0, -1.0, 0.25))
    assert torch.equal(iir_block(*double, x)[0],
                       iir_block(*double, x, impl="torch")[0])
    assert iir_kernel.launches == before + 1
    for args in ((b, a, batched), (bd, ad, x), (*double, x)):
        with pytest.raises(ValueError, match="impl='cuda'"):
            iir_block(*args, impl="cuda")


@pytest.mark.cuda
def test_iir_wrapper_rejects_bad_input_on_card(card):
    from gsdr_tpu_torch.kernels.iir import iir_filter, iir_kernel

    b, a = IIR_FILTERS["bench_biquad"]
    filt = iir_filter(b, a, "cuda")
    x = torch.randn(4096, device="cuda")
    with pytest.raises(ValueError, match="float64"):
        iir_kernel(x.double(), filt, None)
    with pytest.raises(ValueError, match="contiguous"):
        iir_kernel(x[::2], filt, None)
    with pytest.raises(ValueError, match="1-D"):
        iir_kernel(x.reshape(2, -1), filt, None)
    with pytest.raises(ValueError, match="shape"):
        iir_kernel(x, filt, torch.zeros(3, device="cuda"))
    with pytest.raises(ValueError, match="table"):
        iir_kernel(x, iir_filter(b, a, "cpu"), None)


@pytest.mark.cuda
def test_stream_fm_chain_launches_b5_on_card(card):
    """The streaming FM receiver takes B5 for both IIR stages (1 + 4
    launches a step) and matches the chain with plain IIR stages."""
    import math

    import scipy.signal as ss
    from gsdr_tpu_torch.kernels.iir import iir_kernel
    from gsdr_tpu_torch.pipelines import fm_deemphasis_coeffs
    from gsdr_tpu_torch.stream import (Chain, FirStream, IirStream,
                                       MixerStream, QuadFmStream, SosStream)

    rate = FS / 4
    b, a = fm_deemphasis_coeffs(75e-6, rate)
    sos = tuple(tuple(r) for r in ss.butter(8, 15e3, fs=rate, output="sos").tolist())
    h = np.sinc(2 * 0.03 * (np.arange(64) - 31.5)) * np.hamming(64)

    def chain(impl):
        return Chain((MixerStream(-100_000.0, FS),
                      FirStream(tuple((h / h.sum()).tolist()), 4),
                      QuadFmStream(rate / (2 * math.pi * 75_000.0)),
                      IirStream(b, a, impl=impl), SosStream(sos, impl=impl)))

    t = torch.arange(3 * 65536, dtype=torch.float64, device="cuda") / FS
    ph = 2 * np.pi * 100_000.0 * t + 10.0 * torch.sin(2 * np.pi * 1000.0 * t)
    rf = TCA(torch.cos(ph).float(), torch.sin(ph).float())
    blocks = [rf[i * 65536:(i + 1) * 65536] for i in range(3)]
    kern, plain = chain("auto"), chain("torch")
    sk, sp = kern.init(blocks[0]), plain.init(blocks[0])
    before = iir_kernel.launches
    outs_k, outs_p = [], []
    for blk in blocks:
        sk, yk = kern.step(sk, blk)
        sp, yp = plain.step(sp, blk)
        outs_k.append(yk)
        outs_p.append(yp)
    torch.cuda.synchronize()
    assert iir_kernel.launches == before + 15
    yk, yp = torch.cat(outs_k)[SKIP:], torch.cat(outs_p)[SKIP:]
    assert float((yk - yp).abs().max()) <= 1e-4 * float(yp.abs().max())
    assert float((sk[4] - sp[4]).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# The single-channel ops, the host runtime and fm_rx on the card
# ---------------------------------------------------------------------------

def _lowpass_np(num_taps, cutoff):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff * n) * np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


def _tone_signal(n, fc, dev=5_000.0, tone=1_000.0, am=False):
    t = torch.arange(n, dtype=torch.float64, device="cuda") / FS
    if am:
        env = 0.5 * (1.0 + 0.6 * torch.cos(2 * np.pi * tone * t))
        ph = 2 * np.pi * fc * t
    else:
        env = torch.ones_like(t)
        ph = 2 * np.pi * fc * t + (dev / tone) * torch.sin(2 * np.pi * tone * t)
    return TCA((env * torch.cos(ph)).float(), (env * torch.sin(ph)).float())


@pytest.mark.cuda
@pytest.mark.parametrize("grade", ["bf16x3", "bf16x2", "f32"])
def test_fm_demod_runs_b1_at_one_channel(card, grade):
    """fm_demod on the card is one B1 launch at C = 1 with the identity
    de-emphasis: within 1e-4 of max|audio| of the kernel's plain version at
    the grade, and of the composed chain within the digit-table phase bound
    (2e-2 of max|audio| at bf16x2), which a de-emphasis triple of
    (1, 1, 0) in place of (1, 0, 0) would break."""
    from gsdr_tpu_torch.kernels.fm_chain import deemphasis_triple
    from gsdr_tpu_torch.ops.fm import fm_chain_args, fm_demod, fm_demod_gain

    assert deemphasis_triple((1.0, 0.0), (1.0, 0.0)) == (1.0, 0.0, 0.0)
    taps, n0 = _lowpass_np(65, 0.02), 123_456_789
    x = _tone_signal(1 << 16, 100_000.0)
    before = fm_chain.launches
    y = fm_demod(x, taps, FS, 0.0, 100_000.0, 5_000.0, 4,
                 first_sample_index=n0, precision=grade)
    torch.cuda.synchronize()
    assert fm_chain.launches == before + 1
    gain = fm_demod_gain(FS, 5_000.0)
    args = fm_chain_args(x, taps, FS, -100_000.0, gain, 4, n0)
    plain = fm_chain_reference(*args, precision=grade)[0][0, 1:]
    assert tuple(y.shape) == tuple(plain.shape) == (((1 << 16) - 65) // 4,)
    scale = float(plain.abs().max())
    assert float((y - plain).abs().max()) <= 1e-4 * scale
    chain = fm_demod(x, taps, FS, 0.0, 100_000.0, 5_000.0, 4,
                     first_sample_index=n0, impl="torch")
    bound = (2e-2 * scale if grade == "bf16x2"
             else 1e-4 * scale + gain * 2 * np.pi * 2 * 6e-5)
    assert float((y - chain).abs().max()) <= bound
    a = y[256:].double().cpu().numpy()
    assert abs(a.std() - 4 / np.sqrt(2)) < 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("grade", ["bf16x3", "bf16x2", "f32"])
def test_am_demod_runs_b3_dense_at_one_channel(card, grade):
    """am_demod on the card is one B3-dense launch at C = 1, within 1e-5 of
    its plain version at the grade."""
    from gsdr_tpu_torch.ops.am import am_chain_args, am_demod

    taps = _lowpass_np(33, 0.05)
    x = _tone_signal(1 << 16, 100_000.0, am=True)
    before = am_chain.launches
    y = am_demod(x, taps, FS, 0.0, 100_000.0, 4, precision=grade)
    torch.cuda.synchronize()
    assert am_chain.launches == before + 1
    plain = am_chain_reference(*am_chain_args(x, taps, FS, -100_000.0, 4),
                               precision=grade)[0]
    assert tuple(y.shape) == tuple(plain.shape)
    assert float((y - plain).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_single_channel_ops_raise_where_the_block_does_not_fit(card):
    """fm_demod and am_demod under 'auto' on the card raise where the
    kernel's block does not fit (T=1021 at D=128, as
    test_grades_fit_and_refuse_on_card), before any launch, in place of
    running the composed chain."""
    from gsdr_tpu_torch.ops.am import am_demod
    from gsdr_tpu_torch.ops.fm import fm_demod

    taps = _lowpass_np(1021, 0.002)
    x = _tone_signal(1021 + 128 * 300, 100_000.0)
    before = (fm_chain.launches, am_chain.launches)
    for grade in GRADES:
        with pytest.raises(ValueError, match="shared memory"):
            fm_demod(x, taps, FS, 0.0, 100_000.0, 5_000.0, 128,
                     precision=grade)
        with pytest.raises(ValueError, match="shared memory"):
            am_demod(x, taps, FS, 0.0, 100_000.0, 128, precision=grade)
    assert (fm_chain.launches, am_chain.launches) == before


@pytest.mark.cuda
def test_native_host_library_on_card_machine(card, monkeypatch, tmp_path):
    """The host runtime's C++ builds there; a build that fails raises in
    place of a numpy fallback."""
    from gsdr_tpu_torch.kernels import _build
    from gsdr_tpu_torch.runtime import RingBuffer, host, native_available

    assert native_available() and RingBuffer(16).native
    (tmp_path / "gsdr_host.cc").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "HOST_SRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    host._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed to build"):
            RingBuffer(16)
    finally:
        monkeypatch.undo()
        host._library.cache_clear()
    assert native_available()


@pytest.mark.cuda
def test_fm_rx_on_card_resumes_bit_equal(card, tmp_path):
    """fm_rx on the card over a small int8 capture (2 stations, blocks of
    2^16): the halves run with --save-state and --load-state give the
    whole run's audio bit for bit, and each station's tone comes out."""
    from gsdr_tpu_torch.tools import fm_rx

    fs, n = 1_024_000.0, 1 << 19
    t = np.arange(n) / fs
    rf = (np.exp(1j * (2 * np.pi * 200e3 * t
                       + 15.0 * np.sin(2 * np.pi * 1000.0 * t)))
          + np.exp(1j * (-2 * np.pi * 300e3 * t
                         + 15.0 * np.sin(2 * np.pi * 1500.0 * t)))) * 0.4
    inter = np.empty(2 * n, np.float32)
    inter[0::2], inter[1::2] = rf.real, rf.imag
    raw = np.clip(np.round(inter * 127), -127, 127).astype(np.int8).tobytes()

    def run(data, name, *extra):
        (tmp_path / "in.iq").write_bytes(data)
        fm_rx.main([str(tmp_path / "in.iq"), "-o", str(tmp_path / name),
                    "--fs", str(fs), "--channels", "200e3,-300e3",
                    "--deviation", "15e3", "--block", "65536", *extra])
        return np.frombuffer((tmp_path / name).read_bytes(), np.float32)

    state = str(tmp_path / "st.npz")
    before = fm_chain.launches
    whole = run(raw, "w.f32")
    assert fm_chain.launches == before + 8
    first = run(raw[:len(raw) // 2], "a.f32", "--save-state", state)
    second = run(raw[len(raw) // 2:], "b.f32", "--load-state", state)
    np.testing.assert_array_equal(np.concatenate([first, second]), whole)
    audio = whole.reshape(-1, 2).T[:, 512:]
    rate = fs / 8
    for c, tone in enumerate((1000.0, 1500.0)):
        a = audio[c] - audio[c].mean()
        peak = np.argmax(np.abs(np.fft.rfft(a * np.hanning(len(a))))[5:]) + 5
        assert abs(peak * rate / len(a) - tone) < 10.0
