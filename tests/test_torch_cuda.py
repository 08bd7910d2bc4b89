"""The CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU and nvcc; elsewhere every test here skips. Imports
only the port, so it runs on a machine without JAX:
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import re
import subprocess

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
from gsdr_tpu_torch.kernels import _build
from gsdr_tpu_torch.kernels.chain import (
    dense_block,
    dense_chunk,
    front_supported,
    pfb_block,
    pfb_chunk,
)
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
from gsdr_tpu_torch.utils.tree import tree_flatten

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
    the kernel. Where B1's whole bank and window exceed a block's shared
    memory (K=128, T=1021: 400 KB), B1 stages its taps in chunks."""
    # the library's own check, static shared memory included
    assert front_supported("fm_chain", "cuda", t, d, k)
    kw = dict(frequency_deviation=75_000.0)
    kern = _grid_model(FmChannelizer, "pfb", k, d, t, c, precision="f32", **kw)
    plain = _grid_model(FmChannelizer, "pfb_torch", k, d, t, c, **kw)
    dense = _grid_model(FmChannelizer, "cuda", k, d, t, c, precision="f32",
                        **kw)
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
    over two streamed blocks: envelopes within 1e-5; the dense front at
    K=128, T=1021 in chunks."""
    models = {impl: _grid_model(AmReceiver, impl, k, d, t, c,
                                precision="f32")
              for impl in ("pfb", "pfb_torch", "torch", "cuda")}
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
        (before[0] + 2, before[1] + 2)


# The f32 PFB front's channel groups of 32: one partial group (C = 5),
# a second group of 1 and of 15 channels (C = 33, 47) where the grid has
# that many bins
F32_GROUP_CASES = [(k, d, t, c) for k, d, t, _ in PFB_GEOMETRIES
                   for c in (5, 33, 47) if c <= k]


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,t,c", F32_GROUP_CASES)
def test_pfb_f32_kernels_match_plain_over_channel_groups_on_card(card, k, d,
                                                                 t, c):
    """B2 and B3-PFB at f32 against the plain PFB chains over two streamed
    blocks of 2,777 outputs (a ragged last tile): FM audio within 1e-4 of
    max|audio| after the warm-up, carries within 1e-4; AM envelopes within
    1e-5; one launch a step."""
    kw = dict(frequency_deviation=75_000.0)
    fm = _grid_model(FmChannelizer, "pfb", k, d, t, c, precision="f32", **kw)
    fm_plain = _grid_model(FmChannelizer, "pfb_torch", k, d, t, c, **kw)
    am = _grid_model(AmReceiver, "pfb", k, d, t, c, precision="f32")
    am_plain = _grid_model(AmReceiver, "pfb_torch", k, d, t, c)
    n = d * 2_777
    re, im = _grid_fm_signal(fm.channel_frequencies, 2 * n, seed=6)
    are, aim = _am_signal(am.channel_frequencies, 2 * n, seed=8)
    a = abs(float(fm.deemph[2]))
    skip = int(np.ceil(np.log(1e-6) / np.log(max(a, 1e-3)))) + t // d + 8
    sk, sp, ak, ap = fm.init(), fm_plain.init(), am.init(), am_plain.init()
    before = (pfb_fm_chain.launches, pfb_am_chain.launches)
    for i in range(2):
        sl = slice(i * n, (i + 1) * n)
        sk, yk = fm.step(sk, TCA(re[sl], im[sl]))
        sp, yp = fm_plain.step(sp, TCA(re[sl], im[sl]))
        s0 = skip if i == 0 else 0
        err = (yk - yp)[:, s0:].abs().max() / yp[:, s0:].abs().max()
        assert float(err) <= 1e-4
        for x, y in ((sk[2].re, sp[2].re), (sk[2].im, sp[2].im),
                     (sk[3], sp[3])):
            torch.testing.assert_close(x, y, rtol=0, atol=1e-4)
        ak, ek = am.step(ak, TCA(are[sl], aim[sl]))
        ap, ep = am_plain.step(ap, TCA(are[sl], aim[sl]))
        torch.testing.assert_close(ek, ep, rtol=0, atol=1e-5)
    assert (pfb_fm_chain.launches, pfb_am_chain.launches) == \
        (before[0] + 2, before[1] + 2)


@pytest.mark.cuda
def test_shared_memory_check_on_card(card):
    """The libraries count the tile kernels' static shared memory: at
    K=288, D=24, Q=6 the FM kernel's one-chunk block at f32 (229,888 B
    dynamic, which alone fits, plus the 4,608 B of static memory of its
    two threads a row) does not fit, so its plan is the chunked kernel's,
    and a launch forced to the one-chunk plan is refused before launch
    (too many resources; no launch counted); the AM kernel's block, with
    no static memory, takes it in one chunk. K=712, D=89 runs at every
    grade in both libraries, within the grades' gates of the plain PFB
    chain (_witness_within). A dense front too long for one block does not
    make the model raise either: AmReceiver at K=128, T=1021, D=128 (70
    channels) takes the dense kernel in chunks of fewer than T taps, one
    launch a step, its envelopes within 4e-5 of its plain version at the
    grade: float32 sums of 3*T products in other orders, whose error grows
    with T (1e-5 holds to T=512; the H100 read 1.54e-5 here)."""
    assert front_supported("fm_chain", "cuda", 4 * 712, 89, 712)
    assert front_supported("fm_chain", "cuda", 6 * 288, 24, 288)
    assert pfb_chunk("fm_chain", "cuda", 288, 6, 24, "f32") != (288, 6)
    assert pfb_chunk("am_chain", "cuda", 288, 6, 24, "f32") == (288, 6)
    m = _witness_model(FmChannelizer, 288, 24, 1728, 8, "f32")
    args = _witness_args(m, 288 * 64)
    before = pfb_fm_chain.launches
    with pytest.raises(RuntimeError, match="too many resources"):
        pfb_fm_chain(*args, precision="f32", plan=(288, 6))
    assert pfb_fm_chain.launches == before
    for cls in (FmChannelizer, AmReceiver):
        _witness_within(cls, 288, 24, 1728, "f32")
    for grade in GRADES:
        for cls in (FmChannelizer, AmReceiver):
            _witness_within(cls, 712, 89, 2848, grade)
    m = _grid_model(AmReceiver, "cuda", 128, 128, 1021, 70)
    assert m.front == "toeplitz"
    assert 8 <= dense_chunk("am_chain", "cuda", 1021, 128, m.precision) < 1021
    n = 128 * 600
    re, im = _am_signal(m.channel_frequencies, n, seed=4)
    rf = TCA(re, im)
    before = am_chain.launches
    _, y = m.step(m.init(), rf)
    assert am_chain.launches == before + 1
    buf = TCA(torch.cat([torch.zeros(1020, device="cuda"), re]),
              torch.cat([torch.zeros(1020, device="cuda"), im]))
    fs = int(FS)
    rot0 = torch.tensor((fs - 1020 % fs) % fs, dtype=torch.int32,
                        device="cuda")
    want = am_chain_reference(buf, m.tap_bank, m.lo_table, rot0, 128,
                              precision=m.precision)
    torch.testing.assert_close(y, want, rtol=0, atol=4e-5)


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
def test_channelize_takes_k32_q127_through_b4_on_card(card):
    """K=32 with Q=127 (T=4064), whose taps alone would need 520 KB of a
    block's shared memory: B4 stages them in chunks, and 'auto' and 'cuda'
    each launch it once, at bf16x3, within 4e-5 of max|y| of its plain
    version at that grade on the route's bank (float32 sums of 3*T
    products in other orders, whose error grows with T, as
    test_channelize_block_follows_channels_on_card holds T=1024) and within
    3e-4 of the fold path (as test_pfb_channelize_auto_routes_to_kernel_
    on_card holds K=32, Q=8); T=256 still runs in one chunk."""
    k, q = 32, 127
    assert dense_chunk("channelize", "cuda", k * 8, k, "bf16x3", k) == k * 8
    assert 8 <= dense_chunk("channelize", "cuda", k * q, k, "bf16x3",
                            k) < k * q
    taps = np.hamming(k * q) / np.hamming(k * q).sum()
    x = _planar_cuda(k * (q + 64), seed=3)
    fold = pfb_channelize(x, taps, k, impl="torch")
    bank = _analysis_tables(_taps_key(taps), k, x.device)[0]
    plain = channelize_reference(x, bank, k, "bf16x3")
    scale = float(torch.maximum(fold.re.abs().max(), fold.im.abs().max()))
    for impl in ("auto", "cuda"):
        before = channelize_kernel.launches
        y = pfb_channelize(x, taps, k, impl=impl)
        torch.cuda.synchronize()
        assert channelize_kernel.launches == before + 1
        assert tuple(y.shape) == tuple(fold.shape) == (k, 65)
        for ref, tol in ((plain, 4e-5), (fold, 3e-4)):
            for a, b in ((y.re, ref.re), (y.im, ref.im)):
                assert float((a - b).abs().max()) <= tol * scale


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
    flagship, the transmux, the FM wideband and the am_d shapes fit one
    block at every grade (one chunk of all T taps); at f32 the FM
    wideband shape's 64 channels take blocks of 32, whose taps and window
    at T=512, D=64 (262 KB) do not, so it runs in chunks, while a block of
    16 channels still takes it in one; T=1021 at D=128, which does not
    fit, fits in chunks: FmChannelizer takes it, and B4 launches it within
    4e-5 of max|y| of its plain version at the grade (T=1021's longer
    sums, as test_channelize_block_follows_channels_on_card); an unknown
    grade raises."""
    for grade in GRADES:
        for lib, t, d in (("fm_chain", 64, 4), ("fm_chain", 512, 64),
                          ("channelize", 256, 32), ("channelize", 128, 16),
                          ("am_chain", 32, 4)):
            if grade == "f32" and (t, d) == (512, 64):
                assert dense_chunk(lib, "cuda", t, d, grade, 16) == t
                assert 8 <= dense_chunk(lib, "cuda", t, d, grade, 64) < t
                continue
            assert dense_chunk(lib, "cuda", t, d, grade) == t
        for lib in ("fm_chain", "channelize", "am_chain"):
            assert front_supported(lib, "cuda", 1021, 128, precision=grade)
            assert 8 <= dense_chunk(lib, "cuda", 1021, 128, grade) < 1021
        assert _model("cuda", 4, 1021, 128, precision=grade).front == \
            "toeplitz"
        x = _planar_cuda(1021 + 128 * 300, seed=2)
        bank = _bank(4, 1021)
        before = channelize_kernel.launches
        y = channelize_kernel(x, bank, 128, precision=grade)
        assert channelize_kernel.launches == before + 1
        want = channelize_reference(x, bank, 128, grade)
        scale = float(torch.maximum(want.re.abs().max(), want.im.abs().max()))
        for a, b in ((y.re, want.re), (y.im, want.im)):
            assert float((a - b).abs().max()) <= 4e-5 * scale
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


# The (D, T) grid over which the dense fronts take every point at every
# grade: the JAX package's fused_chain_supported takes all of it at 16
# channels but T = 8193 at D <= 16.
SWEEP_D = (1, 2, 4, 8, 16, 32, 50, 64, 100, 128, 192, 256, 512)
SWEEP_T = (33, 65, 129, 257, 513, 1025, 2049, 4097, 8193)


@pytest.mark.cuda
def test_dense_fronts_take_every_geometry_on_card(card):
    """front_supported holds for the dense front of fm_chain, am_chain and
    channelize at every grade over the D x T grid (channelize for any C,
    its widest block), each plan a chunk of T taps or a multiple of 8
    below T; FmChannelizer and AmReceiver under 'auto' and 'cuda' take
    every point, off any grid, with the dense front."""
    chans = tuple(100_000.0 + 37_000.0 * i for i in range(2))
    for grade in GRADES:
        for lib in ("fm_chain", "am_chain", "channelize"):
            for d in SWEEP_D:
                for t in SWEEP_T:
                    assert front_supported(lib, "cuda", t, d,
                                           precision=grade), (lib, grade, d, t)
                    tc = dense_chunk(lib, "cuda", t, d, grade)
                    assert tc == t or (8 <= tc < t and tc % 8 == 0)
        for d in SWEEP_D:
            for t in SWEEP_T:
                taps = tuple(np.full(t, 1.0 / t))
                for impl in ("auto", "cuda"):
                    # tau above 1/(pi * audio rate) down to D = 512
                    fm = FmChannelizer(FS, 0.0, chans, 75_000.0, d, taps,
                                       deemphasis_tau=1e-3, impl=impl,
                                       precision=grade, device="cuda")
                    am = AmReceiver(FS, 0.0, chans, d, taps, impl=impl,
                                    precision=grade, device="cuda")
                    assert fm.front == am.front == "toeplitz"


def _forced_chunks(run, chunks):
    """run(chunk) for the planner's chunk (None) and each forced one, every
    output bit-equal to the planner's; the launch counter restored."""
    outs = [run(None)] + [run(tc) for tc in chunks]
    torch.cuda.synchronize()
    first = [t for t in _flat(outs[0])]
    for tc, out in zip(chunks, outs[1:]):
        for a, b in zip(first, _flat(out)):
            assert torch.equal(a, b), f"chunk {tc} differs from one chunk"


def _flat(out):
    if isinstance(out, TCA):
        return [out.re, out.im]
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _flat(o)]
    return [out]


@pytest.mark.cuda
@pytest.mark.parametrize("grade", GRADES)
def test_forced_chunks_equal_one_chunk_on_card(card, grade):
    """A launch forced to stage 8 or 16 taps at a time (the ``chunk``
    argument, a test's knob: the models and ops take the library's plan)
    equals the one-chunk launch bit for bit, the same sums in the same
    order: B1 at the flagship (16 channels, 64 taps, D=4, audio and
    carries), B3-dense at am_d (8 channels, 32 taps, D=4) and B4 at the
    transmux's K=32, Q=8, and a chunk of 24 taps whose last chunk is
    shorter than the rest (64 = 24 + 24 + 16)."""
    m = _model("cuda", 16, 64, 4, precision=grade)
    assert dense_chunk("fm_chain", "cuda", 64, 4, grade) == 64
    re, im = _fm_signal(m.channel_frequencies, 4096 + 63, seed=12)
    buf = TCA(re, im)
    n0, _, cf, cz = m.init()
    args = (buf, m.tap_bank, m.lo_table, n0, 4, m.gain, m.deemph, cf, cz)
    _forced_chunks(lambda tc: fm_chain(*args, precision=grade, chunk=tc),
                   (8, 16, 24))
    n_ = np.arange(32) - 15.5
    h = np.sinc(2 * 0.04 * n_) * np.hamming(32)
    am = AmReceiver(FS, 100e6, tuple(100e6 - 200e3 + 50e3 * i
                                     for i in range(8)), 4,
                    tuple(h / h.sum()), precision=grade, device="cuda")
    ra, ia = _am_signal([-200e3 + 50e3 * i for i in range(8)], 4096 + 31,
                        seed=13)
    n0, _ = am.init()
    _forced_chunks(lambda tc: am_chain(TCA(ra, ia), am.tap_bank, am.lo_table,
                                       n0, 4, precision=grade, chunk=tc),
                   (8, 16, 24))
    k = 32
    taps = np.hamming(8 * k) / np.hamming(8 * k).sum()
    bank = _analysis_tables(_taps_key(taps), k, "cuda")[0]
    x = _planar_cuda(k * 300, seed=14)
    assert dense_chunk("channelize", "cuda", 8 * k, k, grade, k) == 8 * k
    _forced_chunks(lambda tc: channelize_kernel(x, bank, k, precision=grade,
                                                chunk=tc), (8, 64, 24))


def _f32_dense_run(lib, c, t, d, n, seed, grade="f32"):
    """run(chunk) of one dense launch of ``lib`` (B1, B3-dense or B4) at
    the grade (f32 unless said) for C channels, T taps and D over n random
    samples (the FM chain with an identity rotor and a de-emphasis; its
    outputs need no meaning to be held bit for bit); ``chunk`` None takes
    the library's plan."""
    x = _planar_cuda(n, seed)
    bank = _bank(c, t)
    if lib == "channelize":
        return lambda tc: channelize_kernel(x, bank, d, precision=grade,
                                            chunk=tc)
    n0 = torch.zeros(1, dtype=torch.int32, device="cuda")
    lo = torch.zeros((c, 4), device="cuda")
    if lib == "am_chain":
        return lambda tc: am_chain(x, bank, lo, n0, d, precision=grade,
                                   chunk=tc)
    zeros = torch.zeros((c, 1), device="cuda")
    deemph = torch.tensor([0.5, 0.25, 0.5], device="cuda")
    return lambda tc: fm_chain(x, bank, lo, n0, d, 1.0, deemph,
                               TCA(zeros, zeros), zeros, precision=grade,
                               chunk=tc)


# (library, C, T, D, forced chunks): f32 dense geometries whose one-chunk
# block fits (the flagship's 16 channels at 257 taps, am_d's 8 at 129, the
# transmux's 32 at K=32, Q=8), and the phase-11 paths whose planned chunk
# is a chunked launch (the 2049-tap long filter, am_d128, the transmux at
# Q=127; am_d128 takes no 64-tap chunk: its two buffers of 64 of D=128
# phases would need 270 KB)
F32_CHUNK_CASES = [("fm_chain", 16, 257, 4, (8, 24, 64)),
                   ("am_chain", 8, 129, 4, (8, 24, 64)),
                   ("channelize", 32, 256, 32, (8, 24, 64)),
                   ("fm_chain", 16, 2049, 4, (8, 24, 64)),
                   ("am_chain", 8, 1021, 128, (8, 24)),
                   ("channelize", 32, 4064, 32, (8, 24, 64))]


@pytest.mark.cuda
@pytest.mark.parametrize("lib,c,t,d,forced", F32_CHUNK_CASES)
def test_f32_dense_chunks_bit_equal_on_card(card, lib, c, t, d, forced):
    """B1, B3-dense and B4 at f32: the planned launch (one chunk where its
    block fits, else chunks of a multiple of 8 taps in two staging
    buffers) and launches forced to 8, 24 and 64 taps a chunk give every
    output bit for bit, the same fmaf over ascending t from zero in the
    tiled, double-buffered front."""
    tc = dense_chunk(lib, "cuda", t, d, "f32", c)
    assert tc == t if t <= 257 else (8 <= tc < t and tc % 8 == 0)
    run = _f32_dense_run(lib, c, t, d, t + d * (3 * 256 + 41), seed=c + t)
    _forced_chunks(run, forced)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 24])
def test_f32_dense_blocks_of_8_and_32_channels_on_card(card, c):
    """The f32 dense front's blocks of 8 channels (C = 8) and of 32 (C =
    24, one block with 8 zero channels; the FM chain's back end two
    threads a row) against the plain versions at f32: B1 through
    FmChannelizer(impl='cuda') within 1e-4 of max|audio| after the
    warm-up and its carries within 1e-4, B3-dense through AmReceiver
    within 1e-5, B4 within 1e-5 of max|y|."""
    kern, plain = (_model(impl, c, 64, 4, precision="f32")
                   for impl in ("cuda", "torch"))
    re, im = _fm_signal(kern.channel_frequencies, 40_000, seed=c)
    (sk, yk), (sp, yp) = (m.step(m.init(), TCA(re, im))
                          for m in (kern, plain))
    err = (yk - yp)[:, SKIP:].abs().max() / yp[:, SKIP:].abs().max()
    assert float(err) <= 1e-4
    for a, b in ((sk[2].re, sp[2].re), (sk[2].im, sp[2].im), (sk[3], sp[3])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    n_ = np.arange(32) - 15.5
    h = np.sinc(2 * 0.04 * n_) * np.hamming(32)
    freqs = tuple(100e6 - 400e3 + 25e3 * i for i in range(c))
    am, am_plain = (AmReceiver(FS, 100e6, freqs, 4, tuple(h / h.sum()),
                               impl=impl, precision="f32", device="cuda")
                    for impl in ("cuda", "torch"))
    ra, ia = _am_signal([f - 100e6 for f in freqs], 40_000, seed=c + 1)
    before = am_chain.launches
    _, ya = am.step(am.init(), TCA(ra, ia))
    _, yb = am_plain.step(am_plain.init(), TCA(ra, ia))
    assert am_chain.launches == before + 1
    torch.testing.assert_close(ya, yb, rtol=0, atol=1e-5)
    n = 256 + 8 * (5 * 256 + 37)
    x = _planar_cuda(n, seed=c + 2)
    bank = _bank(c, 256)
    y = channelize_kernel(x, bank, 8, precision="f32")
    want = channelize_reference(x, bank, 8, "f32")
    scale = float(torch.maximum(want.re.abs().max(), want.im.abs().max()))
    for a, b in ((y.re, want.re), (y.im, want.im)):
        assert float((a - b).abs().max()) <= 1e-5 * scale


# (library, C, T, D, outputs M, forced chunks, block on 132 SMs): the bf16
# chunked kernel at each block shape its launchers take
# (fronts.cuh, mma_chunk_block: channels by C, then on the H100 fewer rows
# (B3, B4) and channels while the grid still fits one wave), whose one
# chunk fits (the chunked launches against the one-chunk kernel's), T < D
# (every launch chunked), and the phase-11 paths (the planner's chunks
# against forced ones; a block of 256 rows takes no 64-tap chunk at D >=
# 128: two buffers of 64 phases would need 270 KB)
MMA_CHUNK_CASES = [
    ("fm_chain", 16, 257, 4, 255 * 8, (8, 24, 64), (4, 256)),
    ("fm_chain", 16, 257, 4, 255 * 40, (8, 24, 64), (8, 256)),
    ("fm_chain", 16, 257, 4, 255 * 100, (8, 24, 64), (16, 256)),
    ("fm_chain", 1, 65, 256, 4096, (8, 24), (4, 256)),
    ("fm_chain", 16, 257, 128, 8192, (8, 24), (4, 256)),
    ("am_chain", 8, 129, 4, 8192, (8, 24, 64), (8, 64)),
    ("am_chain", 16, 129, 4, 4096, (8, 24, 64), (8, 64)),
    ("am_chain", 3, 65, 256, 4096, (8, 24, 64), (4, 64)),
    ("am_chain", 8, 1021, 128, 8192, (8, 24, 64), (8, 64)),
    ("channelize", 32, 256, 32, 8192, (8, 24, 64), (32, 64)),
    ("channelize", 5, 61, 4, 20000, (8, 24, 64), (8, 256)),
    ("channelize", 12, 130, 8, 2000, (8, 24, 64), (4, 64)),
    ("channelize", 24, 256, 32, 16384, (8, 24, 64), (32, 128)),
    ("channelize", 32, 4064, 32, 32768, (8, 24, 64), (32, 256)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("grade", ["bf16x3", "bf16x2"])
@pytest.mark.parametrize("lib,c,t,d,m,forced,block", MMA_CHUNK_CASES)
def test_mma_chunked_blocks_bit_equal_on_card(card, grade, lib, c, t, d, m,
                                              forced, block):
    """B1, B3-dense and B4 at bf16x3 and bf16x2 at each block shape of the
    chunked tensor-core front (4, 8, 16, 32 channels; 256, 128, 64 rows):
    the planned launch (the one-chunk kernel where its block fits, else
    the chunked kernel's planned chunks in two staging buffers) and
    launches forced to 8, 24 and 64 taps a chunk give every output bit for
    bit, the same mma.sync fragments in ascending blocks of 8 taps; the
    library reports the block (on a card of 132 SMs, the one listed)."""
    tc, ch, rows = dense_block(lib, "cuda", t, d, grade, c, m)
    assert tc == t or (8 <= tc < t and tc % 8 == 0)
    if torch.cuda.get_device_properties(0).multi_processor_count == 132 \
            and (tc < t or t < d):
        assert (ch, rows) == block
    run = _f32_dense_run(lib, c, t, d, t + d * (m - 1), seed=c + t + m,
                         grade=grade)
    _forced_chunks(run, forced)


@pytest.mark.cuda
def test_mma_chunked_tile_kernels_do_not_spill_on_card(card, tmp_path):
    """No bf16 chunked dense tile kernel (B1 at 4, 8 and 16 channels; B3 at
    4, 8 and 16 channels and 256, 128 and 64 rows; B4 also at 32 channels;
    each grade: 48 kernels) spills registers, by ptxas's report."""
    spills = _ptxas_spills(tmp_path, ("fm_chain", "am_chain", "channelize"))
    pattern = (r"(fm_chain_tile|am_chain_tile)ILb0ELi[23]ELb1ELi\d+E|"
               r"channelize_tileILb0ELi[23]ELi\d+ELb1E")
    found = {k: v for k, v in spills.items() if re.search(pattern, k)}
    assert len(found) == 48, sorted(found)
    for kernel, (stores, loads) in found.items():
        assert stores == 0 and loads == 0, (kernel, stores, loads)


def _ptxas_spills(tmp_path, libraries):
    """{kernel: (spill store bytes, spill load bytes)} of every kernel of
    the libraries, from ptxas's report of a fresh nvcc build of each (the
    build's own command, -Xptxas -v; one process a source, all at once)."""
    procs = [subprocess.Popen(
        _build.nvcc_command(name, tmp_path / f"lib{name}.so"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in libraries]
    report = ""
    for proc in procs:
        out, err = proc.communicate()
        assert proc.returncode == 0, err
        report += out + err
    spills, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            entry = m.group(1)
        elif entry and "spill stores" in line:
            spills[entry] = tuple(int(v) for v in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
            entry = None
    return spills


@pytest.mark.cuda
def test_f32_dense_tile_kernels_do_not_spill_on_card(card, tmp_path):
    """No f32 dense tile kernel (B1, B3-dense and B4 at f32: blocks of 8,
    16 and 32 channels, one chunk and chunked, 18 kernels) spills
    registers, by ptxas's report (the FM chain's 32-byte stack frame is
    sincosf's slow path, in every FM tile kernel, not a spill)."""
    spills = _ptxas_spills(tmp_path, ("fm_chain", "am_chain", "channelize"))
    pattern = (r"(fm_chain_tile|am_chain_tile)ILb0ELi0ELb\dELi\d+E|"
               r"channelize_tileILb0ELi0ELi\d+ELb\dE")
    found = {k: v for k, v in spills.items() if re.search(pattern, k)}
    assert len(found) == 18, sorted(found)
    for kernel, (stores, loads) in found.items():
        assert stores == 0 and loads == 0, (kernel, stores, loads)


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
    gap of the f32 plain chain (AM_GRADE_GAP); the dense front in chunks
    where its whole bank does not fit a block."""
    kern = {impl: _grid_model(AmReceiver, impl, k, d, t, c, precision=grade)
            for impl in ("pfb", "cuda")}
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
    """Both libraries take every grade at the wideband critical shape in
    one chunk, and K=640, D=64, T=1280 at every grade in chunks: at f32
    the 32-channel bank rows of 640 lanes and two A tiles take 224 KB
    before the window, at the bf16 grades the lane-ordered B table 160
    KB, so no one-chunk block fits, and a launch forced to one chunk is
    refused before launch. The models take the grid with impl='pfb' at
    each grade, and each launch is within its grade's gate of the plain
    PFB chain (_witness_within)."""
    for lib in ("fm_chain", "am_chain"):
        for grade in GRADES:
            assert pfb_chunk(lib, "cuda", 64, 8, 64, grade) == (64, 8)
            assert front_supported(lib, "cuda", 1280, 64, 640, grade)
        for grade in GRADES:
            lanes, uc = pfb_chunk(lib, "cuda", 640, 2, 64, grade)
            assert 8 <= lanes < 640 and lanes % 8 == 0 and uc >= 1
    for grade in GRADES:
        for cls in (FmChannelizer, AmReceiver):
            _witness_within(cls, 640, 64, 1280, grade)
    for grade in ("bf16x3", "f32"):
        m = _witness_model(AmReceiver, 640, 64, 1280, 8, grade)
        args = _witness_args(m, 640 * 64)
        before = pfb_am_chain.launches
        with pytest.raises(RuntimeError, match="too many resources"):
            pfb_am_chain(*args, precision=grade, plan=(640, 2))
        assert pfb_am_chain.launches == before


def _witness_model(cls, k, d, t, c, grade):
    """A receiver at impl='pfb' on the Fs/k grid with Fs = 1024*k (exact in
    binary), c channels spread over it; FM at a tenth of a channel's
    deviation and a 1-ms de-emphasis (chip_smoke.py's witness_model)."""
    fs = 1024.0 * k
    n = np.arange(t) - (t - 1) / 2.0
    h = np.sinc(2 * (0.4 / k) * n) * np.hamming(t)
    kw = {"frequency_deviation": 0.1 * fs / k, "deemphasis_tau": 1e-3} \
        if cls is FmChannelizer else {}
    return cls(sample_rate=fs, tuning_frequency=0.0,
               channel_frequencies=tuple(-(fs / k) * ((7 * i) % k)
                                         for i in range(c)),
               decimation=d, low_pass_taps=tuple(h / h.sum()), impl="pfb",
               precision=grade, device="cuda", **kw)


def _witness_args(model, n, seed=3):
    """The PFB kernel's arguments for the first n samples of a fresh stream
    of the model: FM or 50%-AM carriers on its channels, tones a few
    hundredths of a channel."""
    r = np.random.default_rng(seed)
    fs = model.sample_rate
    spacing = fs / model.pfb_grid[0]
    t = np.arange(n) / fs
    sig = np.zeros(n, np.complex128)
    fm = isinstance(model, FmChannelizer)
    for i, f in enumerate(model.channel_frequencies):
        tone = spacing * (0.04 + 0.0005 * i)
        msg = np.sin(2 * np.pi * tone * t + r.uniform(0, 6))
        ph = 2 * np.pi * f * t + r.uniform(0, 6)
        if fm:
            ph = ph + model.frequency_deviation / tone * msg
            sig += np.exp(1j * ph) / len(model.channel_frequencies)
        else:
            sig += 0.6 * (1.0 + 0.5 * msg) * np.exp(1j * ph)
    tail = model.init()[1]
    buf = TCA(torch.cat([tail.re, torch.from_numpy(
                  sig.real.astype(np.float32)).cuda()]),
              torch.cat([tail.im, torch.from_numpy(
                  sig.imag.astype(np.float32)).cuda()]))
    n0, _, *carries = model.init()
    head = (buf, model.poly_taps, model.dft_bank, model.num_taps,
            model.lo_table, n0, model.decimation)
    return head + ((model.gain, model.deemph, *carries) if fm else ())


def _witness_within(cls, k, d, t, grade, c=40):
    """One launch of the PFB kernel of a _witness_model at the grade on
    1536 grid periods against its plain version at the grade: FM audio
    within 1e-4 of max|audio| after SKIP outputs (the zero-primed first
    output reads +-pi*gain in the plain chain, 0 in the kernel, and the
    de-emphasis carries it a few ms), the discriminator's carry within
    1e-4, the de-emphasis state, which is audio, within 1e-4 of
    max|audio| (as chip_smoke.py's compare_fm: this audio reaches ~54);
    AM envelopes within 4e-5 (float32 sums of 2K products a channel in
    other orders at K up to 712)."""
    m = _witness_model(cls, k, d, t, c, grade)
    assert m.front == "pfb" and m.pfb_grid[0] == k
    args = _witness_args(m, k * 1536)
    fm = cls is FmChannelizer
    kernel = pfb_fm_chain if fm else pfb_am_chain
    ref = pfb_fm_chain_reference if fm else pfb_am_chain_reference
    before = kernel.launches
    got = kernel(*args, precision=grade)
    assert kernel.launches == before + 1
    want = ref(*args, precision=grade)
    if fm:
        y, w = got[0][:, SKIP:], want[0][:, SKIP:]
        scale = float(w.abs().max())
        assert float((y - w).abs().max()) <= 1e-4 * scale
        for a, b in ((got[1].re, want[1].re), (got[1].im, want[1].im)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
        torch.testing.assert_close(got[2], want[2], rtol=0,
                                   atol=1e-4 * max(1.0, scale))
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=4e-5)


# (K, D) of the grid sweep: K >= 8, D | K, up to P*K <= 12,500 (the JAX
# plans' VMEM budget's reach), crossing the three overflows of the
# one-chunk block: the B table or bank (large K), the taps (Q*K) and the
# window (Q*P)
SWEEP_K = (8, 24, 64, 96, 128, 200, 256, 512, 640, 712, 960, 1024, 2048,
           4096, 8192)
SWEEP_Q = (1, 2, 4, 16, 64, 127)


@pytest.mark.cuda
def test_pfb_front_supported_over_the_grid_on_card(card):
    """front_supported holds for the PFB front of fm_chain and am_chain at
    every grade over the sweep of (K, D, Q), and the plan is one chunk
    (K, Q) or a chunk of a multiple of 8 lanes."""
    for k in SWEEP_K:
        for d in [x for x in range(1, k + 1) if k % x == 0]:
            if (k // d) * k > 12_500:
                continue
            for q in SWEEP_Q:
                for lib in ("fm_chain", "am_chain"):
                    for grade in GRADES:
                        assert front_supported(lib, "cuda", q * k, d, k,
                                               grade), (lib, grade, k, d, q)
                        lanes, uc = pfb_chunk(lib, "cuda", k, q, d, grade)
                        assert (lanes, uc) == (k, q) or (
                            lanes % 8 == 0 and 8 <= lanes and 1 <= uc <= q)


@pytest.mark.cuda
@pytest.mark.parametrize("grade", GRADES)
def test_pfb_forced_plans_bit_equal_on_card(card, grade):
    """At the wideband critical grid (K=64, Q=8) and at D=8, B2 and B3-PFB
    launched with plans forced into chunks (8 lanes and every tap; 16
    lanes and u-ranges of 3 taps; 24 lanes and 1 tap) equal the
    planner's one-chunk launch bit for bit: the chunks fall on the
    one-chunk kernel's 8-lane blocks and every fold sums in ascending u."""
    for cls, d in ((FmChannelizer, 64), (FmChannelizer, 8), (AmReceiver, 64)):
        kw = {"frequency_deviation": 75_000.0} if cls is FmChannelizer \
            else {}
        m = _grid_model(cls, "pfb", 64, d, 512, 64, precision=grade, **kw)
        assert pfb_chunk("fm_chain" if kw else "am_chain", "cuda", 64, 8, d,
                         grade) == (64, 8)
        args = _witness_args(m, 64 * 256)
        kernel = pfb_fm_chain if kw else pfb_am_chain
        want = tree_flatten(kernel(*args, precision=grade))[0]
        for plan in ((8, 8), (16, 3), (24, 1)):
            got = tree_flatten(kernel(*args, precision=grade, plan=plan))[0]
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (cls.__name__, d, plan)


# (K, D, T) of chunked bf16 PFB launches: the NFM grid (P = 4, Q = 4, D a
# multiple of 16; 40 channels, two channel groups) and the witnesses
CHUNKED_PFB = [(640, 160, 2560), (640, 64, 1280), (712, 89, 2848)]


@pytest.mark.cuda
@pytest.mark.parametrize("grade", ["bf16x3", "bf16x2"])
def test_pfb_chunked_forced_plans_bit_equal_on_card(card, grade):
    """Where the planner takes pfb_front_mma_chunked (the NFM grid and the
    K=640 and K=712 witnesses), B2's and B3-PFB's planned launch equals
    launches forced to (8 lanes, every tap), (16, 3) and (24, 1) bit for
    bit: every plan's chunks fall on the one-chunk kernel's 8-lane blocks,
    its folds sum in ascending u across u-ranges and its accumulators take
    the same fragments in the same order."""
    for k, d, t in CHUNKED_PFB:
        q = -(-t // k)
        for cls, kernel, lib in ((FmChannelizer, pfb_fm_chain, "fm_chain"),
                                 (AmReceiver, pfb_am_chain, "am_chain")):
            lanes, uc = pfb_chunk(lib, "cuda", k, q, d, grade)
            assert lanes < k or uc < q, (lib, k, lanes, uc)
            m = _witness_model(cls, k, d, t, 40, grade)
            args = _witness_args(m, k * 1536)
            want = tree_flatten(kernel(*args, precision=grade))[0]
            for plan in ((8, q), (16, 3), (24, 1)):
                got = tree_flatten(kernel(*args, precision=grade,
                                          plan=plan))[0]
                assert len(got) == len(want)
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (lib, k, d, plan)


# The benchmark's deployments (sdr_bench/configs) and their 20-ms blocks:
# land-mobile NFM, 320 channels of Fs/640 at 8 MHz (D = 160), and VHF
# airband AM, 480 channels of Fs/960 at 7.99992 MHz (D = 240)
LIVE_CELLS = {
    "fm": dict(fs=8e6, k=640, first=-160, c=320, taps=2560, cutoff=5000.0,
               d=160, n=160_000),
    "am": dict(fs=7.99992e6, k=960, first=-240, c=480, taps=3840,
               cutoff=3000.0, d=240, n=160_320)}


def _live_cell(kind, grade):
    """The deployment's receiver at impl='pfb' and the grade, and its PFB
    kernel's arguments for one 20-ms block (_witness_args), FM with a
    de-emphasis state that is not zero."""
    c = LIVE_CELLS[kind]
    n = np.arange(c["taps"]) - (c["taps"] - 1) / 2.0
    h = np.sinc(2 * c["cutoff"] / c["fs"] * n) * np.hamming(c["taps"])
    kw = dict(sample_rate=c["fs"], tuning_frequency=0.0,
              channel_frequencies=tuple((c["first"] + i) * c["fs"] / c["k"]
                                        for i in range(c["c"])),
              decimation=c["d"], low_pass_taps=tuple(h / h.sum()),
              impl="pfb", precision=grade, device="cuda")
    if kind == "fm":
        model = FmChannelizer(frequency_deviation=2500.0,
                              deemphasis_tau=75e-6, **kw)
    else:
        model = AmReceiver(**kw)
    args = list(_witness_args(model, c["n"]))
    if kind == "fm":
        args[-1] = torch.linspace(-0.3, 0.3, c["c"],
                                  device="cuda")[:, None].contiguous()
    return model, tuple(args)


@pytest.mark.cuda
@pytest.mark.parametrize("grade", ["bf16x3", "bf16x2"])
@pytest.mark.parametrize("kind", ["fm", "am"])
def test_pfb_row_tiles_bit_equal_on_card(card, kind, grade):
    """At both deployments' banks and 20-ms blocks the planner takes blocks
    of 128 rows on the H100 (80 and 90 of them; 256 rows took 40 and 45),
    chunks of 32 lanes and all 4 fold taps; launches forced to 128 and 64
    rows equal the forced 256-row launch: the AM audio and the FM
    discriminator's carry bit for bit (every row's fold and every column's
    sum are the same), the FM audio and de-emphasis state within 1e-6 of
    max|audio| (start states composed over other tile edges); the
    planned launch equals the forced 128-row one bit for bit. The wrapper
    counts each launch under its rows, and at bf16x3 the counted kernel's
    blocks a launch are the planned grid."""
    from gsdr_tpu_torch.kernels import am_chain as am_lib
    from gsdr_tpu_torch.kernels import fm_chain as fm_lib
    from gsdr_tpu_torch.utils import profiling

    _, args = _live_cell(kind, grade)
    fm = kind == "fm"
    kernel = pfb_fm_chain if fm else pfb_am_chain
    lib = "fm_chain" if fm else "am_chain"
    c = LIVE_CELLS[kind]
    q, m = -(-c["taps"] // c["k"]), c["n"] // c["d"]
    lanes, uc, rows = pfb_block(lib, "cuda", c["k"], q, c["d"], grade,
                                c["c"], m)
    grid = -(-m // (rows - fm)) * -(-c["c"] // 32)
    if torch.cuda.get_device_properties(0).multi_processor_count == 132:
        assert (lanes, uc, rows, grid) == (32, 4, 128, 80 if fm else 90)
    want = _flat(kernel(*args, precision=grade, rows=256))
    for r in (128, 64):
        before = dict(kernel.row_tiles)
        got = _flat(kernel(*args, precision=grade, rows=r))
        assert kernel.row_tiles[r] == before[r] + 1
        if not fm:
            assert torch.equal(got[0], want[0]), r
            continue
        scale = float(want[0].abs().max())
        assert float((got[0] - want[0]).abs().max()) <= 1e-6 * scale, r
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        assert float((got[3] - want[3]).abs().max()) <= 1e-6 * scale, r
    before = dict(kernel.row_tiles)
    planned = _flat(kernel(*args, precision=grade))
    assert kernel.row_tiles[rows] == before[rows] + 1
    forced = _flat(kernel(*args, precision=grade, rows=rows))
    for a, b in zip(planned, forced):
        assert torch.equal(a, b)
    if grade == "bf16x3":
        with profiling.tracing(profiling.COUNTERS) as rec:
            kernel(*args, precision=grade)
            torch.cuda.synchronize()
            got = rec.counters()[(fm_lib if fm else am_lib)
                                 .pfb_counters.kernel]
        assert got["launches"] == 1 and got["blocks"] == grid


@pytest.mark.cuda
def test_pfb_mma_chunked_tile_kernels_do_not_spill_on_card(card, tmp_path):
    """No bf16 chunked PFB tile kernel (B2 and B3-PFB at bf16x3 and
    bf16x2, in blocks of 256, 128 and 64 rows: pfb_front_mma_chunked's 8
    consumer warps with up to 64 accumulators each and 8 producer warps
    under the 512-thread block's 128 registers) spills registers, by
    ptxas's report."""
    spills = _ptxas_spills(tmp_path, ("fm_chain", "am_chain"))
    pattern = r"(fm_chain_tile|am_chain_tile)ILb1ELi[23]ELb1E"
    found = {k: v for k, v in spills.items() if re.search(pattern, k)}
    assert len(found) == 12, sorted(found)
    for kernel, (stores, loads) in found.items():
        assert stores == 0 and loads == 0, (kernel, stores, loads)


@pytest.mark.cuda
@pytest.mark.parametrize("grade", ["bf16x3", "bf16x2"])
def test_channelize_block_follows_channels_on_card(card, grade):
    """At the bf16 grades B4 takes 16 channels per block up to C=16 and 32
    above, and its plan answers for the block of the call: T=1024 at D=1
    fits the 16-channel block in one chunk, the 32-channel block (C=17, or
    a plan that names no C) only in chunks. Both launch and match their
    plain version within 4e-5 of max|y|: float32 sums of 3*T products in
    other orders, whose error grows with T (1e-5 holds to T=256, and 1024
    taps read 1.06e-5 at bf16x3 on the H100)."""
    t, d = 1024, 1
    assert dense_chunk("channelize", "cuda", t, d, grade, 16) == t
    for c in (17, None):
        assert 8 <= dense_chunk("channelize", "cuda", t, d, grade, c) < t
    x = _planar_cuda(t + d * (2 * 256 + 37), seed=8)
    for c in (16, 17):
        bank = _bank(c, t)
        before = channelize_kernel.launches
        y = channelize_kernel(x, bank, d, precision=grade)
        assert channelize_kernel.launches == before + 1
        want = channelize_reference(x, bank, d, grade)
        scale = float(torch.maximum(want.re.abs().max(),
                                    want.im.abs().max()))
        for a, b in ((y.re, want.re), (y.im, want.im)):
            assert float((a - b).abs().max()) <= 4e-5 * scale


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
    each call still matches the plain scan, and the scratch's header, on
    the device, follows the calls: its epoch index advanced once a call,
    no ticket left taken."""
    from gsdr_tpu_torch.kernels import iir as tk

    b, a = (np.float32(v) for v in LONG_MEMORY["slow_real"])
    filt = tk.iir_filter(b, a, "cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    tk.iir_kernel(torch.randn(1 << 20, device="cuda"), filt, None)
    scr = tk._scratch[(0, stream)]
    buf = scr.buf

    def header():
        head = buf[:8].view(torch.int64).item()
        return head >> 32, head & 0xffffffff

    index, tickets = header()
    assert tickets == 0
    sizes = [1 << 18, 5000, 1 << 20, 1, (1 << 18) + 3] * 3
    for i, n in enumerate(sizes):
        x = torch.randn(n, generator=g, device="cuda")
        zi = torch.randn(1, generator=g, device="cuda")
        if i % 2:
            xp = TCA(x, torch.flip(x, [0]).contiguous())
            y, zf = tk.iir_kernel(xp, filt, TCA(zi, -zi))
            _iir_check(b, a, x, zi, y.re, zf.re)
            _iir_check(b, a, xp.im, -zi, y.im, zf.im)
        else:
            y, zf = tk.iir_kernel(x, filt, zi)
            _iir_check(b, a, x, zi, y, zf)
    assert tk._scratch[(0, stream)] is scr and scr.buf is buf
    assert header() == (index + len(sizes), 0)


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
def test_single_channel_ops_take_the_kernel_where_the_bank_chunks(card):
    """fm_demod and am_demod under 'auto' on the card at T=1021, D=128,
    whose bank does not fit one block (test_grades_fit_and_refuse_on_card):
    one B1 and one B3-dense launch at each grade, in chunks, never the
    composed chain; FM within 1e-4 of max|audio| of the kernel's plain
    version at the grade, AM within 4e-5 (T=1021's longer sums, as
    test_shared_memory_check_on_card; the H100 read 1.18e-5)."""
    from gsdr_tpu_torch.ops.am import am_chain_args, am_demod
    from gsdr_tpu_torch.ops.fm import fm_chain_args, fm_demod, fm_demod_gain

    taps = _lowpass_np(1021, 0.002)
    x = _tone_signal(1021 + 128 * 300, 100_000.0, dev=500.0, tone=50.0)
    xa = _tone_signal(1021 + 128 * 300, 100_000.0, tone=50.0, am=True)
    gain = fm_demod_gain(FS, 500.0)
    fargs = fm_chain_args(x, taps, FS, -100_000.0, gain, 128)
    aargs = am_chain_args(xa, taps, FS, -100_000.0, 128)
    for grade in GRADES:
        before = (fm_chain.launches, am_chain.launches)
        y = fm_demod(x, taps, FS, 0.0, 100_000.0, 500.0, 128,
                     precision=grade)
        e = am_demod(xa, taps, FS, 0.0, 100_000.0, 128, precision=grade)
        torch.cuda.synchronize()
        assert (fm_chain.launches, am_chain.launches) == \
            (before[0] + 1, before[1] + 1)
        plain = fm_chain_reference(*fargs, precision=grade)[0][0, 1:]
        assert float((y - plain).abs().max()) <= 1e-4 * float(
            plain.abs().max())
        want = am_chain_reference(*aargs, precision=grade)[0]
        assert float((e - want).abs().max()) <= 4e-5


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
    # the runner compiles the step: one eager warm-up launch and the
    # capture's; the 8 blocks replay the graph (counted by the profiler in
    # test_stream_runner_replays_its_graph_on_card)
    assert fm_chain.launches == before + 2
    first = run(raw[:len(raw) // 2], "a.f32", "--save-state", state)
    second = run(raw[len(raw) // 2:], "b.f32", "--load-state", state)
    np.testing.assert_array_equal(np.concatenate([first, second]), whole)
    audio = whole.reshape(-1, 2).T[:, 512:]
    rate = fs / 8
    for c, tone in enumerate((1000.0, 1500.0)):
        a = audio[c] - audio[c].mean()
        peak = np.argmax(np.abs(np.fft.rfft(a * np.hanning(len(a))))[5:]) + 5
        assert abs(peak * rate / len(a) - tone) < 10.0


# ---------------------------------------------------------------------------
# the distributed layer on the card (ranks of tests/torch_shard_ranks.py)
# ---------------------------------------------------------------------------

SHARD_BLOCK = 1 << 16
SHARD_FIELDS = dict(
    sample_rate=FS, tuning_frequency=0.0,
    channel_frequencies=[-480_000.0 + 60_000.0 * i for i in range(16)],
    frequency_deviation=75_000.0, decimation=4, deemphasis_tau=75e-6,
    impl="auto", precision="bf16x3")


def _shard_inputs():
    k = np.arange(64) - 31.5
    h = np.sinc(2 * 0.03 * k) * np.hamming(64)
    fields = dict(SHARD_FIELDS, low_pass_taps=(h / h.sum()).tolist())
    r = np.random.default_rng(5)
    t = np.arange(2 * SHARD_BLOCK) / FS
    sig = np.zeros(t.size, np.complex128)
    for i, f in enumerate(fields["channel_frequencies"]):
        msg = np.sin(2 * np.pi * (700.0 + 370.0 * i) * t + r.uniform(0, 6))
        sig += (0.5 / 16) * np.exp(1j * (2 * np.pi * f * t + 0.35 * msg))
    inputs = {"rf.re": sig.real.astype(np.float32),
              "rf.im": sig.imag.astype(np.float32),
              "sym": r.integers(0, 256, (256, 4096)).astype(np.int32)}
    return fields, inputs


def _single_card_audio(fields, inputs):
    model = FmChannelizer(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in fields.items()}, device="cuda")
    state, outs = model.init(), []
    before = fm_chain.launches
    for b in range(2):
        blk = slice(b * SHARD_BLOCK, (b + 1) * SHARD_BLOCK)
        state, y = model.step(state, TCA(
            torch.from_numpy(inputs["rf.re"][blk]).cuda(),
            torch.from_numpy(inputs["rf.im"][blk]).cuda()))
        outs.append(y.cpu().numpy())
    fm_chain.launches = before
    return model, outs, state


def _tiles(ranks, mesh, key):
    by = {tuple(int(v) for v in r[f"coords:{mesh}"]): r[key] for r in ranks}
    c = 1 + max(ci for ci, _ in by)
    t = 1 + max(s for _, s in by)
    return np.concatenate([np.concatenate([by[(ci, s)] for s in range(t)], -1)
                           for ci in range(c)])


@pytest.mark.cuda
def test_sharded_fm_over_nccl_world_of_one_on_card(card, tmp_path):
    """A 1x1 mesh over NCCL (a child process, a world of one): the sharded
    fused step runs B1 once a step, counted, and equals
    FmChannelizer.step at bf16x3 within 1e-4 of max|audio| and its
    carries within 1e-4."""
    import torch_shard_ranks
    from gsdr_tpu_torch.kernels import _build

    _build.build_all()      # here, not in every rank
    fields, inputs = _shard_inputs()
    cases = [dict(key="fm", kind="fm", mesh=[1, 1], rf="rf",
                  block=SHARD_BLOCK, segments=[[fields, 2]])]
    (rank,) = torch_shard_ranks.spawn(tmp_path, cases, inputs, world=1,
                                      backend="nccl", device="cuda")
    launches = dict(zip(torch_shard_ranks.KERNELS, rank["fm:launches"]))
    assert launches == {"fm_chain": 2, "pfb_fm_chain": 0, "am_chain": 0,
                        "pfb_am_chain": 0, "qpsk256": 0, "iir": 0}
    _, outs, state = _single_card_audio(fields, inputs)
    for b in range(2):
        got, want = rank[f"fm:audio{b}"], outs[b]
        skip = SKIP if b == 0 else 0
        err = np.abs(got - want)[:, skip:].max() / np.abs(want).max()
        assert err <= 1e-4
    np.testing.assert_allclose(rank["fm:state3"], state[3].cpu().numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(rank["fm:state2.re"],
                               state[2].re.cpu().numpy(), atol=1e-4)


@pytest.mark.cuda
def test_compiled_sharded_steps_over_nccl_world_of_one_on_card(card,
                                                                tmp_path):
    """A 1x1 mesh over NCCL (a child process, a world of one): the sharded
    FM step (the flagship's 16 channels, B1), AM step (a K=16 PFB shard,
    B3-PFB) and make_sharded_iir_step (a biquad, B5) through compile_step
    over two blocks equal their eager steps, the chains bit for bit and
    the IIR within 1e-5 of max|y| (B5's gate between its launches), with
    mesh.sent the same eager and compiled (none: a world of one calls no
    collective)."""
    import torch_shard_ranks
    from gsdr_tpu_torch.kernels import _build

    _build.build_all()      # here, not in the rank
    fields, inputs = _shard_inputs()
    n = np.arange(64) - 31.5
    h = np.sinc(2 * (0.4 / 16) * n) * np.hamming(64)
    am = dict(sample_rate=FS, tuning_frequency=0.0,
              channel_frequencies=[-(FS / 16) * i for i in range(8)],
              decimation=8, low_pass_taps=(h / h.sum()).tolist(),
              impl="pfb", precision="bf16x3")
    r = np.random.default_rng(9)
    inputs["x"] = r.standard_normal(2 * SHARD_BLOCK).astype(np.float32)
    b, a = [0.02, 0.04, 0.02], [1.0, -1.56, 0.64]
    cases = [dict(key="c", kind="compiled", mesh=[1, 1], fm=fields, am=am,
                  b=b, a=a, rf_fm="rf", rf_am="rf", x="x",
                  block=SHARD_BLOCK, steps=2)]
    (rank,) = torch_shard_ranks.spawn(tmp_path, cases, inputs, world=1,
                                      backend="nccl", device="cuda")
    for name in ("fm", "am", "iir"):
        keys = [k for k in rank if k.startswith(f"c:{name}:eager:")]
        assert len(keys) >= 4
        for k in keys:
            got, want = rank[k.replace(":eager:", ":compiled:")], rank[k]
            if name == "iir" and not k.endswith(":sent"):
                scale = np.abs(want).max()
                assert np.abs(got - want).max() <= 1e-5 * scale, k
            else:
                assert np.array_equal(got, want), k
        assert not rank[f"c:{name}:eager:sent"].any()


@pytest.mark.cuda
def test_two_gloo_ranks_share_the_card(card, tmp_path):
    """Two ranks on the one card over gloo, mesh (1, 2): each runs B1 once
    a step and B6 once, counted; the gathered audio equals the single-card
    step within 1e-4 of max|audio| plus the digit-table phase's allowance
    at the shard boundary, and 256 CIRCULAR streams loop back exactly."""
    import torch_shard_ranks
    from gsdr_tpu_torch.kernels import _build

    _build.build_all()      # here, not in every rank
    fields, inputs = _shard_inputs()
    cases = [dict(key="fm", kind="fm", mesh=[1, 2], rf="rf",
                  block=SHARD_BLOCK, segments=[[fields, 2]]),
             dict(key="q256", kind="qpsk256", mesh=[1, 2], symbols="sym",
                  fields=dict(constellation_type=CIRCULAR, amplitude=1.0,
                              exact_tables=False))]
    ranks = torch_shard_ranks.spawn(tmp_path, cases, inputs, world=2,
                                    device="cuda")
    for r in ranks:
        fm = dict(zip(torch_shard_ranks.KERNELS, r["fm:launches"]))
        q = dict(zip(torch_shard_ranks.KERNELS, r["q256:launches"]))
        assert fm["fm_chain"] == 2 and sum(fm.values()) == 2
        assert q["qpsk256"] == 1 and sum(q.values()) == 1
    model, outs, _ = _single_card_audio(fields, inputs)
    b0, cc, a = (abs(float(v)) for v in model.deemph.cpu())
    m = outs[0].shape[-1]
    h = np.concatenate([[b0], cc * a ** np.arange(m // 2 - 1)])
    allow = np.zeros(m)
    allow[m // 2:] = model.gain * 2 * np.pi * 2 * 6e-5 * h
    for b in range(2):
        got = _tiles(ranks, "[1, 2]", f"fm:audio{b}")
        want = outs[b]
        skip = SKIP if b == 0 else 0
        bound = 1e-4 * np.abs(want[:, skip:]).max() + allow[skip:]
        assert np.all(np.abs(got - want)[:, skip:] <= bound)
    rx = _tiles(ranks, "[1, 2]", "q256:rx")
    assert rx.dtype == np.int32
    np.testing.assert_array_equal(rx, inputs["sym"])


# ---------------------------------------------------------------------------
# The compiled step (utils/compile.py) on the card
# ---------------------------------------------------------------------------

CBLOCK = 1 << 18      # samples a block of the compiled paths here
CSTEPS = 8            # chained blocks
# tile kernels of each wrapper, as torch.profiler names them
FAMILIES = {"fm_chain": "fm_chain_tile<false", "pfb_fm_chain":
            "fm_chain_tile<true", "am_chain": "am_chain_tile<false",
            "pfb_am_chain": "am_chain_tile<true", "channelize":
            "channelize_tile<", "iir": "iir_chained<", "qpsk256":
            "qpsk256_demod<"}


def _stream_fm_chain(impl="auto"):
    import math

    import scipy.signal as ss
    from gsdr_tpu_torch.pipelines import fm_deemphasis_coeffs
    from gsdr_tpu_torch.stream import (Chain, FirStream, IirStream,
                                       MixerStream, QuadFmStream, SosStream)

    rate = FS / 4
    b, a = fm_deemphasis_coeffs(75e-6, rate)
    sos = tuple(tuple(r) for r in
                ss.butter(8, 15e3, fs=rate, output="sos").tolist())
    h = np.sinc(2 * 0.03 * (np.arange(64) - 31.5)) * np.hamming(64)
    return Chain((MixerStream(-100_000.0, FS),
                  FirStream(tuple((h / h.sum()).tolist()), 4),
                  QuadFmStream(rate / (2 * math.pi * 75_000.0)),
                  IirStream(b, a, impl=impl), SosStream(sos, impl=impl)))


def _carrier_blocks(n, steps):
    t = torch.arange(n * steps, dtype=torch.float64, device="cuda") / FS
    ph = 2 * np.pi * 100_000.0 * t + 10.0 * torch.sin(2 * np.pi * 1000.0 * t)
    rf = TCA(torch.cos(ph).float().contiguous(),
             torch.sin(ph).float().contiguous())
    return [TCA(rf.re[i * n:(i + 1) * n].clone(),
                rf.im[i * n:(i + 1) * n].clone()) for i in range(steps)]


def _planar_blocks(re, im, n, steps):
    return [TCA(re[i * n:(i + 1) * n].contiguous(),
                im[i * n:(i + 1) * n].contiguous()) for i in range(steps)]


def _compiled_path(name):
    """(step, initial state, blocks, the wrapper it launches and its
    launches a step, exact): the main paths of chip_smoke.py at a block
    of CBLOCK samples."""
    from gsdr_tpu_torch.ops.pfb import pfb_channelize_block

    n = CBLOCK
    if name == "flagship":
        m = _model("auto", 16, 64, 4)
        freqs = tuple(-480_000.0 + 60_000.0 * i for i in range(16))
        blocks = _planar_blocks(*_fm_signal(freqs, n * CSTEPS, 1), n, CSTEPS)
        return m.step, m.init(), blocks, ("fm_chain", 1), True
    if name in ("fm_wideband", "am_wideband"):
        cls = FmChannelizer if name == "fm_wideband" else AmReceiver
        kw = {"frequency_deviation": 1_000.0} if name == "fm_wideband" \
            else {}
        m = _grid_model(cls, "auto", 64, 64, 512, 64, **kw)
        assert m.front == "pfb"
        sig = _grid_fm_signal if name == "fm_wideband" else _am_signal
        freqs = [-(FS / 64) * i for i in range(64)]
        blocks = _planar_blocks(*sig(freqs, n * CSTEPS, 2), n, CSTEPS)
        kern = "pfb_fm_chain" if name == "fm_wideband" else "pfb_am_chain"
        return m.step, m.init(), blocks, (kern, 1), True
    if name == "am_d":
        h = np.sinc(2 * 0.04 * (np.arange(32) - 15.5)) * np.hamming(32)
        freqs = tuple(-200_000.0 + 50_000.0 * i for i in range(8))
        m = AmReceiver(sample_rate=FS, tuning_frequency=0.0,
                       channel_frequencies=freqs, decimation=4,
                       low_pass_taps=tuple(h / h.sum()), device="cuda")
        assert m.front == "toeplitz"
        blocks = _planar_blocks(*_am_signal(freqs, n * CSTEPS, 3), n, CSTEPS)
        return m.step, m.init(), blocks, ("am_chain", 1), True
    if name == "transmux":
        k = 32
        h = np.sinc(2 * (0.5 / k) * (np.arange(8 * k) - (8 * k - 1) / 2))
        taps = tuple((h * np.hamming(8 * k) / (h * np.hamming(8 * k)).sum())
                     .tolist())

        def step(tail, rf):
            y, tail = pfb_channelize_block(rf, taps, k, tail=tail)
            return tail, y

        g = torch.Generator(device="cuda")
        g.manual_seed(4)
        blocks = [TCA(torch.randn(n, generator=g, device="cuda"),
                      torch.randn(n, generator=g, device="cuda"))
                  for _ in range(CSTEPS)]
        return step, TCA(torch.zeros(7 * k, device="cuda"),
                         torch.zeros(7 * k, device="cuda")), blocks, \
            ("channelize", 1), True
    if name == "qpsk256":
        modem = Qpsk256Modem(CIRCULAR, 1.0, exact_tables=True,
                             device="cuda")
        g = torch.Generator(device="cuda")
        g.manual_seed(5)
        blocks = []
        for _ in range(CSTEPS):
            x = qpsk256_constellation(CIRCULAR, 1.0, planar=True,
                                      device="cuda")
            idx = torch.randint(0, 256, (n // 2,), generator=g,
                                device="cuda")
            blocks.append(TCA(
                x.re[idx] + 0.05 * torch.randn(n // 2, generator=g,
                                               device="cuda"),
                x.im[idx] + 0.05 * torch.randn(n // 2, generator=g,
                                               device="cuda")))
        return (lambda s, b: (s, modem.rx(b))), (), blocks, \
            ("qpsk256", 1), True
    if name == "iir_standalone":
        from gsdr_tpu_torch.stream import IirStream

        b, a = IIR_FILTERS["bench_biquad"]
        op = IirStream(b, a)
        g = torch.Generator(device="cuda")
        g.manual_seed(6)
        blocks = [torch.randn(n, generator=g, device="cuda")
                  for _ in range(CSTEPS)]
        return op.step, op.init(blocks[0]), blocks, ("iir", 1), False
    chain = _stream_fm_chain()
    blocks = _carrier_blocks(n, CSTEPS)
    return chain.step, chain.init(blocks[0]), blocks, ("iir", 5), False


COMPILED_PATHS = ["flagship", "fm_wideband", "am_wideband", "am_d",
                  "transmux", "qpsk256", "iir_standalone", "stream_fm"]


def _chained(step, state, blocks):
    outs = []
    for blk in blocks:
        state, y = step(state, blk)
        outs.append(y)
    return state, outs


def _leaves(tree):
    from gsdr_tpu_torch.utils.tree import tree_flatten

    return tree_flatten(tree)[0]


def _family_records(fn, reps=20):
    """Device records per call of fn() by wrapper (FAMILIES), from
    torch.profiler, rounded, and the total of device records per call. A
    trace can lose a record, or hold one an earlier trace lost: an empty
    trace first takes those, and the counts over 20 calls are rounded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if str(e.device_type).endswith("CUDA")]
    per = {k: round(sum(fam in nm for nm in names) / reps)
           for k, fam in FAMILIES.items()}
    return per, len(names) / reps


@pytest.mark.cuda
@pytest.mark.parametrize("name", COMPILED_PATHS)
def test_compiled_main_path_equals_eager_on_card(card, name):
    """Each main path compiled over 8 chained blocks against its eager
    step: bit for bit for B1-B4 and B6 (outputs and every state leaf), at
    B5's gate for the B5 paths (1e-5 of max|y| for the biquad; stream_fm's
    audio within 1e-4 of max|audio| after the warm-up and its states within
    1e-4, as its kernel-against-plain gate); one graph; an eager call after
    the capture still equals the eager step; and a replay launches the
    path's kernel as often as the eager step (torch.profiler)."""
    from gsdr_tpu_torch.utils.compile import compile_step

    step, state0, blocks, (kern, per_step), exact = _compiled_path(name)
    se, ye = _chained(step, state0, blocks)
    compiled = compile_step(step)
    sc, yc = _chained(compiled, state0, blocks)
    torch.cuda.synchronize()
    assert compiled.graphs == 1
    pairs = list(zip(_leaves(yc), _leaves(ye))) + \
        list(zip(_leaves(sc), _leaves(se)))
    if exact:
        for got, want in pairs:
            assert got.dtype == want.dtype and torch.equal(got, want)
    elif name == "iir_standalone":
        scale = float(torch.cat(ye).abs().max())
        for got, want in pairs:
            assert float((got - want).abs().max()) <= 1e-5 * scale
    else:
        y_c, y_e = torch.cat(yc)[SKIP:], torch.cat(ye)[SKIP:]
        assert float((y_c - y_e).abs().max()) <= 1e-4 * float(
            y_e.abs().max())
        for got, want in list(zip(_leaves(sc), _leaves(se)))[1:]:
            assert float((got - want).abs().max()) <= 1e-4
    # an eager step after the capture: the tables built in the warm-up
    s1, y1 = step(state0, blocks[0])
    s2, y2 = compiled(state0, blocks[0])
    if exact:
        for got, want in zip(_leaves((s2, y2)), _leaves((s1, y1))):
            assert torch.equal(got, want)
    per, _ = _family_records(lambda: compiled(sc, blocks[1]))
    want = {k: (per_step if k == kern else 0) for k in FAMILIES}
    assert per == want


@pytest.mark.cuda
def test_compiled_out_is_the_callers_and_new_length_captures_on_card(card):
    """The flagship compiled: ``out`` is unchanged by the next replay, the
    state returned is the graph's buffers and passed back is not copied
    (the next replay still equals the eager chain), a new block length
    captures a second graph and both stay right."""
    from gsdr_tpu_torch.utils.compile import compile_step

    step, state0, blocks, _, _ = _compiled_path("flagship")
    compiled = compile_step(step)
    s1, y1 = compiled(state0, blocks[0])
    keep = y1.clone()
    s2, y2 = compiled(s1, blocks[1])
    assert torch.equal(y1, keep)
    assert all(a is b for a, b in zip(_leaves(s1), _leaves(s2)))
    e1, f1 = step(state0, blocks[0])
    e2, f2 = step(e1, blocks[1])
    assert torch.equal(y2, f2)
    half = TCA(blocks[2].re[:CBLOCK // 2].contiguous(),
               blocks[2].im[:CBLOCK // 2].contiguous())
    s3, y3 = compiled(s2, half)
    assert compiled.graphs == 2
    e3, f3 = step(e2, half)
    assert torch.equal(y3, f3)
    s4, y4 = compiled(s3, blocks[3])
    assert compiled.graphs == 2
    assert torch.equal(y4, step(e3, blocks[3])[1])


@pytest.mark.cuda
def test_b5_eager_calls_interleave_with_replays_on_card(card):
    """B5 captured in a graph and called eagerly, alternately, on the
    capture's stream (one scratch, its device header counting both) and
    on the default stream: every result within B5's gate of the plain
    scan."""
    from gsdr_tpu_torch.kernels.iir import iir_filter, iir_kernel
    from gsdr_tpu_torch.utils.compile import compile_step

    b, a = (np.float32(v) for v in IIR_FILTERS["order8"])
    filt = iir_filter(b, a, "cuda")
    compiled = compile_step(lambda zi, x: iir_kernel(x, filt, zi)[::-1])
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    zi = torch.randn(len(b) - 1, generator=g, device="cuda")
    for i in range(6):
        x = torch.randn(1 << 18, generator=g, device="cuda")
        zf, y = compiled(zi, x)
        _iir_check(b, a, x, zi, y, zf)
        stream = compiled._streams[x.device]
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream if i % 2 else
                               torch.cuda.current_stream()):
            x2 = torch.randn(1 << 18 if i % 3 else 5000, generator=g,
                             device="cuda")
            y2, zf2 = iir_kernel(x2, filt, zi)
        torch.cuda.current_stream().wait_stream(stream)
        _iir_check(b, a, x2, zi, y2, zf2)
        zi = zf.clone()


@pytest.mark.cuda
def test_b5_scratch_growth_keeps_the_graph_on_card(card):
    """An eager call on the capture's stream that needs more tiles than
    its scratch holds replaces that scratch; the graph captured before
    holds the old one and its replays stay right."""
    from gsdr_tpu_torch.kernels import iir as tk
    from gsdr_tpu_torch.utils.compile import compile_step

    b, a = (np.float32(v) for v in IIR_FILTERS["bench_biquad"])
    filt = tk.iir_filter(b, a, "cuda")
    compiled = compile_step(lambda zi, x: tk.iir_kernel(x, filt, zi)[::-1])
    zi = torch.zeros(2, device="cuda")
    x = torch.randn(1 << 18, device="cuda")
    zf, y = compiled(zi, x)
    stream = compiled._streams[x.device]
    key = (x.device.index, stream.cuda_stream)
    old = tk._scratch[key]
    graph = next(iter(compiled._graphs.values()))
    assert any(r is old for r in graph.refs)
    big = (old.slots + 1) * tk._geometry().tile
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        xb = torch.randn(big, device="cuda")
        yb, zb = tk.iir_kernel(xb, filt, zi)
    torch.cuda.current_stream().wait_stream(stream)
    assert tk._scratch[key] is not old
    _iir_check(b, a, xb, zi, yb, zb)
    for _ in range(3):
        x = torch.randn(1 << 18, device="cuda")
        zf0 = zf.clone()
        zf, y = compiled(zf0, x)
        _iir_check(b, a, x, zf0, y, zf)


@pytest.mark.cuda
def test_compiled_step_with_a_host_sync_raises_on_card(card):
    """A step that reads a value back to the host cannot be captured: the
    compiled step raises with the capture's error, and runs nothing in its
    place; the card goes on serving other steps."""
    from gsdr_tpu_torch.utils.compile import compile_step

    def step(state, x):
        return state + float(x.sum().item()), x * 2.0

    compiled = compile_step(step)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        compiled(torch.zeros((), device="cuda"), torch.ones(8, device="cuda"))
    assert compiled.graphs == 0
    ok = compile_step(lambda s, x: (s + x.sum(), x * 2.0))
    s, y = ok(torch.zeros((), device="cuda"), torch.ones(8, device="cuda"))
    assert float(s) == 8.0 and torch.equal(y, torch.full((8,), 2.0,
                                                         device="cuda"))


@pytest.mark.cuda
def test_stream_runner_replays_its_graph_on_card(card):
    """StreamRunner on the card compiles its step and stages each block
    straight into the graph's static block: 8 blocks of the flagship give
    the eager step's audio bit for bit, one graph, the runner's block the
    graph's; a replay launches B1 once (torch.profiler)."""
    from gsdr_tpu_torch.runtime import StreamRunner

    step, state0, blocks, _, _ = _compiled_path("flagship")
    runner = StreamRunner(step, state0, block_len=CBLOCK, device="cuda")
    outs = []
    for blk in blocks:
        runner.feed_planar(blk.re.cpu().numpy(), blk.im.cpu().numpy())
        outs.extend(runner.pump())
    _, want = _chained(step, state0, blocks)
    assert all(torch.equal(o, w) for o, w in zip(outs, want))
    assert runner._step.graphs == 1
    static = runner._step.block_buffer(runner.state, blocks[0])
    assert static.re is runner._static.re
    per, _ = _family_records(lambda: runner._step(runner.state, static))
    assert per["fm_chain"] == 1


@pytest.mark.cuda
def test_time_step_times_a_graph_and_an_eager_burst_on_card(card):
    """time_step on the card: a k-step graph by default and the eager
    burst on request, both positive, the graph's no slower than the
    burst by more than the out clone's share."""
    from gsdr_tpu_torch.utils.timing import time_step

    step, state0, blocks, _, _ = _compiled_path("flagship")
    graph = time_step(step, state0, blocks[0], iters=8, reps=3)
    eager = time_step(step, state0, blocks[0], iters=8, reps=3, eager=True)
    assert 0 < graph and 0 < eager
    assert graph <= 1.5 * eager


# ---------------------------------------------------------------------------
# the FM chain's back end in one launch (csrc/fm_chain.cu: the de-emphasis
# start state by a decoupled look-back)
# ---------------------------------------------------------------------------

def _graph_nodes(fn, tmp_path):
    """(nodes, debug dump) of one call of fn() captured as a CUDA graph on
    a stream of its own, after a call there that builds its tables and
    scratch: every kernel launch and memory operation of the call is one
    node. Counts without the profiler."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    # kept, not instantiated: the capture's graph itself is dumped
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    path = tmp_path / "call.dot"
    graph.debug_dump(str(path))
    dot = path.read_text()
    return len(re.findall(r"\bshape\s*=", dot)), dot


@pytest.mark.cuda
@pytest.mark.parametrize("grade", GRADES)
def test_fm_chain_is_one_grid_launch_on_card(card, grade, tmp_path):
    """Every FM chain call is one grid launch of fm_chain_tile, no scan or
    inject launch and no allocation of its own: the CUDA graph of one call
    holds that one node, for B1 in one chunk (16 channels, 64 taps, D=4)
    and chunked (chunks of 24 taps; T=65 < D=256), B2 in one chunk (K=64,
    D=64, 64 channels) and chunked (plan 8 lanes x 8 taps); on the default
    stream the calls reuse the stream's one scratch."""
    from gsdr_tpu_torch.kernels import fm_chain as fk

    m = _model("cuda", 16, 64, 4, precision=grade)
    re_, im_ = _fm_signal(m.channel_frequencies, 8192 + 63, seed=21)
    n0, _, cf, cz = m.init()
    args = (TCA(re_, im_), m.tap_bank, m.lo_table, n0, 4, m.gain, m.deemph,
            cf, cz)
    wide = _f32_dense_run("fm_chain", 1, 65, 256, 65 + 256 * 4095, seed=22,
                          grade=grade)
    pm = _grid_model(FmChannelizer, "pfb", 64, 64, 512, 64, precision=grade,
                     frequency_deviation=75_000.0)
    pargs = _witness_args(pm, 64 * 256)
    runs = [lambda: fm_chain(*args, precision=grade),
            lambda: fm_chain(*args, precision=grade, chunk=24),
            lambda: wide(None),
            lambda: pfb_fm_chain(*pargs, precision=grade),
            lambda: pfb_fm_chain(*pargs, precision=grade, plan=(8, 8))]
    for run in runs:
        nodes, dot = _graph_nodes(run, tmp_path)
        assert nodes == 1 and "fm_chain_tile" in dot, dot[:2000]
    key = (torch.cuda.current_device(),
           torch.cuda.current_stream().cuda_stream)
    for run in runs:
        run()
    scr = fk._scratches.by_stream[key]
    for run in runs:
        run()
    torch.cuda.synchronize()
    assert fk._scratches.by_stream[key] is scr


@pytest.mark.cuda
@pytest.mark.parametrize("grade", ["bf16x3", "bf16x2"])
@pytest.mark.parametrize("c", [1, 3, 5, 8])
def test_fm_narrow_one_chunk_blocks_bit_equal_on_card(card, grade, c):
    """The one-chunk bf16 block the planner takes at C <= 8 (4 channels up
    to C = 4, 8 up to 8: fm_chain.cu's one_chunk_channels) equals launches
    forced to 16 channels, and to 8 at C <= 4, bit for bit, audio and
    carries: each output column's mma.sync sum is independent of the
    block's others, and the back end walks each channel alike. T = 65,
    D = 4 (fm_demod's bank at C = 1), a de-emphasis whose a^255 is 0."""
    t, d, n = 65, 4, 65 + 4 * 8191
    m = _model("cuda", c, t, d, precision=grade)
    tc, ch, rows = dense_block("fm_chain", "cuda", t, d, grade, c,
                               (n - t) // d + 1)
    assert (tc, ch, rows) == (t, 4 if c <= 4 else 8, 256)
    re, im = _fm_signal(m.channel_frequencies, n, seed=30 + c)
    n0, _, cf, cz = m.init()
    deemph = torch.tensor([0.5, 0.25, 0.5], device="cuda")
    args = (TCA(re, im), m.tap_bank, m.lo_table, n0, d, m.gain, deemph, cf,
            torch.full_like(cz, 0.3))
    want = _flat(fm_chain(*args, precision=grade))
    for forced in (16,) + ((8,) if c <= 4 else ()):
        got = _flat(fm_chain(*args, precision=grade, channels=forced))
        for a, b in zip(got, want):
            assert torch.equal(a, b), (c, forced)


@pytest.mark.cuda
@pytest.mark.parametrize("grade", GRADES)
def test_fm_look_back_stress_on_card(card, grade):
    """a = 0.999 (a^255 ~ 0.77: a look-back stops only at an inclusive
    state or tile -1) over many tiles: B1 at 16 channels over 2^22 samples
    (4112 tiles) and B2 at 64 channels, two blocks of 32 a tile, over 2^20
    samples at D=8 (515 tiles; at the bf16 grades also chunked in blocks
    of 64 rows, 2081 tiles of 63 new outputs), zi != 0: held to the plain
    chain at the grade, audio within 1e-4 of max|audio| past the warm-up's
    first 16384 outputs (64 tiles of 256), the
    de-emphasis state within 1e-4 max(1, max|audio|), the discriminator's
    carry within 1e-4; a second call on the same inputs is bit-equal."""
    deemph = torch.tensor([5e-4, 5e-4, 0.999], device="cuda")
    m = _model("cuda", 16, 64, 4, precision=grade)
    re, im = _fm_signal(m.channel_frequencies, (1 << 22) + 63, seed=31)
    n0, _, cf, cz = m.init()
    zi = torch.linspace(-0.4, 0.4, 16, device="cuda")[:, None].contiguous()
    dense = (fm_chain, fm_chain_reference,
             (TCA(re, im), m.tap_bank, m.lo_table, n0, 4, m.gain, deemph,
              cf, zi))
    # 1-kHz deviation keeps every step of the carriers' phase far from the
    # discriminator's branch cut, where a 2*pi*gain slip would persist
    # through this de-emphasis for thousands of outputs
    pm = _grid_model(FmChannelizer, "pfb", 64, 8, 512, 64, precision=grade,
                     frequency_deviation=1_000.0)
    pargs = list(_witness_args(pm, 1 << 20))
    pargs[-1] = torch.linspace(-0.4, 0.4, 64,
                               device="cuda")[:, None].contiguous()
    pargs[-3] = deemph
    pfb = (pfb_fm_chain, pfb_fm_chain_reference, tuple(pargs))
    runs = [dense + ({},), pfb + ({},)]
    if grade != "f32":
        runs.append(pfb + ({"plan": (8, 8), "rows": 64},))
    for kernel, plain, a, kw in runs:
        got = kernel(*a, precision=grade, **kw)
        again = kernel(*a, precision=grade, **kw)
        want = plain(*a, precision=grade)
        torch.cuda.synchronize()
        for x, y in zip(_flat(got), _flat(again)):
            assert torch.equal(x, y), kernel.name
        # past the first 16384 outputs: the zero-primed warm-up puts a few
        # samples on the discriminator's branch cut, where kernel and plain
        # version may slip by 2*pi*gain apart, and at a = 0.999 such a slip
        # decays over thousands of outputs (a^16384 ~ 8e-8)
        scale = float(want[0][:, 16384:].abs().max())
        err = float((got[0] - want[0])[:, 16384:].abs().max())
        assert err <= 1e-4 * scale, (kernel.name, err, scale)
        assert float((got[2] - want[2]).abs().max()) <= \
            1e-4 * max(1.0, scale)
        for x, y in ((got[1].re, want[1].re), (got[1].im, want[1].im)):
            assert float((x - y).abs().max()) <= 1e-4
