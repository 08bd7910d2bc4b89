"""The CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU and nvcc; elsewhere every test here skips. Imports
only the port, so it runs on a machine without JAX:
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels.am_chain import am_chain, pfb_am_chain
from gsdr_tpu_torch.kernels.chain import front_supported
from gsdr_tpu_torch.kernels.fm_chain import fm_chain, pfb_fm_chain
from gsdr_tpu_torch.pipelines import AmReceiver, FmChannelizer

FS = 1_000_000.0
SKIP = 256  # zero-primed warm-up outputs


def _model(impl, num_channels, num_taps, decimation):
    k = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * 0.03 * k) * np.hamming(num_taps)
    return FmChannelizer(
        sample_rate=FS, tuning_frequency=0.0,
        channel_frequencies=tuple(-480_000.0 + 60_000.0 * i
                                  for i in range(num_channels)),
        frequency_deviation=75_000.0, decimation=decimation,
        low_pass_taps=tuple(h / h.sum()), impl=impl, device="cuda")


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
    kern = _grid_model(FmChannelizer, "pfb", k, d, t, c, **kw)
    plain = _grid_model(FmChannelizer, "pfb_torch", k, d, t, c, **kw)
    dense_fits = front_supported("fm_chain", "cuda", t, d)
    dense = _grid_model(FmChannelizer, "cuda" if dense_fits else "torch",
                        k, d, t, c, **kw)
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
    model = _grid_model(FmChannelizer, "auto", 64, 64, 512, 64,
                        frequency_deviation=75_000.0)
    assert model.front == "pfb"
    before = (fm_chain.launches, pfb_fm_chain.launches)
    re, im = _grid_fm_signal(model.channel_frequencies, 64 * 512, seed=2)
    model.step(model.init(), TCA(re, im))
    assert (fm_chain.launches, pfb_fm_chain.launches) == \
        (before[0], before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,t,c", PFB_GEOMETRIES)
def test_am_kernels_match_plain_on_card(card, k, d, t, c):
    """B3 on both fronts against the plain chains and each other, over two
    streamed blocks: envelopes within 1e-5."""
    dense_fits = front_supported("am_chain", "cuda", t, d)
    models = {impl: _grid_model(AmReceiver, impl, k, d, t, c)
              for impl in ("pfb", "pfb_torch", "torch")}
    models["cuda"] = _grid_model(AmReceiver, "cuda" if dense_fits else "torch",
                                 k, d, t, c)
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
    """B3-dense at the 8-channel, T=32, D=4 shape, off any preferred grid,
    where 'auto' takes the dense front."""
    n_ = np.arange(32) - 15.5
    h = np.sinc(2 * 0.04 * n_) * np.hamming(32)
    kw = dict(sample_rate=FS, tuning_frequency=100_000_000.0,
              channel_frequencies=tuple(100_000_000.0 - 200_000.0 + 50_000.0 * i
                                        for i in range(8)),
              decimation=4, low_pass_taps=tuple(h / h.sum()), device="cuda")
    auto, plain = AmReceiver(impl="auto", **kw), AmReceiver(impl="torch", **kw)
    assert auto.front == "toeplitz"
    re, im = _am_signal([f - 100_000_000.0 for f in kw["channel_frequencies"]],
                        40_000, seed=1)
    before = am_chain.launches
    _, ya = auto.step(auto.init(), TCA(re, im))
    _, yp = plain.step(plain.init(), TCA(re, im))
    assert am_chain.launches == before + 1
    torch.testing.assert_close(ya, yp, rtol=0, atol=1e-5)
