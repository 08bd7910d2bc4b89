"""The CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU and nvcc; elsewhere every test here skips. Imports
only the port, so it runs on a machine without JAX:
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels.fm_chain import fm_chain
from gsdr_tpu_torch.pipelines import FmChannelizer

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
