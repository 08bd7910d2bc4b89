"""The plain receivers against a direct float64 NumPy computation at a
tiny size, and against the port's own plain chains (the yardstick and
the program agree where both are exact to float32)."""

import math

import numpy as np
import pytest
import torch

from conftest import TINY_AM, TINY_CAPTURE, TINY_FM
from sdr_bench.kinds import channel_receiver as kind
from sdr_bench.reference import am_receiver, channel, fm_receiver

N = 1024
BLOCKS = 6
SEED = 2**33 + 17


def _ring(cfg):
    return kind.make_ring(cfg, TINY_CAPTURE, N, SEED, "cpu")


def _direct_channels(x, design, stop):
    """(C, outputs) of the channel stage from stream index 0 to ``stop``
    (zero history before the stream), every sum and phase in float64:
    y_c[j] = sum_t h[t] x[g+t] e^{2 pi i s_c (g+t)/Fs}, g = jD - (T-1)."""
    h = np.asarray(design["taps"], np.float64)
    t_len, d = h.size, design["decimation"]
    fs = design["sample_rate"]
    xp = np.concatenate([np.zeros(t_len - 1, complex), x[:stop]])
    n = np.arange(-(t_len - 1), stop)
    out = []
    for f in design["channel_frequencies"]:
        shift = design["tuning_frequency"] - f
        mixed = xp * np.exp(2j * np.pi * shift * n / fs)
        m = (xp.size - t_len) // d + 1
        out.append([np.dot(h, mixed[j * d:j * d + t_len]) for j in range(m)])
    return np.asarray(out)


def _direct_fm(y, design):
    fs = design["sample_rate"]
    gain = fs / (2 * math.pi * design["frequency_deviation"])
    prev = np.concatenate([np.zeros((y.shape[0], 1)), y[:, :-1]], axis=1)
    d = gain * np.angle(y * np.conj(prev))
    k = math.tan(1 / (2 * design["deemphasis_tau"] * fs
                      / design["decimation"]))
    b0, a1 = k / (1 + k), (k - 1) / (k + 1)
    out = np.zeros_like(d)
    for j in range(d.shape[1]):
        out[:, j] = b0 * d[:, j] + (b0 * d[:, j - 1] - a1 * out[:, j - 1]
                                    if j else 0.0)
    return out


@pytest.mark.parametrize("cfg", [TINY_FM, TINY_AM], ids=["fm", "am"])
def test_reference_matches_direct_float64(cfg):
    design = kind.design(cfg)
    ring = _ring(cfg)
    flat = kind.ring_samples(ring, 0, BLOCKS * N).numpy()
    d, t_len = design["decimation"], cfg["num_taps"]
    y = _direct_channels(flat, design, BLOCKS * N)
    want = _direct_fm(y, design) if cfg["modulation"] == "fm" \
        else 2 * np.clip(np.abs(y), 0, 1) - 1
    ref = fm_receiver if cfg["modulation"] == "fm" else am_receiver
    warm = ref.warm_outputs(design)
    for b in (3, BLOCKS - 1):
        s = b * N
        x = kind.ring_samples(ring, s - (t_len - 1) - warm * d, s + N)
        got = ref.receive(x, design, s, N)
        cols = slice(s // d, (s + N) // d)
        scale = np.abs(want[:, cols]).max()
        assert np.abs(got["audio"] - want[:, cols]).max() <= 1e-9 * scale
        if cfg["modulation"] == "fm":
            last = y[:, (s + N) // d - 1]
            assert np.abs(got["carry"] - last).max() <= 1e-12 * np.abs(
                last).max()


def test_channel_stage_block_relative_phase():
    """Outputs before the block take the earlier block's counter: the
    stage from a warm start equals the previous block's own outputs."""
    cfg = dict(TINY_FM, sample_rate=64000.0)
    design = kind.design(cfg)
    ring = _ring(cfg)
    d, t_len = design["decimation"], cfg["num_taps"]
    s, warm = 4 * N, 40
    x = kind.ring_samples(ring, s - (t_len - 1) - warm * d, s + N)
    ahead = channel.stage(x, design, s, warm, N)
    prev = channel.stage(kind.ring_samples(ring, s - N - (t_len - 1), s),
                         design, s - N, 0, N)
    assert torch.allclose(ahead[:, :warm], prev[:, -warm:], rtol=0,
                          atol=1e-13)


@pytest.mark.parametrize("cfg", [TINY_FM, TINY_AM], ids=["fm", "am"])
def test_reference_matches_the_ports_plain_chain(cfg):
    """The port's plain PFB chain (float32) against the plain receiver
    (float64), block after block with the state carried."""
    from gsdr_tpu_torch.carray import ComplexArray
    from gsdr_tpu_torch.pipelines.am_radio import AmReceiver
    from gsdr_tpu_torch.pipelines.fm_radio import FmChannelizer

    design = kind.design(cfg)
    ring = _ring(cfg)
    taps = tuple(float(h) for h in design["taps"])
    if cfg["modulation"] == "fm":
        model = FmChannelizer(
            design["sample_rate"], 0.0, design["channel_frequencies"],
            cfg["frequency_deviation"], cfg["decimation"], taps,
            cfg["deemphasis_tau"], impl="pfb_torch", device="cpu")
        ref = fm_receiver
    else:
        model = AmReceiver(design["sample_rate"], 0.0,
                           design["channel_frequencies"], cfg["decimation"],
                           taps, impl="pfb_torch", device="cpu")
        ref = am_receiver
    state = model.init()
    r = ring[0].shape[0]
    for b in range(BLOCKS):
        state, audio = model.step(state, ComplexArray(ring[0][b % r],
                                                      ring[1][b % r]))
    s, d, t_len = (BLOCKS - 1) * N, cfg["decimation"], cfg["num_taps"]
    x = kind.ring_samples(ring, s - (t_len - 1)
                           - ref.warm_outputs(design) * d, s + N)
    want = ref.receive(x, design, s, N)
    err = np.abs(audio.double().numpy() - want["audio"]).max()
    assert err <= 2e-6 * max(1.0, np.abs(want["audio"]).max())
