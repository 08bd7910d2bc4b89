"""Example: a three-station FM broadcast receiver from a synthetic capture.

Counterpart of ``examples/fm_broadcast_rx.py``. Synthesizes a wideband
capture with three FM stations, streams it through FmChannelizer in
blocks (the fused FM-chain kernel on the card, the plain chain with
``--cpu``), reports each station's recovered tone, and checkpoints the
stream state to a temporary file, checking that it loads back bit for
bit.

Run from the repository root:

    python -m gsdr_tpu_torch.examples.fm_broadcast_rx [--cpu]
"""

import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.pipelines import FmChannelizer
from gsdr_tpu_torch.utils.checkpoint import (
    flatten_with_keys,
    load_state,
    save_state,
)


def lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true",
                   help="run the plain chain on the CPU")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    fs = 2_000_000.0
    stations = (-400_000.0, 0.0, 500_000.0)   # baseband offsets
    tones = (440.0, 1000.0, 2500.0)
    deviation = 75_000.0
    n = 1 << 18

    t = np.arange(n) / fs
    rf = np.zeros(n, np.complex128)
    for f0, tone in zip(stations, tones):
        phase = 2 * np.pi * f0 * t + (deviation / tone) * (1 - np.cos(
            2 * np.pi * tone * t))
        rf += 0.3 * np.exp(1j * phase)
    rf = ComplexArray.from_complex(rf.astype(np.complex64), device=device)

    model = FmChannelizer(
        sample_rate=fs, tuning_frequency=0.0,
        channel_frequencies=stations, frequency_deviation=deviation,
        decimation=8, low_pass_taps=lowpass(128, 0.05), device=device)
    state = model.init()
    block = 1 << 16
    audio_blocks = []
    for i in range(n // block):
        state, audio = model.step(state, rf[..., i * block:(i + 1) * block])
        audio_blocks.append(audio)
    audio = torch.cat(audio_blocks, dim=-1).cpu().numpy()

    ok = True
    arate = fs / model.decimation
    for c, want in enumerate(tones):
        a = audio[c][500:] - audio[c][500:].mean()
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        peak = (np.argmax(spec[5:]) + 5) * arate / len(a)
        good = abs(peak - want) < 2 * arate / len(a)
        ok &= good
        print(f"station {c} @ {stations[c] / 1e3:+.0f} kHz: tone "
              f"{peak:.1f} Hz (expected {want}) {'ok' if good else 'MISS'}")

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "fm_rx_state.npz"
        save_state(path, state)
        back = load_state(path, model.init())
        same = all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                   for (_, a), (_, b) in zip(flatten_with_keys(state),
                                             flatten_with_keys(back)))
        print(f"stream state checkpointed to {path}: "
              f"{'reloads bit-exactly' if same else 'RELOAD DIFFERS'}")
    ok &= same
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
