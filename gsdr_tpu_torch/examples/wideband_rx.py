"""Example: a 32-channel wideband uniform-grid FM receiver.

Counterpart of ``examples/wideband_rx.py``. Synthesizes a capture with an
FM carrier on every channel of a uniform Fs/32 grid and runs one block of
FmChannelizer at critical decimation with a 256-tap prototype (Q = 8 grid
periods). On the card impl='auto' takes the PFB-front kernel where the
grid rule holds (``--pfb`` forces it); with ``--cpu`` the plain chain
runs. Every channel's recovered tone is checked.

Run from the repository root:

    python -m gsdr_tpu_torch.examples.wideband_rx [--cpu] [--pfb]
"""

import argparse

import numpy as np

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.pipelines import FmChannelizer


def lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true",
                   help="run the plain chain on the CPU")
    p.add_argument("--pfb", action="store_true",
                   help="force the PFB front (impl='pfb')")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    fs = 2_048_000.0
    k = 32                           # channels on the Fs/K grid
    dec = k                          # critically sampled
    taps = lowpass(8 * k, 0.4 / k)   # Q = 8 grid periods
    deviation = 12_000.0
    n = 1 << 18

    channels = tuple(-fs / 2 + (fs / k) * c for c in range(k))
    tones = tuple(300.0 + 83.0 * c for c in range(k))

    model = FmChannelizer(
        sample_rate=fs, tuning_frequency=0.0,
        channel_frequencies=channels, frequency_deviation=deviation,
        decimation=dec, low_pass_taps=taps,
        impl="pfb" if args.pfb else "auto", device=device)

    t = np.arange(n) / fs
    rf = np.zeros(n, np.complex128)
    rng = np.random.default_rng(0)
    for f, tone in zip(channels, tones):
        msg = np.sin(2 * np.pi * tone * t + rng.uniform(0, 6))
        rf += (1.0 / k) * np.exp(
            1j * (2 * np.pi * f * t + (deviation / tone) * msg))
    block = ComplexArray.from_complex(rf.astype(np.complex64), device=device)

    _, audio = model.step(model.init(), block)
    audio = audio.cpu().numpy()
    print(f"audio: {audio.shape} at {fs / dec:.0f} Hz/channel "
          f"(impl={model.impl}, front={model.front}, {device})")

    ok = True
    arate = fs / dec
    for c, tone in enumerate(tones):
        a = audio[c, 256:] - np.mean(audio[c, 256:])
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        peak = np.argmax(spec) * arate / len(a)
        good = abs(peak - tone) < arate / len(a) * 2
        ok &= good
        if c % 8 == 0 or not good:
            print(f"  ch {c:2d} ({channels[c] / 1e3:+8.1f} kHz): "
                  f"tone {peak:7.1f} Hz (want {tone:7.1f}) "
                  f"{'ok' if good else 'MISS'}")
    print("all channels recovered" if ok else "RECOVERY FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
