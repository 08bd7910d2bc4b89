"""Example: wideband TX -> channel -> RX duplex loopback.

Counterpart of ``examples/wideband_duplex.py``. The transmitter puts K
per-channel FM basebands into one wideband stream with the PFB synthesis
bank (``pfb_synthesize``); the stream crosses an AWGN channel; the
receiver is FmChannelizer at critical decimation on the Fs/K grid, which
on the card takes the PFB-front kernel through impl='auto' (``--pfb``
forces it; ``--cpu`` runs the plain chain). Each channel's audio must
peak at its message tone and fit it by least squares above an SNR bound.

Run from the repository root:

    python -m gsdr_tpu_torch.examples.wideband_duplex [--cpu] [--pfb]
"""

import argparse

import numpy as np

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.ops.pfb import pfb_synthesize
from gsdr_tpu_torch.pipelines import FmChannelizer


def lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return (h / h.sum()).astype(np.float64)


def run_duplex(fs, k, m_frames, impl, snr_db=30.0, q_syn=8, q_rx=8, seed=0,
               device="cuda"):
    """K FM channels -> synthesis -> AWGN -> channelize and demodulate.
    Returns (tones, audio (K, M), per-channel audio SNR dB, peak-ok
    bools, the receiver)."""
    fs_ch = fs / k
    deviation = 0.25 * fs_ch / 2.0
    tones = tuple(300.0 + 83.0 * c for c in range(k))
    rng = np.random.default_rng(seed)

    # TX: per-channel FM basebands at the channel rate
    mm = np.arange(m_frames) / fs_ch
    basebands = np.zeros((k, m_frames), np.complex128)
    for c, tone in enumerate(tones):
        msg = np.sin(2 * np.pi * tone * mm + rng.uniform(0, 6))
        phase = 2 * np.pi * (deviation / fs_ch) * np.cumsum(msg)
        basebands[c] = (1.0 / k) * np.exp(1j * phase)
    chans = ComplexArray.from_complex(basebands.astype(np.complex64),
                                      device=device)
    wide = pfb_synthesize(chans, lowpass(q_syn * k, 0.4 / k), k)

    # channel: AWGN at snr_db below the wideband signal's power
    wide_np = wide.to_numpy()
    p_sig = float(np.mean(np.abs(wide_np) ** 2))
    sigma = np.sqrt(p_sig / (10.0 ** (snr_db / 10.0)) / 2.0)
    noisy = wide_np + sigma * (rng.standard_normal(wide_np.shape)
                               + 1j * rng.standard_normal(wide_np.shape))
    rf = ComplexArray.from_complex(noisy.astype(np.complex64), device=device)

    # RX: the uniform-grid FM channelizer
    channels = tuple(c * fs / k if c < k / 2 else c * fs / k - fs
                     for c in range(k))
    model = FmChannelizer(
        sample_rate=fs, tuning_frequency=0.0,
        channel_frequencies=channels, frequency_deviation=deviation,
        decimation=k, low_pass_taps=tuple(lowpass(q_rx * k, 0.4 / k)),
        impl=impl, device=device)
    _, audio = model.step(model.init(), rf)
    audio = audio.cpu().numpy()

    # verify: FFT peak at the tone and the least-squares audio SNR
    skip = max(q_syn, q_rx) * 2 + 256   # filter transients, de-emphasis
    snrs, peaks_ok = [], []
    for c, tone in enumerate(tones):
        a = audio[c, skip:] - np.mean(audio[c, skip:])
        idx = np.arange(len(a)) / fs_ch
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        peak = np.argmax(spec) * fs_ch / len(a)
        peaks_ok.append(bool(abs(peak - tone) < 2 * fs_ch / len(a)))
        basis = np.stack([np.sin(2 * np.pi * tone * idx),
                          np.cos(2 * np.pi * tone * idx)], axis=1)
        coef, *_ = np.linalg.lstsq(basis, a, rcond=None)
        fit = basis @ coef
        resid = a - fit
        snrs.append(10.0 * np.log10(
            np.sum(fit ** 2) / max(np.sum(resid ** 2), 1e-30)))
    return tones, audio, np.asarray(snrs), peaks_ok, model


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true",
                   help="run the plain chain on the CPU")
    p.add_argument("--pfb", action="store_true",
                   help="force the PFB front (impl='pfb')")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    fs, k = 2_048_000.0, 32
    impl = "pfb" if args.pfb else "auto"
    tones, audio, snrs, peaks_ok, model = run_duplex(
        fs, k, m_frames=8192, impl=impl, snr_db=30.0, device=device)
    print(f"audio: {audio.shape} at {fs / k:.0f} Hz/channel (impl={impl}, "
          f"front={model.front}, {device})")
    ok = True
    for c, tone in enumerate(tones):
        good = peaks_ok[c] and snrs[c] > 15.0
        ok &= good
        if c % 8 == 0 or not good:
            print(f"  ch {c:2d}: tone {tone:7.1f} Hz "
                  f"{'found' if peaks_ok[c] else 'MISSED'}, "
                  f"audio SNR {snrs[c]:5.1f} dB {'ok' if good else 'FAIL'}")
    print(f"duplex loopback: {'all channels recovered' if ok else 'FAILED'}"
          f" (min SNR {snrs.min():.1f} dB)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
