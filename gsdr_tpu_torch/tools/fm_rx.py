"""FM receiver command line: an IQ recording in, multi-channel audio out.

    python -m gsdr_tpu_torch.tools.fm_rx input.iq --fs 1e6 \
        --channels 100e3,250e3 --deviation 75e3 --decim 8 --format int8 \
        -o audio.f32 [--device cpu]

Counterpart of ``gsdr_tpu/tools/fm_rx.py``, with the same arguments,
defaults and output, and ``--device`` (default cuda). Output: float32
audio, the channels interleaved per decimated frame (C floats a frame).
``--audio-rate`` resamples the audio through a stateful rational
resampler; ``--save-state`` and ``--load-state`` checkpoint and resume the
stream (``utils/checkpoint.py``, files that the JAX package's tool reads
and writes too).
"""

import argparse
import sys
from fractions import Fraction

import numpy as np

from gsdr_tpu_torch.ops.resample import ResampleStream
from gsdr_tpu_torch.pipelines import FmChannelizer
from gsdr_tpu_torch.runtime import IqFileSource, StreamRunner
from gsdr_tpu_torch.utils.checkpoint import load_state, save_state


def design_lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("input", help="IQ recording path")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--fs", type=float, required=True, help="sample rate Hz")
    p.add_argument("--tuning", type=float, default=0.0,
                   help="center frequency the recording is tuned to")
    p.add_argument("--channels", required=True,
                   help="comma-separated channel frequencies (Hz)")
    p.add_argument("--deviation", type=float, default=75e3)
    p.add_argument("--decim", type=int, default=8)
    p.add_argument("--taps", type=int, default=129)
    p.add_argument("--cutoff", type=float, default=None,
                   help="low-pass cutoff as fraction of Fs (default: "
                        "0.4/decim)")
    p.add_argument("--tau", type=float, default=75e-6,
                   help="de-emphasis time constant (75e-6 US, 50e-6 EU)")
    p.add_argument("--format", default="int8",
                   choices=["int8", "int16", "float32"])
    p.add_argument("--block", type=int, default=1 << 17)
    p.add_argument("--audio-rate", type=float, default=None,
                   help="resample audio to this rate (rational polyphase "
                        "resampler, e.g. 48000)")
    p.add_argument("--save-state", default=None)
    p.add_argument("--load-state", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the receiver (default cuda)")
    args = p.parse_args(argv)

    chans = tuple(float(c) for c in args.channels.split(","))
    cutoff = args.cutoff if args.cutoff is not None else 0.4 / args.decim
    model = FmChannelizer(
        sample_rate=args.fs,
        tuning_frequency=args.tuning,
        channel_frequencies=chans,
        frequency_deviation=args.deviation,
        decimation=args.decim,
        low_pass_taps=design_lowpass(args.taps, cutoff),
        deemphasis_tau=args.tau,
        device=args.device,
    )
    state = model.init()
    if args.load_state:
        state = load_state(args.load_state, state)

    resamp = None
    if args.audio_rate:
        frac = Fraction(int(round(args.audio_rate)),
                        int(round(model.audio_rate))).limit_denominator(512)
        l_up, m_down = frac.numerator, frac.denominator
        # stateful: the carried input tail joins the blocks seamlessly
        rs = ResampleStream(l_up, m_down)
        rs_state = None

        def resamp(audio):
            nonlocal rs_state
            if rs_state is None:
                rs_state = rs.init(audio)
            rs_state, out = rs.step(rs_state, audio)
            return out

        print(f"resampling audio {model.audio_rate:.0f} -> "
              f"{model.audio_rate * l_up / m_down:.0f} Hz (L/M = "
              f"{l_up}/{m_down})", file=sys.stderr)

    runner = StreamRunner(model.step, state, block_len=args.block,
                          device=args.device)
    src = IqFileSource(args.input, fmt=args.format, chunk_samples=args.block)
    frames = 0
    try:
        with open(args.output, "wb") as out:
            while True:
                chunk = src.read_planar()
                if chunk is None:
                    break
                runner.feed_planar(*chunk)
                for audio in runner.pump():
                    if resamp is not None:
                        audio = resamp(audio)
                    a = audio.cpu().numpy()  # (C, L)
                    out.write(np.ascontiguousarray(a.T, np.float32).tobytes())
                    frames += a.shape[1]
    finally:
        src.close()
    if args.save_state:
        save_state(args.save_state, runner.state)
    print(f"wrote {frames} frames x {model.num_channels} channels "
          f"at {model.audio_rate:.0f} Hz to {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
