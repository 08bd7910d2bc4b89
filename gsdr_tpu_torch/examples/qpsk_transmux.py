"""Example: channelized QPSK digital link (a transmultiplexer) on the port.

Counterpart of ``examples/qpsk_transmux.py``. K independent QPSK symbol
streams become one wideband stream through the PFB synthesis bank (each
channel's symbols are its baseband at Fs/K; the prototype shapes the
pulses), cross an AWGN channel and come back through the analysis bank,
which on the card runs the channelizer kernel for K <= 32. A one-tap
equalizer per channel, a least-squares complex gain from known pilot
symbols, precedes the QPSK decisions. Both banks stream block by block
with their tails carried, so a block split gives the one-shot link.

Run from the repository root (``--cpu`` runs the plain versions):

    python -m gsdr_tpu_torch.examples.qpsk_transmux [--cpu]
"""

import sys

import numpy as np
import torch

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.ops.pfb import pfb_channelize_block, pfb_synthesize_block
from gsdr_tpu_torch.ops.qpsk import qpsk_modulate_symbols


def lowpass(num_taps, cutoff_frac):
    """Hamming-windowed sinc low-pass with unit DC gain, float64."""
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return h / h.sum()


def transmit(tx, taps, k, blocks=1):
    """Planar channel streams (K, M) -> ``blocks`` wideband planar blocks of
    M*K/blocks samples, streamed through ``pfb_synthesize_block``."""
    m = tx.shape[-1]
    if m % blocks:
        raise ValueError(f"{m} frames do not split into {blocks} blocks")
    step = m // blocks
    tail, out = None, []
    for b in range(blocks):
        wide, tail = pfb_synthesize_block(tx[..., b * step:(b + 1) * step],
                                          taps, k, tail=tail)
        out.append(wide)
    return out


def awgn(blocks, snr_db, generator):
    """Complex white Gaussian noise at ``snr_db`` below the blocks' mean
    power, drawn from ``generator``, added to every block."""
    p_sig = sum(float(torch.mean(b.re * b.re + b.im * b.im)) for b in blocks)
    sigma = (p_sig / len(blocks) / 10.0 ** (snr_db / 10.0) / 2.0) ** 0.5

    def noise(like):
        return sigma * torch.randn(like.shape, generator=generator,
                                   dtype=torch.float32, device=like.device)

    return [ComplexArray(b.re + noise(b.re), b.im + noise(b.im))
            for b in blocks]


def receive(blocks, taps, k, impl="auto"):
    """Wideband blocks -> planar channel outputs (K, frames), streamed
    through ``pfb_channelize_block``. The stream's first Q-1 frames read
    the zero-primed tail; they are dropped, so that the frames line up
    with the one-shot ``pfb_channelize`` of the joined blocks."""
    tail, outs = None, []
    for rf in blocks:
        y, tail = pfb_channelize_block(rf, taps, k, tail=tail, impl=impl)
        outs.append(y)
    warm = -(-len(taps) // k) - 1
    return ComplexArray(torch.cat([y.re for y in outs], dim=-1)[..., warm:],
                        torch.cat([y.im for y in outs], dim=-1)[..., warm:])


def equalize(y, tx, q, n_pilots=256):
    """(z, ref): the equalized channel outputs and the symbols they carry,
    complex128 (K, span) on the outputs' device, as examples/
    qpsk_transmux.py forms them from channel outputs ``y`` and the sent
    symbols ``tx`` (both planar (K, .)): the frame delay from channel 0's
    pilot correlation, then per channel y / g with the one-tap gain
    g = <ref, y>/<ref, ref> over the first ``n_pilots`` symbols."""
    yc = torch.complex(y.re.double(), y.im.double())
    s = torch.complex(tx.re.double(), tx.im.double())
    m_syms = s.shape[1]
    best = (0, -1.0)
    for d in range(0, 2 * q):
        span = min(yc.shape[1], m_syms - d) - 4
        c0 = abs(complex(torch.vdot(s[0, d:d + n_pilots], yc[0, :n_pilots])))
        if c0 > best[1]:
            best = (d, c0)
        if span <= n_pilots:
            break
    d = best[0]
    span = min(yc.shape[1], m_syms - d) - 4
    ref = s[:, d:d + span]
    yy = yc[:, :span]
    # torch.vdot conjugates its first argument, as np.vdot does: no extra
    # conjugate, which would double any channel phase
    pil = ref[:, :n_pilots]
    g = (pil.conj() * yy[:, :n_pilots]).sum(-1) / (pil.abs() ** 2).sum(-1)
    return yy / g[:, None], ref


def decide(z):
    """QPSK quadrant decisions of complex samples, as 2-bit values."""
    return (z.real < 0).to(torch.int32) + 2 * (z.imag < 0).to(torch.int32)


def link_quality(y, tx, q, n_pilots=256):
    """(per-channel SER, per-channel EVM, symbols compared) of channel
    outputs ``y`` against the sent symbols ``tx``, after ``equalize``."""
    z, ref = equalize(y, tx, q, n_pilots)
    evm = torch.sqrt(torch.mean((z - ref).abs() ** 2, dim=-1)
                     / torch.mean(ref.abs() ** 2, dim=-1))
    ser = (decide(z) != decide(ref)).double().mean(dim=-1)
    return ser.cpu().numpy(), evm.cpu().numpy(), ref.numel()


def run_transmux(k, m_syms, snr_db=25.0, q=8, n_pilots=256, seed=0,
                 blocks=1, device="cuda"):
    """K QPSK streams of m_syms symbols -> synthesize -> AWGN -> channelize
    -> equalize, in ``blocks`` streamed blocks, every draw from one
    ``torch.Generator`` seeded with ``seed``. Returns (per-channel SER,
    per-channel EVM, symbols compared)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    taps = lowpass(q * k, 0.5 / k)
    syms = torch.randint(0, 4, (k, m_syms), generator=gen, device=device,
                         dtype=torch.int32)
    tx = qpsk_modulate_symbols(syms, 1.0)
    rx = awgn(transmit(tx, taps, k, blocks), snr_db, gen)
    return link_quality(receive(rx, taps, k), tx, q, n_pilots)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else "cuda"
    k, m = 64, 4096
    sers, evms, tot = run_transmux(k, m, snr_db=25.0, device=device)
    print(f"transmux: {k} QPSK channels x {m} symbols, 25 dB AWGN, {device}")
    print(f"  EVM mean {evms.mean():.3f} max {evms.max():.3f}")
    print(f"  SER mean {sers.mean():.2e} worst {sers.max():.2e} "
          f"({tot} symbols)")
    # EVM ~0.24 is the critical cascade's own inter-symbol interference,
    # well inside QPSK's 0.707 decision margin, hence SER 0
    ok = sers.max() < 1e-3 and evms.max() < 0.3
    print("link ok" if ok else "LINK FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
