"""The benchmark's side of a channelizing receiver (FM or AM): what both
sides are handed, the seeded capture, and the numbers of the comparison.

A kind module gives the harness four things, by these names:

  - ``design(cfg)``: what the program and the plain receiver are both
    handed (here the low-pass taps, the channel list and the scalar
    parameters);
  - ``block_samples(cfg, traffic)``: the samples of one block;
  - ``make_ring(cfg, traffic, n, seed, device)``: the ring of distinct
    blocks, a tuple of (R, n) planes that the entry's ``block`` takes;
  - ``compare(cfg, design, reference, ring, n, outputs, final, total)``:
    ({number: value}, blocks that failed), each number held to the
    configuration's ``limits``.

The taps are a Hamming-windowed sinc with unit DC gain, rounded to
float32; the receiver is tuned to 0 Hz, so a channel's frequency is its
offset in the capture. Neither side's derived tables come from here.

The capture: one carrier at the centre of every channel, modulated by
its own tone, FM at the configuration's deviation or AM at a depth in
``AM_DEPTH``. Tones (``TONE_HZ``), levels (``LEVEL_DB``) and depths are
one evenly spaced set, dealt to the channels in an order drawn from the
seed, and the phases are drawn, so the same seed gives the same capture
and every seed gives the card the same set of signals. The synthesis runs
in float64 on the device, in chunks, and is stored as planar float32. The
ring holds the mix's ``ring_min_bytes`` or more in whole blocks and is
replayed in order; each tone makes whole cycles over the ring and each
carrier sits on the Fs/K grid, so the replay has no seam.

Numbers compared:

  - ``audio_err``: over the sampled blocks and the last, the largest
    |program - reference| of a block's audio, over the block's largest
    |reference| where the configuration's ``audio_error`` is 'relative',
    else absolute;
  - ``carry_err``, ``zi_err`` (FM): the state after the last block
    against the reference's, the carry over its largest |reference|, the
    de-emphasis state over the last block's largest |audio|;
  - ``tail_mismatch``: samples of the carried input tail that differ
    from the stream's last T - 1 samples (limit 0);
  - ``n0_mismatch``: 1 where the carried sample counter is not the
    stream's length modulo round(Fs) (limit 0).

The reference runs a block at a time from the block's own input: it reads
the ring, never the program's state.
"""

import math

import numpy as np
import torch

TUNING_HZ = 0.0
TONE_HZ = (300.0, 2500.0)       # the voice band
LEVEL_DB = (-6.0, 0.0)
AM_DEPTH = (0.3, 0.6)
_CHUNK_ELEMENTS = 1 << 24       # channels x samples of one synthesis chunk


def lowpass(num_taps, cutoff_hz, sample_rate):
    """(T,) float32 Hamming-windowed-sinc low-pass with unit DC gain."""
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2.0 * cutoff_hz / sample_rate * n) * np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


def channel_frequencies(cfg):
    """``num_channels`` consecutive bins of the Fs/``grid_k`` raster from
    ``first_bin``."""
    step = float(cfg["sample_rate"]) / int(cfg["grid_k"])
    return [TUNING_HZ + (int(cfg["first_bin"]) + i) * step
            for i in range(int(cfg["num_channels"]))]


def design(cfg):
    """A dict of plain Python values and one float32 array."""
    return {
        "sample_rate": float(cfg["sample_rate"]),
        "tuning_frequency": TUNING_HZ,
        "channel_frequencies": channel_frequencies(cfg),
        "decimation": int(cfg["decimation"]),
        "taps": lowpass(int(cfg["num_taps"]), float(cfg["cutoff_hz"]),
                        float(cfg["sample_rate"])),
        "frequency_deviation": cfg.get("frequency_deviation"),
        "deemphasis_tau": cfg.get("deemphasis_tau"),
    }


def block_samples(cfg, traffic):
    """The mix's ``block_samples``, or ``block_ms`` of the configuration's
    rate rounded to whole ``block_multiple``s (a multiple of D and of the
    grid's K)."""
    multiple = int(cfg["block_multiple"])
    if "block_samples" in traffic:
        n = int(traffic["block_samples"])
    else:
        per_ms = float(cfg["sample_rate"]) / 1e3
        n = max(1, round(float(traffic["block_ms"]) * per_ms / multiple)) \
            * multiple
    if n % multiple or n % int(cfg["decimation"]):
        raise ValueError(f"block of {n} samples is no multiple of "
                         f"{multiple} and of D = {cfg['decimation']}")
    return n


def ring_blocks(traffic, n):
    """Blocks in the ring: ``ring_min_bytes`` of planar float32 samples or
    more, and at least two."""
    return max(2, math.ceil(float(traffic["ring_min_bytes"]) / (8 * n)))


def channel_draws(cfg, seed, ring_len):
    """Each channel's tone (whole cycles over the ring), phases, level
    and AM depth, from the seed."""
    c = int(cfg["num_channels"])
    fs = float(cfg["sample_rate"])
    rng = np.random.default_rng(int(seed))

    def dealt(lo, hi):
        return rng.permutation(np.linspace(lo, hi, c))

    tone_hz = dealt(*TONE_HZ)
    cycles = np.maximum(1, np.round(tone_hz * ring_len / fs)).astype(np.int64)
    return {
        "cycles": cycles,
        "tone_hz": cycles * fs / ring_len,
        "tone_phase": rng.uniform(0.0, 2 * math.pi, c),
        "carrier_phase": rng.uniform(0.0, 2 * math.pi, c),
        "level": float(cfg["carrier_amplitude"])
        * 10.0 ** (dealt(*LEVEL_DB) / 20.0),
        "depth": dealt(*AM_DEPTH),
    }


def make_ring(cfg, traffic, n, seed, device):
    """(re, im): (R, n) float32 planes of the ring."""
    r = ring_blocks(traffic, n)
    ring_len = r * n
    draws = channel_draws(cfg, seed, ring_len)
    k = int(cfg["grid_k"])
    c = int(cfg["num_channels"])
    bins = (int(cfg["first_bin"]) + np.arange(c)) % k

    def dev(a, dtype=torch.float64):
        return torch.as_tensor(a, dtype=dtype, device=device)[:, None]

    bins_t, cycles_t = dev(bins, torch.int64), dev(draws["cycles"],
                                                   torch.int64)
    cph, tph = dev(draws["carrier_phase"]), dev(draws["tone_phase"])
    level, depth = dev(draws["level"]), dev(draws["depth"])
    fm = cfg["modulation"] == "fm"
    if fm:
        beta = dev(float(cfg["frequency_deviation"]) / draws["tone_hz"])
    elif cfg["modulation"] != "am":
        raise ValueError(f"modulation {cfg['modulation']!r}: 'fm' or 'am'")
    re = torch.empty(ring_len, dtype=torch.float32, device=device)
    im = torch.empty_like(re)
    chunk = max(1, _CHUNK_ELEMENTS // c)
    for a in range(0, ring_len, chunk):
        idx = torch.arange(a, min(a + chunk, ring_len), dtype=torch.int64,
                           device=device)[None, :]
        carrier = ((bins_t * (idx % k)) % k).double() * (2 * math.pi / k) \
            + cph
        tone = torch.sin(((cycles_t * idx) % ring_len).double()
                         * (2 * math.pi / ring_len) + tph)
        if fm:
            phase, amp = carrier + beta * tone, level
        else:
            phase, amp = carrier, level * (1.0 + depth * tone)
        re[a:a + idx.shape[1]] = (amp * torch.cos(phase)).sum(0)
        im[a:a + idx.shape[1]] = (amp * torch.sin(phase)).sum(0)
    return re.view(r, n), im.view(r, n)


def ring_samples(ring, a, b):
    """complex128 samples [a, b) of the stream that replays the ring."""
    re, im = ring
    flat_re, flat_im = re.reshape(-1), im.reshape(-1)
    idx = torch.arange(a, b, device=re.device) % flat_re.shape[0]
    return torch.complex(flat_re[idx].double(), flat_im[idx].double())


def _err(got, want, relative):
    got = np.asarray(got)
    got = got.astype(np.complex128 if np.iscomplexobj(got) else np.float64)
    diff = float(np.abs(got - want).max())
    if not relative:
        return diff
    scale = float(np.abs(want).max())
    return diff / scale if scale > 0 else math.inf


def compare(cfg, design, reference, ring, n, outputs, final, total_blocks):
    """({number: value}, blocks whose audio failed its limit).

    ``outputs``: {stream block: program audio (C, M)}, the last block
    among them; ``final``: the entry's ``final_state`` after
    ``total_blocks`` blocks of ``n`` samples."""
    limit = float(cfg["limits"]["audio_err"])
    relative = cfg["audio_error"] == "relative"
    t = int(cfg["num_taps"])
    d = int(design["decimation"])
    warm = reference.warm_outputs(design)
    last = max(outputs)
    audio_err, failed = 0.0, 0
    for b in sorted(outputs):
        s = b * n
        x = ring_samples(ring, s - (t - 1) - warm * d, s + n)
        ref = reference.receive(x, design, s, n)
        err = _err(outputs[b].double().cpu().numpy(), ref["audio"],
                   relative)
        failed += not err <= limit
        audio_err = max(audio_err, err)
        if b == last:
            last_ref = ref
    numbers = {"audio_err": audio_err}
    if "carry" in final:
        numbers["carry_err"] = _err(final["carry"], last_ref["carry"], True)
        scale = float(np.abs(last_ref["audio"]).max())
        numbers["zi_err"] = float(np.abs(final["zi"] - last_ref["zi"]).max()
                                  ) / scale
    end = total_blocks * n
    tail = ring_samples(ring, end - (t - 1), end).cpu().numpy() \
        .astype(np.complex64)
    numbers["tail_mismatch"] = int((final["tail"] != tail).sum())
    fs = int(round(float(design["sample_rate"])))
    numbers["n0_mismatch"] = int(final["n0"] != end % fs)
    return numbers, failed
