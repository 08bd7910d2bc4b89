"""The dense front at geometries whose bank does not fit one block of the
card: the port against the JAX package on the CPU at those geometries
(the receivers, the single-channel ops and the plain version against
JAX's fused kernel interpreted), and a numpy transliteration of the
chunked staging of ``csrc/fronts.cuh`` (``toeplitz_front``,
``toeplitz_front_mma``) against the plain version, the cheap check of the
kernels' index logic that the card tests then hold bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsdr_tpu as J
import gsdr_tpu_torch as T
from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.kernels.fm_chain_pallas import fm_chain_pallas
from gsdr_tpu.pipelines import AmReceiver as JAm
from gsdr_tpu.pipelines import FmChannelizer as JFm
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels.chain import dense_mma_tables, split_bf16
from gsdr_tpu_torch.kernels.channelize import channelize_reference
from gsdr_tpu_torch.kernels.fm_chain import fm_chain_reference
from gsdr_tpu_torch.ops.am import am_demod_fused
from gsdr_tpu_torch.ops.channelize import make_complex_tap_bank
from gsdr_tpu_torch.ops.fm import fm_demod_fused
from gsdr_tpu_torch.utils.convert import (
    am_receiver_from_fields,
    fm_channelizer_from_fields,
    state_to_numpy,
)

TILE = 256        # outputs a block (fronts.cuh kTile)
CG = 16           # channels a block at f32 (kCG)


def _lowpass(num_taps, cutoff):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff * n) * np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# The chunked staging, transliterated
# ---------------------------------------------------------------------------

def _stage(x, g0, d, dc, kr):
    """A chunk's window as the fronts stage it: word (p, k) = x[g0 + k*D +
    p] for the chunk's dc phases, zeros outside x."""
    p, k = np.meshgrid(np.arange(dc), np.arange(kr), indexing="ij")
    g = g0 + k * d + p
    inside = (g >= 0) & (g < x.shape[0])
    return np.where(inside, x[np.clip(g, 0, x.shape[0] - 1)], 0)


def _toeplitz_front(x, bank, t, tc, d, c0, g0):
    """``toeplitz_front``: taps in chunks of tc, each with its own taps and
    its own window of min(tc, D) phases of TILE + (tc-1)//D words."""
    g = (bank[0::2, 0] + 1j * bank[1::2, 0]).astype(np.complex128)
    taps = np.zeros((CG, t), np.complex128)
    n = min(CG, g.shape[0] - c0)
    taps[:n] = g[c0:c0 + n]
    tc = min(tc, t)
    dc, kr = min(tc, d), TILE + (tc - 1) // d
    acc = np.zeros((TILE, CG), np.complex128)
    rows = np.arange(TILE)
    for t0 in range(0, t, tc):
        xp = _stage(x, g0 + t0, d, dc, kr)
        for tl in range(min(tc, t - t0)):
            acc += xp[tl % d, rows + tl // d][:, None] * taps[None, :, t0 + tl]
    return acc


def _phase_stride(tp, d):
    """``mma_phase_stride``: Kr words padded to 8 mod 32."""
    kr = TILE + (tp - 1) // d
    return kr + ((8 - kr % 32) + 32) % 32


def _pairs(words):
    """The bf16 (plane 0, plane 1) pairs of int32 words, as float64."""
    w = words.astype(np.uint32)
    lo = ((w & 0xFFFF) << 16).view(np.float32).astype(np.float64)
    hi = (w & 0xFFFF0000).view(np.float32).astype(np.float64)
    return lo, hi


def _toeplitz_front_mma(x, table, t, tc, d, group, nt_block, g0, grade):
    """``toeplitz_front_mma``: chunks of KBc blocks of 8 taps; per chunk B's
    rows kb0..kb0+nkb-1 of ``dense_mma_tables`` and the window from g0 +
    8*kb0, read at off[tl] + r, off[tl] = (tl % D)*Ks + tl//D, the lo part
    Dc*Ks words after the hi part. A word's pair is (re, im) of a sample;
    a B entry's pair is (gr, -gi) of a tap; the product is their complex
    product, summed over the grade's passes."""
    kb_all, nt_all = table.shape[1], table.shape[2]
    kbc = kb_all if tc >= t else tc // 8
    tcp = 8 * kbc
    dc, ks = min(tcp, d), _phase_stride(tcp, d)
    kr = TILE + (tcp - 1) // d
    off = np.array([(tl % d) * ks + tl // d for tl in range(tcp)])
    xh_re, xl_re = (v.double().numpy() for v in split_bf16(
        torch.from_numpy(x.real.astype(np.float32))))
    xh_im, xl_im = (v.double().numpy() for v in split_bf16(
        torch.from_numpy(x.imag.astype(np.float32))))
    parts = [xh_re + 1j * xh_im, xl_re + 1j * xl_im]
    acc = np.zeros((TILE, 4 * nt_block), np.complex128)
    rows = np.arange(TILE)
    for kb0 in range(0, kb_all, kbc):
        nkb = min(kbc, kb_all - kb0)
        win = [np.zeros(dc * ks, np.complex128) for _ in parts]
        for w, xs in zip(win, parts):
            staged = _stage(xs, g0 + 8 * kb0, d, dc, kr)
            for p in range(dc):
                w[p * ks:p * ks + kr] = staged[p]
        for kb in range(nkb):
            for nt in range(nt_block):
                ntg = group * nt_block + nt
                if ntg >= nt_all:
                    continue
                for e in range(16):
                    cl, q = divmod(e, 4)
                    for i in range(2):
                        j = q + 4 * i
                        a = [w[off[8 * kb + j] + rows] for w in win]
                        gr, gi_neg = (_pairs(table[part, kb0 + kb, ntg, e, i])
                                      for part in (0, 1))
                        bh = gr[0] - 1j * gr[1]
                        bl = gi_neg[0] - 1j * gi_neg[1]
                        y = a[0] * bh + a[0] * bl
                        if grade == "bf16x3":
                            y = y + a[1] * bh
                        acc[:, 4 * nt + cl] += y
    return acc


def _window_signal(n, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal(n) + 1j * r.standard_normal(n)).astype(
        np.complex64).astype(np.complex128)


# (C, T, D, Tc): one chunk with T < D (the one-op shape, D = 256) and
# T >= D; chunks shorter than D (the scanner's D = 128, T = 257) and
# longer, a last chunk shorter than the rest, T not a multiple of 8, D = 1
CHUNK_CASES = [(3, 65, 256, 65), (5, 61, 4, 61), (4, 257, 128, 96),
               (17, 61, 4, 16), (3, 300, 8, 64), (2, 33, 1, 8),
               (6, 257, 128, 8)]


@pytest.mark.parametrize("grade", ["f32", "bf16x3", "bf16x2"])
@pytest.mark.parametrize("c,t,d,tc", CHUNK_CASES)
def test_chunked_front_transliteration_matches_plain(grade, c, t, d, tc):
    """The chunked staging and indexing of both dense fronts, at the
    second block (g0 = TILE*D) of a signal that ends inside it, so that
    the window's last samples read as zeros: within 1e-6 of max|y| of the
    plain version at the grade (channelize_reference), every channel
    group."""
    taps = _lowpass(t, 0.05)
    shifts = [-1000.0 / (2 * c + 3) * i for i in range(c)]
    bank = make_complex_tap_bank(taps, shifts, 1000.0)
    m = 100                      # outputs of the second block
    n = t + d * (TILE + m - 1)
    x = _window_signal(n, seed=t + d)
    want = channelize_reference(
        TCA(torch.from_numpy(x.real.astype(np.float32)),
            torch.from_numpy(x.imag.astype(np.float32))),
        torch.from_numpy(bank), d, grade)
    want = (want.re.double().numpy() + 1j * want.im.double().numpy())[:, TILE:]
    g0 = TILE * d
    if grade == "f32":
        got = np.concatenate([
            _toeplitz_front(x, bank, t, tc, d, c0, g0)
            for c0 in range(0, c, CG)], axis=1)[:m, :c].T
    else:
        table = dense_mma_tables(torch.from_numpy(bank)).numpy()
        got = np.concatenate([
            _toeplitz_front_mma(x, table, t, tc, d, grp, 4, g0, grade)
            for grp in range(-(-c // CG))], axis=1)[:m, :c].T
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-6


# ---------------------------------------------------------------------------
# The receivers and the ops against the JAX package at those geometries
# ---------------------------------------------------------------------------

SCANNER_FS = 2_400_000.0
BLOCK = 1 << 15           # 256 outputs a step at D = 128
ENV_ATOL = 1e-5           # as tests/test_torch_am_radio.py


def _nfm_scanner():
    """A narrowband FM scanner on an RTL-SDR's 2.4 MHz: 16 channels 25 kHz
    apart, 257 taps, D = 128 (18.75-kHz audio), 5-kHz deviation."""
    return JFm(sample_rate=SCANNER_FS, tuning_frequency=462_000_000.0,
               channel_frequencies=tuple(462_000_000.0 - 200_000.0
                                         + 25_000.0 * i for i in range(16)),
               frequency_deviation=5_000.0, decimation=128,
               low_pass_taps=tuple(_lowpass(257, 12_500.0 / SCANNER_FS)
                                   .tolist()), impl="xla")


def _am_d128():
    """am_d's 8 channels off any preferred grid, 1021 taps, D = 128."""
    return JAm(sample_rate=1e6, tuning_frequency=100_000_000.0,
               channel_frequencies=tuple(100_000_000.0 - 200_000.0
                                         + 50_000.0 * i for i in range(8)),
               decimation=128,
               low_pass_taps=tuple(_lowpass(1021, 0.005).tolist()),
               impl="xla")


def _carriers(model, n, am=False, seed=7):
    """An FM (5-kHz deviation) or AM carrier on every channel, tone 300 +
    150*k Hz."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / model.sample_rate
    sig = np.zeros(n, np.complex128)
    for k, f in enumerate(model.channel_frequencies):
        tone = 300.0 + 150.0 * k
        msg = np.sin(2 * np.pi * tone * t + r.uniform(0, 6))
        ph = 2 * np.pi * (f - model.tuning_frequency) * t
        if am:
            sig += 0.6 * (1.0 + 0.5 * msg) * np.exp(1j * (ph + r.uniform(0, 6)))
        else:
            sig += np.exp(1j * (ph + 5_000.0 / tone * msg)) / 16
    return sig.real.astype(np.float32), sig.imag.astype(np.float32)


@pytest.mark.parametrize("name", ["nfm_scanner", "am_d128"])
def test_receiver_matches_jax_xla_where_the_bank_chunks(name):
    """FmChannelizer at the scanner's geometry and AmReceiver at D = 128,
    T = 1021, carried across by the converters, against JAX's XLA chain
    over three streamed steps of 2^15 samples: FM audio within 1e-4 of
    max|audio| (both plain chains: the same float32 ops but libm's atan2
    and the convolution's order), the carries within 1e-4; AM envelopes
    within 1e-5; the RF tails and n0 equal."""
    fm = name == "nfm_scanner"
    jm = _nfm_scanner() if fm else _am_d128()
    fields = dataclasses.asdict(jm)
    tm = (fm_channelizer_from_fields if fm else am_receiver_from_fields)(
        fields, device="cpu")
    assert tm.front == "toeplitz"
    re, im = _carriers(jm, 3 * BLOCK, am=not fm)
    js, ts = jm.init(), tm.init()
    for i in range(3):
        sl = slice(i * BLOCK, (i + 1) * BLOCK)
        js, yj = jm.step(js, JCA(jnp.asarray(re[sl]), jnp.asarray(im[sl])))
        ts, yt = tm.step(ts, TCA(torch.from_numpy(re[sl]),
                                 torch.from_numpy(im[sl])))
        yj, yt = np.asarray(yj), yt.numpy()
        assert yt.shape == yj.shape == (len(jm.channel_frequencies),
                                        BLOCK // jm.decimation)
        if fm:
            assert _rel(yt, yj) <= 1e-4
        else:
            assert np.max(np.abs(yt - yj)) <= ENV_ATOL
    t_np = state_to_numpy(ts)
    assert int(t_np[0]) == int(np.asarray(js[0]))
    np.testing.assert_array_equal(t_np[1][0], np.asarray(js[1].re))
    np.testing.assert_array_equal(t_np[1][1], np.asarray(js[1].im))
    if fm:
        np.testing.assert_allclose(t_np[2][0], np.asarray(js[2].re), atol=1e-4)
        np.testing.assert_allclose(t_np[2][1], np.asarray(js[2].im), atol=1e-4)
        np.testing.assert_allclose(t_np[3], np.asarray(js[3]), atol=1e-4)


def test_fm_chain_reference_matches_jax_kernel_interpret_at_d128():
    """The plain version the card holds the chunked B1 to, fm_chain_
    reference at f32, against JAX's fused kernel (fm_chain_pallas)
    interpreted at D = 128, T = 257, C = 4, over one step of 40 outputs:
    within 2e-4 of max|audio| after the zero-primed first output (its
    atan2 reads +-pi in the plain chain, 0 in the kernel), the carries
    within 2e-4 of max|audio| too: tests/test_torch_fm_radio.py's 2e-4
    absolute at the flagship, whose audio is ~2.7, where this audio and
    its de-emphasis state reach ~D = 128."""
    jm = JFm(sample_rate=SCANNER_FS, tuning_frequency=0.0,
             channel_frequencies=(-75_000.0, -25_000.0, 25_000.0, 75_000.0),
             frequency_deviation=5_000.0, decimation=128,
             low_pass_taps=tuple(_lowpass(257, 12_500.0 / SCANNER_FS)
                                 .tolist()), precision="f32")
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    n = 128 * 40
    re, im = _carriers(jm, n, seed=3)
    t, fs = jm.num_taps, int(SCANNER_FS)
    b, a = jm._deemph()
    n0, tail, cf, cz = jm.init()
    buf = JCA(jnp.concatenate([tail.re, jnp.asarray(re)]),
              jnp.concatenate([tail.im, jnp.asarray(im)]))
    rot0 = (n0 + jnp.int32(fs - (t - 1) % fs)) % fs
    yj, cfj, czj = fm_chain_pallas(
        buf, jm._tap_bank(), jm._lo_table(), rot0, 128, jm.gain, b, a, cf,
        cz, shifts_hz=tuple(jm._shifts()), sample_rate=SCANNER_FS,
        precision="f32", interpret=True)
    tn0, ttail, tcf, tcz = tm.init()
    tbuf = TCA(torch.cat([ttail.re, torch.from_numpy(re)]),
               torch.cat([ttail.im, torch.from_numpy(im)]))
    trot0 = torch.remainder(tn0 + (fs - (t - 1) % fs), fs).to(torch.int32)
    yt, cft, czt = fm_chain_reference(tbuf, tm.tap_bank, tm.lo_table, trot0,
                                      128, tm.gain, tm.deemph, tcf, tcz)
    yj = np.asarray(yj)
    assert tuple(yt.shape) == yj.shape == (4, n // 128)
    assert _rel(yt.numpy()[:, 1:], yj[:, 1:]) <= 2e-4
    scale = float(np.max(np.abs(yj[:, 1:])))
    for got, want in ((cft.re, cfj.re), (cft.im, cfj.im), (czt, czj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=2e-4 * scale)


# the composed chains against JAX's XLA chains, of max|audio|
# (tests/test_torch_demod_ops.py)
CHAIN_TOL = 2e-4
PHASE_BOUND = 6e-5


@pytest.mark.parametrize("op", ["fm_demod", "am_demod"])
def test_single_channel_op_matches_jax_at_d256(op):
    """fm_demod and am_demod at one channel, T = 65, D = 256: 'auto' on
    the CPU (the composed chain) against JAX's 'xla' within CHAIN_TOL of
    max|audio| (AM: ENV_ATOL), and the kernel route's plain version (the
    arithmetic B1 and B3-dense run on the card at this geometry) against
    the same within the digit-table phase's allowance (FM; AM is exact in
    the phase)."""
    fs, fc, d = 1e6, 100_000.0, 256
    taps = _lowpass(65, 0.02)
    i = np.arange(65 + d * 60, dtype=np.float64)
    if op == "fm_demod":
        x = np.exp(1j * (2 * np.pi * fc * i / fs + 10.0 * np.sin(
            2 * np.pi * 50.0 * i / fs))).astype(np.complex64)
        want = np.asarray(J.fm_demod(x, taps, fs, 0.0, fc, 500.0, d,
                                     impl="xla"))
        got = T.fm_demod(torch.from_numpy(x), taps, fs, 0.0, fc, 500.0, d)
        gain = T.fm_demod_gain(fs, 500.0)
        fused = fm_demod_fused(TCA.from_complex(x), taps, fs, -fc, gain, d,
                               precision="f32")
        allow = CHAIN_TOL * np.max(np.abs(want)) \
            + gain * 2 * np.pi * 2 * PHASE_BOUND
    else:
        x = (0.5 * (1.0 + 0.6 * np.cos(2 * np.pi * 50.0 * i / fs))
             * np.exp(2j * np.pi * fc * i / fs)).astype(np.complex64)
        want = np.asarray(J.am_demod(x, taps, fs, 0.0, fc, d, impl="xla"))
        got = T.am_demod(torch.from_numpy(x), taps, fs, 0.0, fc, d)
        fused = am_demod_fused(TCA.from_complex(x), taps, fs, -fc, d,
                               precision="f32")
        allow = ENV_ATOL
    got, fused = got.numpy(), fused.numpy()
    assert got.shape == fused.shape == want.shape
    if op == "fm_demod":
        assert _rel(got, want) <= CHAIN_TOL
    else:
        assert np.max(np.abs(got - want)) <= ENV_ATOL
    assert np.max(np.abs(fused - want)) <= allow
