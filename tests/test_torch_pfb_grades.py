"""The PFB front's grades (bf16x3, bf16x2) in the port against the JAX
package's (JAX on CPU, its Pallas kernels in interpret mode).

The port's tensor-core PFB front (fronts.cuh, pfb_front_mma) runs on the
card only; here its host side (the DFT bank's B table) and the plain
versions that emulate each grade are held to the JAX package's
definitions: the fold, the bf16 split of the fold and of the bank
(``_split_g``), and the three or two products of ``_nt_grade_dot``.
"""

import dataclasses

import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.kernels.fm_chain_pallas import (
    _dft_bank_stacked as j_dft_bank_stacked,
    _split_g,
    am_chain_pallas,
    pfb_am_chain_pallas,
    pfb_fm_chain_pallas,
)
from gsdr_tpu.pipelines import AmReceiver as JAm
from gsdr_tpu.pipelines import FmChannelizer as JFm
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels.am_chain import (
    am_chain_reference,
    pfb_am_chain_reference,
)
from gsdr_tpu_torch.kernels.chain import (
    graded_uniform_front,
    pfb_chunk_taps,
    pfb_f32_tables,
    pfb_lane_order,
    pfb_mma_chunk_tables,
    pfb_mma_tables,
    pfb_operands,
)
from gsdr_tpu_torch.kernels.fm_chain import pfb_fm_chain_reference
from gsdr_tpu_torch.ops.pfb import (
    _dft_bank_stacked,
    _poly_taps,
    uniform_bank_front,
)
from gsdr_tpu_torch.utils.convert import (
    am_receiver_from_fields,
    fm_channelizer_from_fields,
)

FS = 1_000_000.0
SKIP = 256  # zero-primed warm-up outputs
BF16 = ("bf16x3", "bf16x2")
# the digit-table phase bound, as tests/test_torch_fm_radio.py states it
PHASE_BOUND = 6e-5


def _lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def _planar(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _halves(words):
    """int32 words -> (low, high) bf16 halves as float32."""
    u = words.numpy().astype(np.int64) & 0xFFFFFFFF
    lo = ((u & 0xFFFF) << 16).astype(np.uint32).view(np.float32)
    hi = (u & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return lo, hi


@pytest.mark.parametrize("k,bins", [(16, [0, 1, 2, 3, 5, 7, 9, 11, 13, 15]),
                                    (20, [0, 19, 18, 17, 16, 3, 4]),
                                    (64, list(range(64)))])
def test_pfb_mma_tables_equal_jax_split(k, bins):
    """The tensor-core PFB front's B table, as fronts.cuh reads it: entry
    [part][kb][nt][4*cl + q][i] holds the bf16 pair (G[c, v], G[c, K+v]) of
    channel c = 4*nt + cl at lane v = 8*kb + q + 4*i, zero past K and C,
    array-equal to JAX's _split_g of _dft_bank_stacked (part 0 its high,
    part 1 its low parts); the bank's im rows C+c, which the kernel forms
    from row c, are the same split values swapped with one sign flipped."""
    c = len(bins)
    bank = _dft_bank_stacked(bins, k)
    np.testing.assert_array_equal(bank, j_dft_bank_stacked(bins, k, c))
    table = pfb_mma_tables(torch.from_numpy(bank))
    kb, nt = -(-k // 8), -(-c // 4)
    assert table.dtype == torch.int32
    assert tuple(table.shape) == (2, kb, nt, 16, 2)
    lo, hi = _halves(table)
    for part, split in enumerate(_split_g(bank, "bf16x3")[:2]):
        g = split.astype(np.float32)
        # the im rows are the re rows' halves swapped, the first negated
        np.testing.assert_array_equal(g[c:, :k], -g[:c, k:])
        np.testing.assert_array_equal(g[c:, k:], g[:c, :k])
        want_lo = np.zeros((4 * nt, 8 * kb), np.float32)
        want_hi = np.zeros((4 * nt, 8 * kb), np.float32)
        want_lo[:c, :k], want_hi[:c, :k] = g[:c, :k], g[:c, k:]
        # [kb][nt][4*cl + q][i] <- channel 4*nt + cl, lane 8*kb + q + 4*i
        for w, got in ((want_lo, lo[part]), (want_hi, hi[part])):
            arranged = w.reshape(nt, 4, kb, 2, 4).transpose(2, 0, 1, 4, 3)
            np.testing.assert_array_equal(got, arranged.reshape(kb, nt, 16, 2))


def test_pfb_mma_tables_cached_and_checked():
    """Built once per bank tensor, rebuilt after the tensor is written in
    place; a bank whose im rows are not its re rows' swap raises."""
    bank = torch.from_numpy(_dft_bank_stacked([0, 3, 5], 8))
    first = pfb_mma_tables(bank)
    assert pfb_mma_tables(bank) is first
    bank.mul_(0.5)
    second = pfb_mma_tables(bank)
    assert second is not first
    for a, b in zip(_halves(second), _halves(first)):
        np.testing.assert_array_equal(a, 0.5 * b)
    broken = bank.clone()
    broken[3, 1] += 0.25
    with pytest.raises(ValueError, match="DFT bank"):
        pfb_mma_tables(broken)


def _chunk_order(k, d):
    """The chunked kernel's lane order written out from its definition:
    groups of min(D, 16) phases, lanes kappa = pl*P + s of a group, each
    group padded with -1 to a multiple of 8 lanes."""
    p, dc = k // d, min(d, 16)
    out = []
    for p0 in range(0, d, dc):
        np_ = min(dc, d - p0)
        group = [p0 + pl + s * d for pl in range(np_) for s in range(p)]
        out += group + [-1] * (-len(group) % 8)
    return np.array(out)


# (K, D, bins): the NFM and airband grids, a group of 5 phases of P = 4
# (padding), the K=712 witness (a last group of 9 phases), D = 1 and P = 1
CHUNK_GRIDS = [(640, 160, [0, 1, 319, 639]), (960, 240, [2, 479, 958]),
               (20, 5, [0, 3, 19]), (712, 89, [0, 7, 355, 711]),
               (64, 1, [0, 63]), (48, 48, [1, 2, 3, 4, 5])]


@pytest.mark.parametrize("k,d,bins", CHUNK_GRIDS)
def test_pfb_chunk_tables_are_the_lane_order_of_the_one_chunk_tables(
        k, d, bins):
    """pfb_mma_chunk_tables and pfb_chunk_taps, as the bf16 PFB front's
    chunked kernel reads them: pfb_mma_tables' lanes and the (Q, K) taps'
    columns in the kernel's lane order (groups of min(D, 16) phases, lanes
    kappa = pl*P + s, each group padded to 8-lane blocks), array-equal to
    that permutation with zeros at the padding; a chunk of 8-lane blocks
    is one contiguous run of both. The B table holds a warp lane's
    fragment: lane 4*g + t takes entry 4*(g/2) + t, as is for even g, for
    odd g (the odd GEMM column) with its halves swapped and the new low
    half negated, as pfb_front_mma forms it in registers."""
    c = len(bins)
    bank = torch.from_numpy(_dft_bank_stacked(bins, k))
    taps = torch.from_numpy(_poly_taps(
        np.asarray(_lowpass(3 * k - 5, 0.4 / k), np.float32), k))
    order = _chunk_order(k, d)
    assert pfb_lane_order(k, d) == tuple(order.tolist())
    assert sorted(order[order >= 0].tolist()) == list(range(k))
    kbg = order.size // 8
    table = pfb_mma_chunk_tables(bank, d)
    assert table.dtype == torch.int32
    assert tuple(table.shape) == (2, kbg, -(-c // 4), 32, 2)
    lanes = table.numpy().reshape(2, kbg, -1, 4, 2, 4, 2)   # [.., cl, g%2]
    even = lanes[:, :, :, :, 0].view(np.uint32)
    odd = lanes[:, :, :, :, 1].view(np.uint32)
    np.testing.assert_array_equal(odd, ((even >> 16) | (even << 16)) ^ 0x8000)
    table = torch.from_numpy(np.ascontiguousarray(
        lanes[:, :, :, :, 0]).reshape(2, kbg, -1, 16, 2))
    q, i = np.meshgrid(np.arange(4), np.arange(2), indexing="ij")

    def by_lane(tab):
        """[part][nt][cl][lane] of a table whose entry [part][kb][nt][4*cl
        + q][i] holds lane 8*kb + q + 4*i."""
        tab = tab.numpy()
        two, kb_n, nt, _, _ = tab.shape
        out = np.zeros((two, nt, 4, 8 * kb_n), np.int32)
        for kb in range(kb_n):
            out[..., 8 * kb + q + 4 * i] = tab[:, kb].reshape(
                two, nt, 4, 4, 2)[..., q, i]
        return out

    one = by_lane(pfb_mma_tables(bank))
    want = np.zeros(one.shape[:3] + (order.size,), np.int32)
    want[..., order >= 0] = one[..., order[order >= 0]]
    np.testing.assert_array_equal(by_lane(table), want)
    hq = pfb_chunk_taps(taps, d)
    assert hq.dtype == torch.float32 and hq.is_contiguous()
    assert tuple(hq.shape) == (taps.shape[0], order.size)
    want_taps = np.zeros(hq.shape, np.float32)
    want_taps[:, order >= 0] = taps.numpy()[:, order[order >= 0]]
    np.testing.assert_array_equal(hq.numpy(), want_taps)


def test_pfb_chunk_tables_cached_and_checked():
    """Both chunked tables are cached per tensor and D beside the
    one-chunk tables, rebuilt after the tensor is written in place;
    pfb_operands hands the one-chunk launch pfb_mma_tables and the tap
    tensor, the chunked launch the chunked tables, f32 its own table; a
    bank off the DFT structure, or D not dividing K, raises."""
    bank = torch.from_numpy(_dft_bank_stacked([0, 3, 5], 40))
    taps = torch.from_numpy(_poly_taps(
        np.asarray(_lowpass(100, 0.01), np.float32), 40))
    first = pfb_mma_chunk_tables(bank, 10)
    assert pfb_mma_chunk_tables(bank, 10) is first
    assert pfb_mma_chunk_tables(bank, 20) is not first
    assert pfb_mma_tables(bank) is not first
    assert pfb_mma_chunk_tables(bank, 10) is first
    hq = pfb_chunk_taps(taps, 10)
    assert pfb_chunk_taps(taps, 10) is hq
    q = taps.shape[0]
    assert pfb_operands(taps, bank, 10, 3, (40, q)) == (
        taps, pfb_mma_tables(bank))
    for plan in ((8, q), (40, q - 1)):
        got = pfb_operands(taps, bank, 10, 2, plan)
        assert got[0] is hq and got[1] is first
    assert pfb_operands(taps, bank, 10, 0, (8, 1))[1] is pfb_f32_tables(bank)
    bank.mul_(0.5)
    second = pfb_mma_chunk_tables(bank, 10)
    assert second is not first
    for a, b in zip(_halves(second), _halves(first)):
        np.testing.assert_array_equal(a, 0.5 * b)
    taps.mul_(2.0)
    np.testing.assert_array_equal(pfb_chunk_taps(taps, 10).numpy(),
                                  2.0 * hq.numpy())
    broken = bank.clone()
    broken[3, 1] += 0.25
    with pytest.raises(ValueError, match="DFT bank"):
        pfb_mma_chunk_tables(broken, 10)
    with pytest.raises(ValueError, match="D | K"):
        pfb_mma_chunk_tables(bank, 7)
    with pytest.raises(ValueError, match="D | K"):
        pfb_chunk_taps(taps, 7)


@pytest.mark.parametrize("k,bins", [(8, [0, 3, 5]), (64, list(range(33))),
                                    (100, [1, 7, 50, 99])])
def test_pfb_f32_tables_layout_and_exact_structure(k, bins):
    """The f32 PFB front's bank table, as fronts.cuh reads it: entry
    [g][v][cl] holds (G[c, v], G[c, K+v]) of channel c = 32*g + cl, zero
    past C; JAX's DFT bank has im rows equal to the re rows' halves
    swapped, the first negated, bit for bit (zero signs included), so the
    kernel's (-G[c, K+v], G[c, v]) are the bank's values. Cached per
    tensor beside the bf16 table; a bank off that structure, even by the
    sign of a zero, raises."""
    c = len(bins)
    bank = _dft_bank_stacked(bins, k)
    np.testing.assert_array_equal(bank, j_dft_bank_stacked(bins, k, c))
    bits = bank.view(np.int32)
    np.testing.assert_array_equal(bits[c:, :k], (-bank[:c, k:]).view(np.int32))
    np.testing.assert_array_equal(bits[c:, k:], bits[:c, :k])
    t = torch.from_numpy(bank)
    table = pfb_f32_tables(t)
    ng = -(-c // 32)
    assert table.dtype == torch.float32
    assert tuple(table.shape) == (ng, k, 32, 2)
    flat = table.numpy().transpose(0, 2, 1, 3).reshape(ng * 32, k, 2)
    np.testing.assert_array_equal(flat[:c, :, 0], bank[:c, :k])
    np.testing.assert_array_equal(flat[:c, :, 1], bank[:c, k:])
    assert not flat[c:].any()
    assert pfb_f32_tables(t) is table
    assert pfb_mma_tables(t) is not table and pfb_f32_tables(t) is table
    zero = np.flatnonzero(bank[c:, :k] == 0)
    if zero.size:   # +0 where the structure gives -0: off by a zero's sign
        signed = bank.copy()
        r, col = divmod(int(zero[0]), k)
        signed[c + r, col] = -signed[c + r, col]
        with pytest.raises(ValueError, match="DFT bank"):
            pfb_f32_tables(torch.from_numpy(signed))
    broken = bank.copy()
    broken[c, 1] += 0.25
    with pytest.raises(ValueError, match="DFT bank"):
        pfb_f32_tables(torch.from_numpy(broken))


def _emulate(x_re, x_im, hp, bank, t, d, grade):
    """numpy: the fold in float32 (x*hp[0], then + x*hp[u] for ascending u,
    samples past N zero), the bf16 split of the fold and the bank, and the
    passes summed in float64."""
    q, k = hp.shape
    n = x_re.shape[-1]
    m = (n - t) // d + 1
    span = (m - 1) * d + q * k
    idx = np.arange(m)[:, None] * d + np.arange(k)[None, :]
    planes = []
    for x in (x_re, x_im):
        xp = np.zeros(span, np.float32)
        xp[:min(n, span)] = x[:span]
        a = xp[idx] * hp[0]
        for u in range(1, q):
            a = (a + xp[idx + u * k] * hp[u]).astype(np.float32)
        planes.append(a)
    fold = np.concatenate(planes, axis=1)                    # (M, 2K)

    def split(v):
        h = v.astype(ml_dtypes.bfloat16).astype(np.float32)
        return (h.astype(np.float64),
                (v - h).astype(ml_dtypes.bfloat16).astype(np.float64))

    ah, al = split(fold)
    gh, gl = split(bank)
    y = gh @ ah.T + gl @ ah.T
    if grade == "bf16x3":
        y += gh @ al.T
    c = bank.shape[0] // 2
    return y[:c], y[c:]


@pytest.mark.parametrize("grade", BF16)
@pytest.mark.parametrize("k,d,t,bins", [(16, 4, 65, list(range(0, 16, 2)) + [3, 5]),
                                        (16, 8, 100, list(range(10))),
                                        (20, 4, 77, [0, 1, 19, 7])])
def test_graded_uniform_front_matches_numpy(grade, k, d, t, bins):
    """graded_uniform_front at a grade against a numpy emulation of the
    grade: within 1e-6 of max|y| (float32 sums of exact bf16 products in
    another order); 'f32' is uniform_bank_front bit for bit."""
    re, im = _planar(t - 1 + d * 600, 4)
    hp = _poly_taps(_lowpass(t, 0.4 / k), k)
    bank = _dft_bank_stacked(bins, k)
    x = TCA(torch.from_numpy(re), torch.from_numpy(im))
    args = (torch.from_numpy(hp), torch.from_numpy(bank), t, d)
    y = graded_uniform_front(x, *args, precision=grade)
    want_re, want_im = _emulate(re, im, hp, bank, t, d, grade)
    scale = max(np.abs(want_re).max(), np.abs(want_im).max())
    assert y.re.shape == want_re.shape == (len(bins), 600)
    for got, want in ((y.re, want_re), (y.im, want_im)):
        assert np.max(np.abs(got.numpy() - want)) <= 1e-6 * scale
    f32 = graded_uniform_front(x, *args)
    ref = uniform_bank_front(x, *args)
    assert torch.equal(f32.re, ref.re) and torch.equal(f32.im, ref.im)
    # the comparison tells the grade from f32
    gap = float((f32.re - torch.from_numpy(want_re).float()).abs().max())
    assert gap >= 2e-6 * scale


# FM audio against the JAX PFB-fronted kernel interpreted at the grade: of
# max|audio|, as tests/test_torch_grades.py's FM_TOL for the dense front,
# plus the JAX kernel's polynomial atan2 (kmath.atan2_poly), whose error
# the plain chain's libm atan2 does not share: at most 2.0e-6 rad at
# order 11 (bf16x3) and 8.2e-5 rad at order 7 (bf16x2), measured over the
# circle; times the gain, through the de-emphasis (sum of |h| = 1). On
# this signal the order-7 term is 1.7e-4 absolute, above 1e-4 of its
# max|audio| (0.53): a larger deviation, which would lift max|audio|,
# takes the filtered carriers to the atan2 branch cut.
FM_TOL = {"bf16x3": 2e-5, "bf16x2": 1e-4}
ATAN_ERR = {"bf16x3": 2.0e-6, "bf16x2": 8.2e-5}


def _deemph_response(model, m):
    """|h| of the de-emphasis over m outputs: h[0] = b0, h[n] =
    cc*a^(n-1)."""
    b0, cc, a = (abs(float(v)) for v in model.deemph)
    return np.concatenate([[b0], cc * a ** np.arange(m - 1)])


@pytest.mark.parametrize("grade", BF16)
def test_pfb_fm_chain_reference_matches_jax_interpret_at_grade(grade):
    """pfb_fm_chain_reference at a grade against pfb_fm_chain_pallas
    interpreted at the same grade over two streamed steps, the carries
    exported each side: K=16, D=4, T=128, 10 of the 16 bins, FM carriers
    at 10 kHz deviation. After the first step's warm-up the audio is
    within FM_TOL of max|audio| plus the atan2 term, and on the second
    step plus the step boundary's digit-table allowance
    (tests/test_torch_fm_radio.py, PHASE_BOUND); the carries within 2e-4."""
    k, d, t, n = 16, 4, 128, 4096
    jm = JFm(sample_rate=FS, tuning_frequency=0.0,
             channel_frequencies=tuple(-(FS / k) * i
                                       for i in (0, 2, 4, 6, 8, 10, 12, 14, 5,
                                                 11)),
             frequency_deviation=75_000.0, decimation=d,
             low_pass_taps=_lowpass(t, 0.4 / k), impl="pfb", precision=grade)
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    assert tm.precision == grade and tm.pfb_grid[0] == k
    bins = tm.pfb_grid[1]
    rng = np.random.default_rng(3)
    tt = np.arange(2 * n) / FS
    sig = np.zeros(2 * n, np.complex128)
    for i, f in enumerate(jm._shifts()):
        tone = 200.0 + 40.0 * i
        msg = np.sin(2 * np.pi * tone * tt + rng.uniform(0, 6))
        sig += (0.9 / len(bins)) * np.exp(
            1j * (2 * np.pi * f * tt + (10_000.0 / tone) * msg))
    re, im = sig.real.astype(np.float32), sig.imag.astype(np.float32)
    fs = int(FS)
    b, a = jm._deemph()
    h = _deemph_response(tm, n // d)
    atan_term = tm.gain * ATAN_ERR[grade] * h.sum()
    boundary = tm.gain * 2 * np.pi * 2 * PHASE_BOUND * h
    jstate, tstate = jm.init(), tm.init()
    for step in range(2):
        sl = slice(step * n, (step + 1) * n)
        n0, tail, cf, cz = jstate
        buf = JCA(jnp.concatenate([tail.re, jnp.asarray(re[sl])]),
                  jnp.concatenate([tail.im, jnp.asarray(im[sl])]))
        rot0 = (n0 + jnp.int32(fs - (t - 1) % fs)) % fs
        yj, cfj, czj = pfb_fm_chain_pallas(
            buf, jm.low_pass_taps, jm._lo_table(), rot0, d, jm.gain, b, a,
            cf, cz, tuple(jm._shifts()), FS, bins, k, precision=grade,
            interpret=True)
        tn0, ttail, tcf, tcz = tstate
        tbuf = TCA(torch.cat([ttail.re, torch.from_numpy(re[sl])]),
                   torch.cat([ttail.im, torch.from_numpy(im[sl])]))
        trot0 = torch.remainder(tn0 + (fs - (t - 1) % fs), fs).to(torch.int32)
        yt, cft, czt = pfb_fm_chain_reference(
            tbuf, tm.poly_taps, tm.dft_bank, t, tm.lo_table, trot0, d,
            tm.gain, tm.deemph, tcf, tcz, precision=grade)
        yj = np.asarray(yj)
        assert tuple(yt.shape) == yj.shape == (len(bins), n // d)
        s0 = SKIP if step == 0 else 0
        err = np.abs(yt.numpy() - yj)[:, s0:]
        bound = FM_TOL[grade] * np.max(np.abs(yj[:, s0:])) + atan_term
        if step > 0:
            bound = bound + boundary[None, :]
        assert np.all(err <= bound)
        for got, want in ((cft.re, cfj.re), (cft.im, cfj.im), (czt, czj)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=2e-4)
        jstate = ((n0 + n % fs) % fs, buf[..., buf.shape[-1] - (t - 1):],
                  cfj, czj)
        tstate = (torch.remainder(tn0 + n % fs, fs).to(torch.int32),
                  tbuf[..., tbuf.shape[-1] - (t - 1):], cft, czt)


# AM envelopes against the JAX kernels interpreted at the grade, absolute:
# summation order only (bf16 products exact in float32)
AM_TOL = {"bf16x3": 1e-5, "bf16x2": 1e-4}


@pytest.mark.parametrize("grade", BF16)
@pytest.mark.parametrize("front", ["pfb", "toeplitz"])
def test_am_chain_references_match_jax_interpret_at_grade(front, grade):
    """pfb_am_chain_reference and am_chain_reference at a grade against
    pfb_am_chain_pallas and am_chain_pallas interpreted at the same grade:
    on the PFB front K=16, D=8, T=100 (a ragged fold), 9 of the 16 bins;
    on the dense front 9 channels off any grid, T=65, D=4. Within AM_TOL
    (absolute); each also tells its grade from f32."""
    k, d, t = 16, 8 if front == "pfb" else 4, 100 if front == "pfb" else 65
    if front == "pfb":
        freqs = tuple(-(FS / k) * i for i in (0, 1, 2, 4, 6, 8, 10, 12, 14))
        jm = JAm(sample_rate=FS, tuning_frequency=0.0,
                 channel_frequencies=freqs, decimation=d,
                 low_pass_taps=_lowpass(t, 0.4 / k), impl="pfb",
                 precision=grade)
    else:
        freqs = tuple(-37_000.0 * i + 1_234.5 for i in range(9))
        jm = JAm(sample_rate=FS, tuning_frequency=0.0,
                 channel_frequencies=freqs, decimation=d,
                 low_pass_taps=_lowpass(t, 0.03), precision=grade)
    tm = am_receiver_from_fields(dataclasses.asdict(jm), device="cpu")
    assert tm.precision == grade
    rng = np.random.default_rng(5)
    n = t - 1 + 2048
    tt = np.arange(n) / FS
    sig = np.zeros(n, np.complex128)
    for i, f in enumerate(jm._shifts()):
        env = 0.6 * (1.0 + 0.5 * np.sin(2 * np.pi * (300.0 + 50.0 * i) * tt))
        sig += (env / 3.0) * np.exp(1j * (2 * np.pi * f * tt
                                          + rng.uniform(0, 6)))
    re, im = sig.real.astype(np.float32), sig.imag.astype(np.float32)
    jbuf = JCA(jnp.asarray(re), jnp.asarray(im))
    tbuf = TCA(torch.from_numpy(re), torch.from_numpy(im))
    fs = int(FS)
    rot0 = torch.tensor((123_457 + fs - (t - 1) % fs) % fs, dtype=torch.int32)
    if front == "pfb":
        kk, bins = tm.pfb_grid
        assert kk == k
        want = pfb_am_chain_pallas(jbuf, jm.low_pass_taps, d, bins, k,
                                   precision=grade, interpret=True)
        args = (tbuf, tm.poly_taps, tm.dft_bank, t, tm.lo_table, rot0, d)
        got = pfb_am_chain_reference(*args, precision=grade)
        f32 = pfb_am_chain_reference(*args)
    else:
        assert tm.front == "toeplitz"
        want = am_chain_pallas(jbuf, jm._tap_bank(), d, precision=grade,
                               interpret=True)
        args = (tbuf, tm.tap_bank, tm.lo_table, rot0, d)
        got = am_chain_reference(*args, precision=grade)
        f32 = am_chain_reference(*args)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape == (len(freqs), 2048 // d)
    err = float(np.max(np.abs(got.numpy() - want)))
    assert err <= AM_TOL[grade]
    assert float(np.max(np.abs(f32.numpy() - want))) >= 2 * err
