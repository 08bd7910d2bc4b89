"""The dense front at geometries whose bank does not fit one block of the
card: the port against the JAX package on the CPU at those geometries
(the receivers, the single-channel ops and the plain version against
JAX's fused kernel interpreted), and numpy transliterations of the
chunked staging of ``csrc/fronts.cuh`` (``toeplitz_front``,
``toeplitz_front_mma``) against the plain version, the cheap check of the
kernels' index logic that the card tests then hold bit for bit. The f32
front's is its block in its shared-memory layout: the tap table
(``dense_f32_tables``), the thread -> (rows, channels) map of its register
tiles, the double-buffered chunk walk and the output tile."""

import re

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
from gsdr_tpu_torch.kernels import _build
from gsdr_tpu_torch.kernels.chain import (
    dense_f32_tables,
    dense_mma_tables,
    split_bf16,
)
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
# the f32 front's register tile (fronts.cuh; read from the source by
# test_f32_dense_constants_match_the_source): rows 32 apart (kDenseRows),
# and 4 or 8 channels of one table group, the launcher's choice
ROWS = 4
WIDTHS = (4, 8)


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


def _f32_channels(c):
    """dense_f32_channels: 8, 16 or 32 channels a block by C."""
    return 8 if c <= 8 else 16 if c <= 16 else 32


def _f32_threads(ch, cols):
    """dense_f32_threads: the threads that hold a register tile."""
    return TILE // ROWS * (ch // cols)


def _dense_cols(ch):
    """dense_cols: the AM chain's and the channelizer's tile width."""
    return 4 if ch == 8 else 8


def _phase_stride_f32(tc, d):
    """dense_phase_stride: Kr = TILE + (tc-1)//D frames, made odd."""
    return (TILE + (tc - 1) // d) | 1


def _buffer_floats(ch, tc, d):
    """dense_f32_buffer_floats: a chunk's taps [ch/8][tc][8][2] and window
    [min(tc, D)][Ks] of (re, im) pairs, padded to 4 floats."""
    return (16 * (ch // 8) * tc + 2 * min(tc, d) * _phase_stride_f32(tc, d)
            + 3) // 4 * 4


def _smem_floats(ch, tc, t, d):
    """toeplitz_smem_bytes / 4: one buffer, two where tc < T; the output
    tile reuses them."""
    return max((2 if tc < t else 1) * _buffer_floats(ch, tc, d),
               TILE * (2 * ch + 1))


def _fmaf(a, b, c):
    """float32 fma, the product exact in float64, one rounding after the
    sum (then to float32: the emulation every plan shares)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _dense_stage(sm, base, ftab, t0, nt, tc, gb, x, g0, d, dc, kr, ch):
    """dense_stage: taps t0..t0+nt-1 of groups gb.. of the table into
    sm[base + s*tc*16 + 16*tl + 2*cl (+1)] (zeros past the table's
    groups), the window sample g0 + t0 + k*D + p (k < kr) into the (re,
    im) pair p*Ks + k after them, zeros outside x; every index inside the
    buffer."""
    ng, t_all = ftab.shape[:2]
    flat = ftab.reshape(ng, t_all * 16)
    end = base + _buffer_floats(ch, tc, d)
    for s_ in range(ch // 8):
        dst = base + s_ * tc * 16
        sm[dst:dst + 16 * nt] = (flat[gb + s_, 16 * t0:16 * (t0 + nt)]
                                 if gb + s_ < ng else 0.0)
    xw = base + (ch // 8) * tc * 16
    l = np.arange(dc * kr)
    p, k = l % dc, l // dc
    g = g0 + t0 + k * d + p
    inside = (g >= 0) & (g < x.shape[0])
    v = np.where(inside, x[np.clip(g, 0, x.shape[0] - 1)], 0)
    at = xw + 2 * (p * _phase_stride_f32(tc, d) + k)
    assert at.max() + 1 < end and dst + 16 * nt <= xw
    sm[at] = v.real
    sm[at + 1] = v.imag


def _dense_product(acc_re, acc_im, sm, base, tc, nt, d, ch, cols):
    """dense_product for every tile holder at once: thread tid (warp w,
    lane) holds rows 128*(w % 2) + lane + 32*i and channels cols*(w // 2)
    + c; tap tl reads pair (tl % D)*Ks + r + tl//D of the window and the
    channel's (gr, gi) at 16*tl + 2*(its place in its group of 8), in
    ascending tl with fmaf."""
    ks = _phase_stride_f32(tc, d)
    tid = np.arange(_f32_threads(ch, cols))
    warp, lane = tid // 32, tid % 32
    rows = ((TILE // 2) * (warp % 2) + lane)[:, None] + 32 * np.arange(ROWS)
    first = cols * (warp // 2)          # the tile's first channel
    gt = base + (first // 8) * tc * 16 + 2 * (first % 8)
    xw = base + (ch // 8) * tc * 16
    for tl in range(nt):
        at = xw + 2 * ((tl % d) * ks + tl // d + rows)
        xr, xi = sm[at][:, :, None], sm[at + 1][:, :, None]
        gat = gt[:, None] + 16 * tl + 2 * np.arange(cols)
        gr, gi = sm[gat][:, None, :], sm[gat + 1][:, None, :]
        acc_re[:] = _fmaf(xr, gr, _fmaf(-xi, gi, acc_re))
        acc_im[:] = _fmaf(xr, gi, _fmaf(xi, gr, acc_im))


def _toeplitz_front(x, ftab, c, t, tc, d, group, g0, cols=None):
    """``toeplitz_front`` at f32 for channel block ``group`` (float32 x) in
    tiles of ``cols`` channels (default: the channelizer's width): the
    block's shared memory as NaNs, chunk 0 staged into buffer 0, then for
    each chunk the next one staged into the other buffer before the
    chunk's product (the copies in flight), the tiles written to the
    output tile at the start of shared memory; returns the tile as complex
    (TILE, ch) and the float32 sums."""
    ch = _f32_channels(c)
    cols = cols or _dense_cols(ch)
    tc = min(tc, t)
    dc, kr = min(tc, d), TILE + (tc - 1) // d
    bsize = _buffer_floats(ch, tc, d)
    sm = np.full(_smem_floats(ch, tc, t, d), np.nan, np.float32)
    gb = group * (ch // 8)
    nth = _f32_threads(ch, cols)
    acc_re = np.zeros((nth, ROWS, cols), np.float32)
    acc_im = np.zeros_like(acc_re)
    nch = -(-t // tc)
    _dense_stage(sm, 0, ftab, 0, min(tc, t), tc, gb, x, g0, d, dc, kr, ch)
    for ci in range(nch):
        if ci + 1 < nch:
            t1 = (ci + 1) * tc
            _dense_stage(sm, ((ci + 1) % 2) * bsize, ftab, t1,
                         min(tc, t - t1), tc, gb, x, g0, d, dc, kr, ch)
        _dense_product(acc_re, acc_im, sm, (ci % 2) * bsize, tc,
                       min(tc, t - ci * tc), d, ch, cols)
    kos = 2 * ch + 1
    tid = np.arange(nth)
    warp, lane = tid // 32, tid % 32
    rows = ((TILE // 2) * (warp % 2) + lane)[:, None, None] \
        + 32 * np.arange(ROWS)[None, :, None]
    chans = (cols * (warp // 2))[:, None, None] \
        + np.arange(cols)[None, None, :]
    at = rows * kos + 2 * chans
    sm[at] = acc_re
    sm[at + 1] = acc_im
    tile = sm[:TILE * kos].reshape(TILE, kos)
    out = tile[:, 0:2 * ch:2].astype(np.float64) \
        + 1j * tile[:, 1:2 * ch:2].astype(np.float64)
    return out, acc_re, acc_im


def _pairs(words):
    """The bf16 (plane 0, plane 1) pairs of int32 words, as float64."""
    w = words.astype(np.uint32)
    lo = ((w & 0xFFFF) << 16).view(np.float32).astype(np.float64)
    hi = (w & 0xFFFF0000).view(np.float32).astype(np.float64)
    return lo, hi


# The bf16 chunked front's block (fronts.cuh, mma_chunk_block; read from
# the source by test_mma_chunked_constants_match_the_source): 4, 8, 16
# (B4: 32) channels and, in B3 and B4, 256, 128 or 64 rows; the block
# shapes the transliteration takes, as (n-tiles, rows)
MIN_ROWS = 64
STAGES = 2         # kMmaStages: chunks in the block's ring of buffers
MMA_BLOCKS = [(4, 256), (2, 256), (1, 256), (2, 64), (1, 128), (8, 256),
              (4, 64)]
NAN_WORD = np.uint32(0x7FC0DEAD)   # a NaN's bits: shared memory not staged


def _frame_stride(dc):
    """``mma_chunk_geom``'s Lp: Dc words padded to 4 mod 8."""
    return dc + (12 - dc % 8) % 8


def _mma_geom(nt, rows, tc, t, d, stages=STAGES):
    """``mma_chunk_geom``, sizes in 32-bit words: KBc blocks of 8 taps a
    chunk, Tcp taps, Kr frames of Dc phases at Lp words a frame, nch
    chunks in a ring of nbuf = min(nch, stages) buffers of ``buf`` words
    at ``boff`` (the offsets' Tcp ints before them, padded to 16 bytes),
    B's ``bwords`` first in each."""
    kb = -(-t // 8)
    kbc = kb if tc >= t else tc // 8
    tcp = 8 * kbc
    dc = min(tcp, d)
    g = dict(KB=kb, KBc=kbc, Tcp=tcp, Dc=dc, Kr=rows + (tcp - 1) // d,
             Lp=_frame_stride(dc), nch=-(-kb // kbc))
    g["nbuf"] = min(g["nch"], stages)
    g["boff"] = (4 * tcp + 15) // 16 * 4
    g["bwords"] = 2 * kbc * nt * 16 * 2
    g["plane"] = g["Kr"] * g["Lp"]
    g["buf"] = g["bwords"] + 2 * g["plane"]
    return g


def _mma_smem_words(nt, rows, tc, t, d, stages=STAGES):
    """``mma_chunked_smem_bytes`` / 4: the offsets and buffers, or the
    output tile that reuses them."""
    g = _mma_geom(nt, rows, tc, t, d, stages)
    return max(g["boff"] + g["nbuf"] * g["buf"], rows * (8 * nt + 1))


def _stage_items(dc, kr, vec):
    """mma_chunk_stage's window copies in the threads' order: copy i takes
    frame k = i // nq and phases p..p+w-1, p = (i % nq)*w, w = 4 samples
    a copy where ``vec`` (16 bytes), else 1; nq = Dc/w copies a frame.
    Returns (p, k) of every sample copied, copy after copy."""
    w = 4 if vec else 1
    nq = dc // w
    i = np.arange(kr * nq)
    k, p = i // nq, (i % nq) * w
    return ((p[:, None] + np.arange(w)).ravel(),
            np.repeat(k, w))


def _bf16_words(re, im):
    """The bf16 pairs (re in the low 16 bits) of float32 planes, rounded to
    nearest even as __floats2bfloat162_rn, and the float32 values they
    hold."""
    def bits(v):
        b = torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16)
        return (b.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF,
                b.float().numpy())
    (br, fr), (bi, fi) = bits(re), bits(im)
    return br | (bi << 16), fr, fi


class _MmaBlock:
    """toeplitz_front_mma_chunked's block in its shared memory, 32-bit
    words filled with a NaN, with a tag a word (the chunk that staged it,
    -1 none) and the copies in flight: staging, the wait, the in-place
    split and the product's fragment reads, each checked against the
    buffers' use (a word the product reads was staged by its chunk; no copy
    or store lands in a buffer a split or product still reads)."""

    def __init__(self, x, table, c, t, tc, d, group, nt, rows, g0, grade,
                 stages=STAGES):
        self.x = (x.real.astype(np.float32), x.imag.astype(np.float32))
        self.words = table.reshape(-1).view(np.uint32)   # (2, KB, NT, 16, 2)
        self.nt_all = -(-c // 4)
        self.t, self.d, self.group, self.nt, self.rows = t, d, group, nt, rows
        self.g0, self.grade = g0, grade
        self.stages = stages
        self.g = _mma_geom(nt, rows, tc, t, d, stages)
        self.size = _mma_smem_words(nt, rows, tc, t, d, stages)
        self.mem = np.full(self.size, NAN_WORD, np.uint32)
        self.tag = np.full(self.size, -1, np.int64)
        self.pending = []        # (index array, values, chunk)
        self.counts = []         # per chunk: every B word and (p, k) once

    def buffer(self, c):
        return self.g["boff"] + (c % self.stages) * self.g["buf"]

    def stage(self, c):
        """mma_chunk_stage of chunk c into buffer c % stages: the copies
        in flight, the zero stores of n-tiles past NT at once."""
        g, nt = self.g, self.nt
        kb0 = c * g["KBc"]
        nkb = min(g["KBc"], g["KB"] - kb0)
        base = self.buffer(c)
        per = nt * 8                     # 16-byte copies a (part, kb) row
        i = np.arange(2 * nkb * per)
        part, r = i // (nkb * per), i % (nkb * per)
        kb, e = r // per, r % per
        dst = base + 2 * (((part * g["KBc"] + kb) * nt) * 16 + 2 * e)
        src = 2 * (((part * g["KB"] + kb0 + kb) * self.nt_all
                    + self.group * nt) * 16 + 2 * e)
        live = self.group * nt + e // 8 < self.nt_all
        four = np.arange(4)
        idx = [(dst[live][:, None] + four).ravel()]
        vals = [self.words[(src[live][:, None] + four).ravel()]]
        zero = (dst[~live][:, None] + four).ravel()
        assert zero.size == 0 or zero.max() < base + g["bwords"]
        self.store(zero, np.zeros(zero.size, np.uint32), c)
        vec = self.d % 4 == 0 and g["Dc"] % 4 == 0 and self.g0 % 4 == 0
        p, k = _stage_items(g["Dc"], g["Kr"], vec)
        s = self.g0 + 8 * kb0 + k * self.d + p
        inside = (s >= 0) & (s < self.x[0].shape[0])
        at = base + g["bwords"] + k * g["Lp"] + p
        for plane, xs in enumerate(self.x):
            v = np.where(inside, xs[np.clip(s, 0, xs.shape[0] - 1)], 0)
            idx.append(at + plane * g["plane"])
            vals.append(v.astype(np.float32).view(np.uint32))
        idx = np.concatenate(idx)
        # every B word of the chunk and every (phase, frame) once, inside
        # the chunk's buffer
        assert np.unique(idx).size == idx.size
        assert idx.min() >= base and idx.max() < base + g["buf"]
        assert np.unique(p * g["Kr"] + k).size == g["Dc"] * g["Kr"]
        self.counts.append(idx.size)
        self.pending.append((idx, np.concatenate(vals), c))

    def store(self, idx, vals, c):
        self.mem[idx] = vals
        self.tag[idx] = c

    def wait(self, c):
        """cp.async.wait_group (stages - 2) and __syncthreads: the copies of
        chunks up to c land, the later ones stay in flight."""
        for idx, vals, ci in self.pending:
            if ci <= c:
                self.store(idx, vals, ci)
        self.pending = [p for p in self.pending if p[2] > c]

    def check_free(self, idx):
        """No copy in flight or later store lands on words being read."""
        for pidx, _, _ in self.pending:
            assert not np.intersect1d(pidx, idx).size, "buffer overwritten"

    def split(self, c):
        """mma_chunk_split of chunk c's buffer in place: plane 0 (re)
        becomes hi, plane 1 (im) lo (bf16x3)."""
        g = self.g
        w0 = self.buffer(c) + g["bwords"]
        n = g["plane"]
        at = np.arange(w0, w0 + n)
        self.check_free(np.concatenate([at, at + n]))
        re = self.mem[at].view(np.float32)
        im = self.mem[at + n].view(np.float32)
        hi, fr, fi = _bf16_words(re, im)
        lo = _bf16_words(re - fr, im - fi)[0]
        self.mem[at] = hi
        if self.grade == "bf16x3":
            self.mem[at + n] = lo

    def product(self, c, off, acc):
        """mma_product over chunk c's blocks of 8 taps in ascending kb:
        lane (gid, tig) of warp w reads rows r = w*32 + gid + 16*mt (+8)
        at off[8*kb + tig] + r*Lp and off[8*kb + tig + 4] + r*Lp, B entry
        4*(gid/2) + tig of each n-tile; every word read was staged by
        chunk c."""
        g, nt, rows = self.g, self.nt, self.rows
        kb0 = c * g["KBc"]
        nkb = min(g["KBc"], g["KB"] - kb0)
        base = self.buffer(c)
        w0 = base + g["bwords"]
        r = np.arange(rows)
        for kb in range(nkb):
            a_at = (w0 + off[8 * kb + np.arange(8)][None, :]
                    + g["Lp"] * r[:, None])
            lo_at = a_at + g["plane"]
            e = np.arange(16)
            b_at = base + 2 * ((kb * nt + np.arange(nt))[:, None] * 16
                               + e)[..., None] + np.arange(2)
            bl_at = b_at + 2 * g["KBc"] * nt * 16
            reads = [a_at, b_at, bl_at] + (
                [lo_at] if self.grade == "bf16x3" else [])
            for at in reads:
                assert at.max() < base + g["buf"]
                assert (self.tag[at] == c).all(), "read a word not staged"
                self.check_free(at.ravel())
            xh = _pairs(self.mem[a_at])
            xh = xh[0] + 1j * xh[1]                        # (rows, 8)
            if self.grade == "bf16x3":
                xl = _pairs(self.mem[lo_at])
                xl = xl[0] + 1j * xl[1]
            # entry [nt][4*cl + q][i]: (gr, -gi) of channel 4*nt + cl at
            # tap q + 4*i of the block
            bh, bl = (_pairs(self.mem[at]) for at in (b_at, bl_at))
            gh = (bh[0] - 1j * bh[1]).reshape(nt, 4, 4, 2)
            gl = (bl[0] - 1j * bl[1]).reshape(nt, 4, 4, 2)
            gh = gh.transpose(0, 1, 3, 2).reshape(4 * nt, 8)   # (ch, tap)
            gl = gl.transpose(0, 1, 3, 2).reshape(4 * nt, 8)
            y = xh @ gh.T + xh @ gl.T
            if self.grade == "bf16x3":
                y = y + xl @ gh.T
            acc += y

    def run(self):
        """The kernel's walk: the offsets, chunks 0 .. stages-2 in flight,
        then per chunk c the wait for it, chunk c + stages - 1 in flight
        into chunk c - 1's buffer, the split and the product; the
        accumulators (rows, 4*nt) as complex128."""
        g = self.g
        tl = np.arange(g["Tcp"])
        off = (tl // self.d) * g["Lp"] + tl % self.d
        self.store(np.arange(g["Tcp"]), off.astype(np.uint32), -2)
        acc = np.zeros((self.rows, 4 * self.nt), np.complex128)
        for c in range(min(self.stages - 1, g["nch"])):
            self.stage(c)
        for c in range(g["nch"]):
            self.wait(c)
            if c + self.stages - 1 < g["nch"]:
                self.stage(c + self.stages - 1)
            self.split(c)
            self.product(c, off, acc)
        assert not self.pending
        tile = self.rows * (8 * self.nt + 1)
        assert tile <= self.size
        return acc


def _toeplitz_front_mma(x, table, c, t, tc, d, group, nt_block, g0, grade,
                        rows=TILE, stages=STAGES):
    """``toeplitz_front_mma_chunked`` for channel group ``group`` of
    4*nt_block channels and ``rows`` rows, a ring of ``stages`` buffers:
    the block's accumulators (rows, 4*nt_block), complex128 (_MmaBlock)."""
    return _MmaBlock(x, table, c, t, tc, d, group, nt_block, rows, g0,
                     grade, stages).run()


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
        ftab = dense_f32_tables(torch.from_numpy(bank)).numpy()
        got = np.concatenate([
            _toeplitz_front(x.astype(np.complex64), ftab, c, t, tc, d, grp,
                            g0)[0]
            for grp in range(-(-c // _f32_channels(c)))], axis=1)[:m, :c].T
    else:
        table = dense_mma_tables(torch.from_numpy(bank)).numpy()
        got = np.concatenate([
            _toeplitz_front_mma(x, table, c, t, tc, d, grp, 4, g0, grade)
            for grp in range(-(-c // 16))], axis=1)[:m, :c].T
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-6


def _mma_block(c, m, max_ch, min_rows, overlap, sms):
    """``mma_chunk_block`` on a card of ``sms`` SMs: the fewest of 4, 8, 16
    (32) channels that hold C and kTile rows; then half the rows (down to
    min_rows), then half the channels (down to 4), while the grid of
    ceil(M / (rows - overlap)) x ceil(C / ch) blocks fits one wave (M < 1:
    any M, the widest block)."""
    ch, rows = 4, TILE
    while ch < c and ch < max_ch:
        ch *= 2
    if m < 1:
        return ch, rows

    def blocks(ch_, rows_):
        return -(-m // (rows_ - overlap)) * -(-c // ch_)
    while rows > min_rows and blocks(ch, rows // 2) <= sms:
        rows //= 2
    while ch > 4 and blocks(ch // 2, rows) <= sms:
        ch //= 2
    return ch, rows


# (C, T, D, Tc) for the bf16 chunked block at every shape: T < D in one
# chunk, a chunk spanning D (all phases) with a short last one, chunks
# shorter than D, a ragged last channel group
MMA_CASES = [(3, 65, 256, 65), (9, 61, 4, 16), (5, 257, 128, 96)]


def _mma_case(c, t, d, rows, seed):
    """A bank of C channels and T taps, and a signal whose second block of
    ``rows`` rows (g0 = rows*D) ends after 40 outputs."""
    taps = _lowpass(t, 0.05)
    shifts = [-1000.0 / (2 * c + 3) * i for i in range(c)]
    bank = make_complex_tap_bank(taps, shifts, 1000.0)
    n = t + d * (rows + 40 - 1)
    return bank, _window_signal(n, seed=seed)


@pytest.mark.parametrize("grade", ["bf16x3", "bf16x2"])
@pytest.mark.parametrize("nt,rows", MMA_BLOCKS)
@pytest.mark.parametrize("c,t,d,tc", MMA_CASES)
def test_mma_chunked_block_shapes_match_plain(grade, nt, rows, c, t, d, tc):
    """toeplitz_front_mma_chunked transliterated at every block shape the
    launchers take (4, 8, 16 and 32 channels; 256, 128 and 64 rows), its
    double-buffered walk in its shared-memory layout: within 1e-6 of
    max|y| of the plain version at the grade, every channel group, at the
    second block of a signal that ends inside it."""
    bank, x = _mma_case(c, t, d, rows, seed=t + d + rows)
    want = channelize_reference(
        TCA(torch.from_numpy(x.real.astype(np.float32)),
            torch.from_numpy(x.imag.astype(np.float32))),
        torch.from_numpy(bank), d, grade)
    want = (want.re.double().numpy()
            + 1j * want.im.double().numpy())[:, rows:]
    table = dense_mma_tables(torch.from_numpy(bank)).numpy()
    got = np.concatenate([
        _toeplitz_front_mma(x, table, c, t, tc, d, grp, nt, rows * d, grade,
                            rows)
        for grp in range(-(-c // (4 * nt)))], axis=1)[:40, :c].T
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("stages", [STAGES, 3])
@pytest.mark.parametrize("nt,rows", MMA_BLOCKS)
def test_mma_chunks_equal_one_chunk_transliterated(nt, rows, stages):
    """The bf16 chunked walk gives every output the one-chunk walk's
    fragments in the same order: the transliterated sums (exact in
    float64, one kb after another) of chunks of 16, 24 and 8 taps equal
    those of one chunk bit for bit, for T >= D and T < D, at every block
    shape, on every channel group, in the kernel's ring and in a ring of
    three (the staging, split and offsets of each chunk index the same
    samples and taps; no copy lands in a buffer being read)."""
    grade = "bf16x3"
    for c, t, d in ((9, 61, 4), (6, 40, 64)):
        bank, x = _mma_case(c, t, d, rows, seed=5 * t + d)
        table = dense_mma_tables(torch.from_numpy(bank)).numpy()
        for grp in range(-(-c // (4 * nt))):
            one = _toeplitz_front_mma(x, table, c, t, t, d, grp, nt,
                                      rows * d, grade, rows, stages)
            assert not np.isnan(one).any()
            for chunk in (16, 24, 8):
                got = _toeplitz_front_mma(x, table, c, t, chunk, d, grp, nt,
                                          rows * d, grade, rows, stages)
                assert np.array_equal(got, one), (c, t, d, grp, chunk)


@pytest.mark.parametrize("dc,kr", [(1, 300), (4, 319), (7, 70), (8, 64),
                                   (24, 257), (72, 257), (128, 65),
                                   (33, 67)])
def test_mma_staging_visits_every_item_once(dc, kr):
    """mma_chunk_stage's window copies (Kr frames of Dc phases, 4 samples a
    16-byte copy where the runs align, else 1) visit every (phase, frame)
    once; and at the frame stride Lp (Dc padded to 4 mod 8) the 32 words
    an A fragment load reads (8 rows x 4 taps, D >= 4 or D = Dc) fall on
    32 banks, the two that a 16-byte copy of a quarter-warp writes at most
    two words of a bank."""
    for vec in (False, True) if dc % 4 == 0 else (False,):
        p, k = _stage_items(dc, kr, vec)
        assert np.array_equal(np.sort(k * dc + p), np.arange(dc * kr))
    lp = _frame_stride(dc)
    assert lp % 8 == 4 and dc <= lp < dc + 8
    d = dc
    off = lambda t: (t // d) * lp + t % d
    gid, tig = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    for kb in range(min(4, -(-dc // 8))):
        for r0 in (0, 32, 224):
            if d >= 4:
                words = off(8 * kb + tig) + (r0 + gid) * lp
                assert np.unique(words % 32).size == 32
    if dc % 4 == 0:   # a quarter-warp's eight 16-byte copies
        p, k = _stage_items(dc, kr, True)
        starts = (k * lp + p)[::4]
        for q in range(0, min(starts.size, 256), 8):
            groups = (starts[q:q + 8] // 4) % 8
            assert np.bincount(groups).max() <= 2


def test_mma_chunked_block_choices():
    """mma_chunk_block on the H100's 132 SMs at the paths of
    chip_smoke.py's phase 11: the narrowband scanner (B1, 33 tiles of 255
    outputs) takes 4-channel blocks, 132 of them; the long filter keeps 16
    channels; am_d128 (B3-dense, C = 8, 8192 outputs) 8 channels and 64
    rows, 128 blocks, no zero channel; the transmux at Q = 127 (B4, C = 32)
    one 32-channel block of 256 rows a tile; am_demod at D = 256 (C = 1,
    4096 outputs) 4 channels and 64 rows; fm_demod there 4 channels."""
    fm = dict(max_ch=16, min_rows=TILE, overlap=1, sms=132)
    am = dict(max_ch=16, min_rows=MIN_ROWS, overlap=0, sms=132)
    b4 = dict(max_ch=32, min_rows=MIN_ROWS, overlap=0, sms=132)
    assert _mma_block(16, 8192, **fm) == (4, 256)
    assert _mma_block(16, (1 << 20) // 4, **fm) == (16, 256)
    assert _mma_block(8, 8192, **am) == (8, 64)
    assert _mma_block(32, 32768, **b4) == (32, 256)
    assert _mma_block(1, 4096, **am) == (4, 64)
    assert _mma_block(1, 4096, **fm) == (4, 256)
    assert _mma_block(5, 0, **b4) == (8, 256)   # any M: rows kTile


def test_mma_chunked_constants_match_the_source():
    """The geometry (a frame-major window at Lp words a frame), the block
    rule and the staging order the bf16 transliteration mirrors are
    fronts.cuh's and the launchers' (the FM
    chain keeps kTile rows; B3 and B4 go down to kMmaMinRows; B4 to 32
    channels)."""
    src = (_build.CSRC / "fronts.cuh").read_text()
    consts = dict(re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M))
    assert int(consts["kMmaMinRows"]) == MIN_ROWS
    assert int(consts["kMmaStages"]) == STAGES
    for line in (
            "g.KBc = Tc >= T ? kb : Tc / 8;",
            "g.Kr = rows + (g.Tcp - 1) / D;",
            "g.Lp = g.Dc + (12 - g.Dc % 8) % 8;",
            "g.nbuf = g.nch < kMmaStages ? g.nch : kMmaStages;",
            "cp_async_wait<kMmaStages - 2>();",
            "g.boff = ((size_t)g.Tcp * sizeof(int) + 15) / 16 * 16;",
            "g.bbytes = 2 * (size_t)g.KBc * nt * 16 * sizeof(uint2);",
            "g.buf = g.bbytes + 2 * (size_t)g.Kr * g.Lp * sizeof(uint32_t);",
            "off[t] = (t / D) * g.Lp + t % D;",
            "const int k = i / nq, p = (i - k * nq) * w;",
            "const bool vec = D % 4 == 0 && g.Dc % 4 == 0 && g0 % 4 == 0 &&",
            "while (b.ch < C && b.ch < max_ch) b.ch *= 2;",
            "while (b.rows > min_rows && blocks(b.ch, b.rows / 2) <= sms) "
            "b.rows /= 2;",
            # the dense launchers take the default min_ch: 4 channels
            "int overlap, int min_ch = 4) {",
            "MmaBlock b{min_ch, kTile};",
            "while (b.ch > min_ch && blocks(b.ch / 2, b.rows) <= sms) "
            "b.ch /= 2;"):
        assert line in src, line
    for lib, call in (
            ("fm_chain", "gsdr::mma_chunk_block(C, M, kCG, kTile, "
                         "kTile - kOut)"),
            ("am_chain", "gsdr::mma_chunk_block(C, M, kCG, "
                         "gsdr::kMmaMinRows, 0)"),
            ("channelize", "gsdr::mma_chunk_block(C, M, 32, "
                           "gsdr::kMmaMinRows, 0)")):
        assert call in (_build.CSRC / f"{lib}.cu").read_text(), lib


def test_dense_variants_apply_to_the_sources():
    """Every edit of tools/dense_variants.py (the variants of the bf16
    chunked front timed on the card) finds its text once in the sources."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "dense_variants", _build.CSRC.parents[2] / "tools" /
        "dense_variants.py")
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    for name, edits in variants.VARIANTS.items():
        for source, text, _ in edits:
            assert (_build.CSRC / source).read_text().count(text) == 1, name


# (C, T, D, Tc) beyond CHUNK_CASES for the f32 block: am_d's 8 channels (a
# block of 8, 64 threads) and the transmux's 32 (a block of 32, 256
# threads), each in chunks whose last one is shorter than the rest
F32_CASES = [(8, 61, 4, 24), (32, 256, 32, 56)]


def _f32_case(c, t, d, seed):
    """A bank of C channels, T taps and the second block's signal, as
    test_chunked_front_transliteration_matches_plain makes them."""
    taps = _lowpass(t, 0.05)
    shifts = [-1000.0 / (2 * c + 3) * i for i in range(c)]
    bank = make_complex_tap_bank(taps, shifts, 1000.0)
    n = t + d * (TILE + 100 - 1)
    return bank, _window_signal(n, seed=seed).astype(np.complex64)


@pytest.mark.parametrize("c,t,d,tc", F32_CASES)
def test_f32_dense_block_of_8_and_32_channels_matches_plain(c, t, d, tc):
    """The f32 block transliterated at C = 8 and C = 32, whose blocks take
    8 and 32 channels: within 1e-6 of max|y| of the plain version at f32,
    at the second block of a signal that ends inside it."""
    bank, x = _f32_case(c, t, d, seed=t + d)
    assert _f32_channels(c) == c
    want = channelize_reference(
        TCA(torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy())),
        torch.from_numpy(bank), d, "f32")
    want = (want.re.double().numpy() + 1j * want.im.double().numpy())[:, TILE:]
    ftab = dense_f32_tables(torch.from_numpy(bank)).numpy()
    got = _toeplitz_front(x, ftab, c, t, tc, d, 0, TILE * d)[0][:100].T
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("cols", WIDTHS)
@pytest.mark.parametrize("c,t,d,tc", CHUNK_CASES + F32_CASES)
def test_f32_dense_chunks_equal_one_chunk_transliterated(c, t, d, tc, cols):
    """The f32 block's double-buffered chunk walk gives every output the
    one-chunk walk's sums bit for bit (the same fmaf over ascending t from
    zero), at the case's chunk and at 8 taps, on every channel block, in
    tiles of 4 and of 8 channels; and the output tile holds every row and
    channel (no NaN of unstaged shared memory)."""
    bank, x = _f32_case(c, t, d, seed=3 * t + d)
    ftab = dense_f32_tables(torch.from_numpy(bank)).numpy()
    for grp in range(-(-c // _f32_channels(c))):
        one, re1, im1 = _toeplitz_front(x, ftab, c, t, t, d, grp, TILE * d,
                                        cols)
        assert not np.isnan(one).any()
        for chunk in (tc, 8):
            _, re2, im2 = _toeplitz_front(x, ftab, c, t, chunk, d, grp,
                                          TILE * d, cols)
            assert np.array_equal(re1.view(np.int32), re2.view(np.int32))
            assert np.array_equal(im1.view(np.int32), im2.view(np.int32))


@pytest.mark.parametrize("c", [1, 8, 16, 32, 40])
def test_dense_f32_tables_layout(c):
    """dense_f32_tables against make_complex_tap_bank's rows bit for bit:
    (ceil(C/8), T, 8, 2) float32, entry [g][t][cl] = (row 4c, row 4c + 2)
    of the bank's (4C, T) view at column t for c = 8g + cl, zeros past C
    (a block's group of 8 channels of one tap is 64 contiguous bytes)."""
    t = 13
    rng = np.random.default_rng(c)
    bank = make_complex_tap_bank(
        rng.standard_normal(t).astype(np.float32),
        [-2e3 * i - 137.0 for i in range(c)], 1e5)
    table = dense_f32_tables(torch.from_numpy(bank))
    ng = -(-c // 8)
    assert table.dtype == torch.float32 and table.is_contiguous()
    assert tuple(table.shape) == (ng, t, 8, 2)
    rows = bank.reshape(4 * c, t)
    tab = table.numpy()
    for ch in range(8 * ng):
        g, cl = divmod(ch, 8)
        if ch < c:
            assert np.array_equal(tab[g, :, cl, 0].view(np.int32),
                                  rows[4 * ch].view(np.int32))
            assert np.array_equal(tab[g, :, cl, 1].view(np.int32),
                                  rows[4 * ch + 2].view(np.int32))
        else:
            assert not tab[g, :, cl].any()


def test_dense_f32_tables_cached_per_tensor():
    """The table is built once per bank tensor, kept beside its tensor-core
    table, and rebuilt after the bank is written in place."""
    bank = torch.from_numpy(make_complex_tap_bank(
        _lowpass(9, 0.1), [0.0, -250.0, 300.0], 1000.0))
    first = dense_f32_tables(bank)
    assert dense_f32_tables(bank) is first
    mma = dense_mma_tables(bank)
    assert dense_f32_tables(bank) is first and dense_mma_tables(bank) is mma
    bank.mul_(2.0)
    again = dense_f32_tables(bank)
    assert again is not first
    assert torch.equal(again, 2.0 * first)


def test_f32_dense_constants_match_the_source():
    """The constants and rules the f32 transliteration mirrors equal
    fronts.cuh's: tiles of 4 rows, two warps of rows for each 4 or 8
    channels, blocks of 8, 16 or 32 channels by C, the launchers' widths
    (the FM chain 4 in one chunk and 8 chunked, unrolled by 1 and 4; the
    AM chain and the channelizer 4 in a block of 8 and else 8), and the
    window's odd phase stride."""
    src = (_build.CSRC / "fronts.cuh").read_text()
    consts = dict(re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M))
    assert {n: int(consts[n]) for n in ("kTile", "kDenseRows")} == {
        "kTile": TILE, "kDenseRows": ROWS}
    for line in ("return C >= 1 && C <= 8 ? 8 : C >= 1 && C <= 16 ? 16 : 32;",
                 "return kTile / kDenseRows * (ch / cols);",
                 "return chunked ? 8 : 4;", "return chunked ? 4 : 1;",
                 "return ch == 8 ? 4 : 8;",
                 "return (kTile + (Tc - 1) / D) | 1;"):
        assert line in src
    assert [_f32_channels(c) for c in (1, 8, 9, 16, 17, 40)] == \
        [8, 8, 16, 16, 32, 32]
    assert [_f32_threads(ch, _dense_cols(ch)) for ch in (8, 16, 32)] == \
        [128, 128, 256]
    assert [_f32_threads(ch, 4) for ch in (8, 16, 32)] == [128, 256, 512]
    assert _phase_stride_f32(24, 128) == 257 and _phase_stride_f32(64, 4) \
        == 271


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
