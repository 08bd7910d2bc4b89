"""The PFB front at grids whose bank, taps or window do not fit one block
of the card: a numpy transliteration of ``csrc/fronts.cuh``'s PFB
fronts (``pfb_front`` and ``pfb_front_chunked`` at f32: the fold once a
block into the A tile, the register tiles, the double-buffered steps in
the kernels' shared-memory layout; ``pfb_front_mma_chunked``: lane
chunks, u-ranges of fold taps, the split after the whole fold) against
the plain version, the cheap check of the kernels' index logic that the
card tests then hold bit for bit; and the port against the JAX
package on the CPU at those grids (the land-mobile NFM and VHF airband
receivers, and the plain version against JAX's PFB kernel interpreted)."""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.kernels.fm_chain_pallas import pfb_fm_chain_pallas
from gsdr_tpu.pipelines import AmReceiver as JAm
from gsdr_tpu.pipelines import FmChannelizer as JFm
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels.chain import (
    PFB_ROWS,
    graded_uniform_front,
    pfb_chunk_taps,
    pfb_f32_tables,
    pfb_mma_chunk_tables,
    split_bf16,
)
from gsdr_tpu_torch.kernels.fm_chain import pfb_fm_chain_reference
from gsdr_tpu_torch.ops.pfb import _dft_bank_stacked, _poly_taps
from gsdr_tpu_torch.utils.convert import (
    am_receiver_from_fields,
    fm_channelizer_from_fields,
    state_to_numpy,
)

TILE = 256        # outputs a block (fronts.cuh kTile)
CG = 16           # channels a block at f32 (kCG)
NTB = 8           # n-tiles of 4 channels a block at the bf16 grades (kPfbNT)
PHASES = 16       # phases a group (kPhaseChunk)


def _lowpass(num_taps, cutoff):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff * n) * np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# The chunked staging, transliterated
# ---------------------------------------------------------------------------

def _chunks(k, d, lanes):
    """The chunks a block walks for a plan of ``lanes`` lanes
    (pfb_chunk_blocks): (p0, glanes, ka, kz, nk) for each group of
    min(D, 16) phases starting at p0, of glanes = np*P lanes, and each
    chunk of nk 8-lane blocks there, lanes kappa in [ka, kz)."""
    p, dc = k // d, min(d, PHASES)
    nkb = min(-(-lanes // 8), -(-dc * p // 8))
    for p0 in range(0, d, dc):
        glanes = min(dc, d - p0) * p
        kbc = -(-glanes // 8)
        for b0 in range(0, kbc, nkb):
            nk = min(nkb, kbc - b0)
            yield p0, glanes, 8 * b0, min(8 * (b0 + nk), glanes), nk


def _lane_span(p, ka, kz):
    """(pa, pb, s_lo, s_hi): the chunk's first and last phase in its group
    and the s its window's frames cover (all P where it spans phases)."""
    pa, pb = ka // p, (kz - 1) // p
    if pa == pb:
        return pa, pb, ka % p, (kz - 1) % p
    return pa, pb, 0, p - 1


def _stage(x, g0, d, f0, nfr, p_first, npc):
    """A u-range's window: (nfr, npc) samples x[g0 + (f0 + k)*D + p_first +
    pl], zeros outside x."""
    kk, pl = np.meshgrid(np.arange(nfr), np.arange(npc), indexing="ij")
    g = g0 + (f0 + kk) * d + p_first + pl
    inside = (g >= 0) & (g < x.shape[0])
    return np.where(inside, x[np.clip(g, 0, x.shape[0] - 1)], 0)


def _fmaf(a, b, c):
    """float32 fma, each product exact in float64, one rounding after the
    sum (a second rounding to float32: the emulation both plans share)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


# pfb_front's and pfb_front_chunked's own constants (fronts.cuh; read
# from the source by test_f32_front_constants_match_the_source)
PFB_THREADS = 512   # threads a PFB block (kPfbThreads)
FOLD_LANES = 16     # lanes pfb_front's A tile folds (kPfbFoldLanes)
TILE_ROWS = 4       # rows of a thread's register tile (kPfbRows)
WIDE_ROWS = 8       # rows of a consumer's tile, chunked (kPfbWideRows)
CONSUMERS = 256     # threads that multiply, chunked (kPfbConsumers)
TILE_COLS = 4       # channels of a thread's register tile (kPfbCols)
PFB_CH = 4 * NTB    # channels a PFB block (kPfbCh)
OUT_STRIDE = 8 * NTB + 1   # the output tile's row stride


class _Smem:
    """A block's dynamic shared memory as flat float32 regions at the
    kernel's offsets; a write or read outside its region raises."""

    def __init__(self, layout):
        self.regions = {}
        off = 0
        for name, n in layout:
            self.regions[name] = (off, n)
            off += n
        self.words = np.full(off, np.nan, np.float32)

    def view(self, name):
        off, n = self.regions[name]
        return self.words[off:off + n]

    def at(self, name, idx):
        idx = np.asarray(idx)
        assert idx.size == 0 or (idx.min() >= 0 and idx.max() <
                                 self.regions[name][1]), name
        return idx + self.regions[name][0]


def _stage_window(mem, name, base, x, g0, d, f0, p_first, npc, nfr):
    """pfb_stage_window: xw[(plane*npc + pl)*nfr + k] of a region from
    word ``base``, zeros outside x."""
    staged = [_stage(xs, g0, d, f0, nfr, p_first, npc)
              for xs in (x.real.astype(np.float32),
                         x.imag.astype(np.float32))]
    k, pl = np.meshgrid(np.arange(nfr), np.arange(npc), indexing="ij")
    for plane, w in enumerate(staged):
        idx = base + (plane * npc + pl) * nfr + k
        mem.words[mem.at(name, idx)] = w


def _stage_lanes(mem, gb_at, hs_at, el, ftab, hp, k, d, group, p0, ka, kz,
                 u0, u1):
    """pfb_stage_lanes: the bank rows of lanes [ka, kz) of the group at p0
    from channel group ``group`` of the f32 table (pfb_f32_tables) to
    gb[(kappa - ka)*PFB_CH + cl] = (G[c, v], G[c, K+v]), a lane's 64
    floats by 16-byte copies (gb_at: (region, base word), or None), and
    their taps u0..u1-1 to hs[(u - u0)*L + kappa - ka] (hs_at, or None)."""
    p = k // d
    kap = np.arange(ka, kz)
    v = p0 + kap // p + (kap % p) * d
    if gb_at is not None:
        name, base = gb_at
        q = np.arange(PFB_CH * 2 // 4)           # 16-byte copies of a row
        dst = (base + (kap - ka)[:, None, None] * PFB_CH * 2
               + 4 * q[None, :, None] + np.arange(4)[None, None, :])
        src = ftab[group].reshape(k, -1)[v][:, :, None]
        mem.words[mem.at(name, dst)] = src.reshape(len(v), -1, 4)
    if hs_at is not None:
        name, base = hs_at
        for u in range(u0, u1):
            idx = base + (u - u0) * el + kap - ka
            mem.words[mem.at(name, idx)] = hp[u, v]


def _fold(mem, a_at, win_at, plane, nfr, taps_at, tstride, by_v, p, d, p0,
          ka, nl, kbase, span, u0, u1):
    """pfb_fold: warp w folds lanes j = w, w + 16, ... of [ka, ka + nl),
    thread (lane) rows lane + 32*i, fmaf in ascending u from zero (u0 = 0)
    or from the A tile's partials, into a[j][plane][row]."""
    pa, _, s_lo, _ = span
    rows = np.arange(TILE)
    for j in range(nl):
        kap = ka + j
        pl, s = kap // p, kap % p
        xr = win_at[1] + (pl - pa) * nfr + (s - s_lo) + rows
        xi = xr + plane
        h = taps_at[1] + (p0 + pl + s * d if by_v else kap - kbase)
        at = a_at[1] + j * 2 * TILE + rows
        a_idx = mem.at(a_at[0], np.stack([at, at + TILE]))
        if u0 == 0:
            fr = fi = np.zeros(TILE, np.float32)
        else:
            fr, fi = mem.words[a_idx]
        for u in range(u1 - u0):
            hu = mem.words[mem.at(taps_at[0], h + u * tstride)]
            fr = _fmaf(hu, mem.words[mem.at(win_at[0], xr + u * p)], fr)
            fi = _fmaf(hu, mem.words[mem.at(win_at[0], xi + u * p)], fi)
        mem.words[a_idx] = np.stack([fr, fi])


def _tiles(rows=TILE_ROWS):
    """pfb_tile_init<rows>: each thread's rows r0 + i and channels cb +
    (c & 1) + 2*rows*(c >> 1), as (threads, rows) and (threads, 4) arrays,
    and cb; every thread at 4 rows, the consumers at 8."""
    t = np.arange(PFB_THREADS if rows == TILE_ROWS else CONSUMERS)
    lane, warp = t & 31, t >> 5
    groups = 32 // rows
    r0 = 32 * (warp % 8) + rows * (lane % groups)
    cb = 16 * (warp // 8) + 2 * (lane // groups)
    c = np.arange(TILE_COLS)
    return (r0[:, None] + np.arange(rows)[None, :],
            cb[:, None] + (c & 1)[None, :] + 2 * rows * (c >> 1)[None, :], cb)


def _product(mem, acc, a_at, gb_at, nl):
    """pfb_product: each thread's tile += lanes j < nl, lane after lane:
    its rows' (A_re, A_im) and two float4 of bank, (G[c, v], G[c, K+v])
    of its two channel pairs; the im row as (-G[c, K+v], G[c, v])."""
    rows, _, cb = _tiles(acc[0].shape[1])
    re, im = acc
    for j in range(nl):
        ar = mem.words[mem.at(a_at[0], a_at[1] + j * 2 * TILE + rows)]
        ai = mem.words[mem.at(a_at[0], a_at[1] + j * 2 * TILE + TILE + rows)]
        pair = [mem.words[mem.at(gb_at[0], gb_at[1] + j * PFB_CH * 2 + 2 * cb
                                 [:, None] + off + np.arange(4)[None, :])]
                for off in (0, 4 * rows.shape[1])]
        gr = np.stack([pair[0][:, 0], pair[0][:, 2], pair[1][:, 0],
                       pair[1][:, 2]], 1)
        gi = np.stack([pair[0][:, 1], pair[0][:, 3], pair[1][:, 1],
                       pair[1][:, 3]], 1)
        re = _fmaf(gr[:, None, :], ar[:, :, None],
                   _fmaf(gi[:, None, :], ai[:, :, None], re))
        im = _fmaf(-gi[:, None, :], ar[:, :, None],
                   _fmaf(gr[:, None, :], ai[:, :, None], im))
    return re, im


def _tile_out(acc):
    """pfb_tile_out: the register tiles to the output tile (TILE,
    OUT_STRIDE), every (row, channel) written once; returns (TILE,
    PFB_CH) re and im."""
    rows, cols, _ = _tiles(acc[0].shape[1])
    out = np.full((TILE, OUT_STRIDE), np.nan, np.float32)
    hits = np.zeros((TILE, PFB_CH), int)
    np.add.at(hits, (rows[:, :, None], cols[:, None, :]), 1)
    assert (hits == 1).all()
    out[rows[:, :, None], 2 * cols[:, None, :]] = acc[0]
    out[rows[:, :, None], 2 * cols[:, None, :] + 1] = acc[1]
    return out[:, 0:2 * PFB_CH:2], out[:, 1:2 * PFB_CH:2]


def _chunk_lanes(k, d, lanes):
    dc, p = min(d, PHASES), k // d
    nkb = min(-(-lanes // 8), -(-dc * p // 8))
    return min(8 * nkb, dc * p), nkb


def _chunk_frames(k, d, nkb, uc, rows=TILE):
    """pfb_chunk_frames for a block of ``rows`` output rows."""
    p = k // d
    span = 8 * nkb - 1 if d == 1 and 8 * nkb < p else p - 1
    return (uc - 1) * p + span + rows


def _pfb_front_f32(x, hp, bank, d, group, g0, lanes, uc):
    """``pfb_front`` (the plan (K, Q)) or ``pfb_front_chunked`` for the
    block of output rows g0 + r*D and channels group*32 on, from the
    bank's f32 table (``pfb_f32_tables``), in the kernel's shared-memory
    layout (``_Smem``: its regions, sized as
    pfb_smem_bytes and pfb_chunk_bytes size them) and step order: each
    step's staging into the other buffer before the current one is folded
    (the double buffering), the fold into the A tile once for all 32
    channels, the register tiles' products lane after lane. Returns (TILE,
    32) re and im, float32."""
    q, k = hp.shape
    p = k // d
    dc = min(d, PHASES)
    ftab = pfb_f32_tables(torch.from_numpy(bank)).numpy()
    acc = (np.zeros((PFB_THREADS, TILE_ROWS, TILE_COLS), np.float32),
           np.zeros((PFB_THREADS, TILE_ROWS, TILE_COLS), np.float32))
    if lanes >= k and uc >= q:        # pfb_front
        kr = TILE + q * p - 1
        wsize = 2 * dc * kr
        mem = _Smem([("gb", k * PFB_CH * 2),
                     ("a", 2 * FOLD_LANES * 2 * TILE),
                     ("hps", -(-q * k // 4) * 4),
                     ("win", (2 if d > PHASES else 1) * wsize)])
        for p0 in range(0, d, dc):
            _stage_lanes(mem, ("gb", p0 * p * PFB_CH * 2), None, 0, ftab, hp,
                         k, d, group, p0, 0, min(dc, d - p0) * p, 0, 0)
        assert mem.words.size * 4 <= _smem_bytes(k, q, d, lanes, uc)
        mem.words[mem.at("hps", np.arange(q * k))] = hp.ravel()
        _stage_window(mem, "win", 0, x, g0, d, 0, 0, dc, kr)
        step = 0
        for p0 in range(0, d, dc):
            np_, gl = min(dc, d - p0), min(dc, d - p0) * p
            if p0 + dc < d:
                _stage_window(mem, "win", ((p0 // dc + 1) & 1) * wsize, x, g0,
                              d, 0, p0 + dc, min(dc, d - p0 - dc), kr)
            xw = ("win", ((p0 // dc) & 1) * wsize)
            for ka in range(0, gl, FOLD_LANES):
                nl = min(FOLD_LANES, gl - ka)
                at = ("a", (step & 1) * FOLD_LANES * 2 * TILE)
                _fold(mem, at, xw, np_ * kr, kr, ("hps", 0), k, True, p, d,
                      p0, ka, nl, 0, (0, 0, 0, 0), 0, q)
                acc = _product(mem, acc, at,
                               ("gb", (p0 * p + ka) * PFB_CH * 2), nl)
                step += 1
        return _tile_out(acc)
    el, nkb = _chunk_lanes(k, d, lanes)      # pfb_front_chunked
    uc = min(uc, q)
    tsize = -(-uc * el // 4) * 4
    npc_max = min((el + p - 2) // p + 1, dc)
    ssize = tsize + 2 * npc_max * _chunk_frames(k, d, nkb, uc)
    mem = _Smem([("gb", 2 * el * PFB_CH * 2), ("a", 2 * el * 2 * TILE),
                 ("stage", 2 * ssize)])
    acc = tuple(np.zeros((CONSUMERS, WIDE_ROWS, TILE_COLS), np.float32)
                for _ in range(2))
    assert mem.words.size * 4 <= _smem_bytes(k, q, d, lanes, uc)
    steps = []
    for p0 in range(0, d, dc):
        gl = min(dc, d - p0) * p
        for ka in range(0, gl, el):
            for u0 in range(0, q, uc):
                steps.append((p0, ka, min(ka + el, gl), u0, min(q, u0 + uc)))

    def issue(st, sb):
        p0, ka, kz, u0, u1 = st
        pa, pb, s_lo, s_hi = _lane_span(p, ka, kz)
        _stage_lanes(mem, None, ("stage", sb * ssize), el, ftab, hp, k, d,
                     group, p0, ka, kz, u0, u1)
        _stage_window(mem, "stage", sb * ssize + tsize, x, g0, d,
                      u0 * p + s_lo, p0 + pa, pb - pa + 1,
                      (u1 - 1 - u0) * p + s_hi - s_lo + TILE)

    # the producers' steps; the consumers multiply chunk c from buffer c & 1
    # once its last u-range is folded (in the kernel, while the producers
    # fold chunk c + 1: the values do not depend on the overlap)
    issue(steps[0], 0)
    ci = 0
    for si, cur in enumerate(steps):
        p0, ka, kz, u0, u1 = cur
        if u0 == 0:
            _stage_lanes(mem, ("gb", (ci & 1) * el * PFB_CH * 2), None, 0,
                         ftab, hp, k, d, group, p0, ka, kz, 0, 0)
        if si + 1 < len(steps):
            issue(steps[si + 1], (si + 1) & 1)
        span = _lane_span(p, ka, kz)
        nfr = (u1 - 1 - u0) * p + span[3] - span[2] + TILE
        sb = (si & 1) * ssize
        a_at = ("a", (ci & 1) * el * 2 * TILE)
        _fold(mem, a_at, ("stage", sb + tsize),
              (span[1] - span[0] + 1) * nfr, nfr, ("stage", sb), el, False,
              p, d, p0, ka, kz - ka, ka, span, u0, u1)
        if u1 == q:
            acc = _product(mem, acc, a_at,
                           ("gb", (ci & 1) * el * PFB_CH * 2), kz - ka)
            ci += 1
    return _tile_out(acc)


def _smem_bytes(k, q, d, lanes, uc):
    """The bytes pfb_smem_bytes (one chunk) or pfb_chunk_bytes gives."""
    out = TILE * OUT_STRIDE * 4
    dc, p = min(d, PHASES), k // d
    if lanes >= k and uc >= q:
        kr = TILE + q * p - 1
        return max(out, k * PFB_CH * 8 + 2 * FOLD_LANES * 2 * TILE * 4
                   + -(-q * k * 4 // 16) * 16
                   + (2 if d > PHASES else 1) * 2 * dc * kr * 4)
    el, nkb = _chunk_lanes(k, d, lanes)
    uc = min(uc, q)
    st = (-(-uc * el // 4) * 4 + 2 * min((el + p - 2) // p + 1, dc)
          * _chunk_frames(k, d, nkb, uc))
    return max(out, 2 * el * PFB_CH * 8 + 2 * el * 2 * TILE * 4 + 2 * st * 4)


def _bf16_pair(words):
    """The (low, high) bf16 halves of int32 words, as float64."""
    w = np.asarray(words).astype(np.uint32)
    lo = ((w & 0xFFFF) << 16).view(np.float32).astype(np.float64)
    hi = (w & 0xFFFF0000).view(np.float32).astype(np.float64)
    return lo, hi


# pfb_front_mma_chunked's block (fronts.cuh; read from the source by
# test_mma_front_constants_match_the_source): 8 consumer and 8 producer
# warps over the rows/32 m-tile pairs of its 256, 128 or 64 rows, each pair
# shared by 256/rows warps of each role (pfb_mma_split: the consumers
# split the n-tiles, the producers the 8-lane blocks); per 8-lane block an
# A tile of the bf16 hi and lo words of every m-tile's fragments, four a
# thread
MMA_ROWS = (256, 128, 64)
PRODUCERS = PFB_THREADS - CONSUMERS


def _a_block_words(rows):
    """pfb_a_block_words: an 8-lane block's A tile in a block of rows."""
    return 2 * (rows // 16) * 32 * 4


def _split(rows):
    """pfb_mma_split: warps of each role that share an m-tile pair."""
    return CONSUMERS // rows


A_BLOCK_WORDS = _a_block_words(TILE)
NAN_WORD = np.uint32(0x7FC0DEAD)        # a NaN's bits: shared memory not written
# the tags of a word: the step (producers' staging), chunk (consumers' B,
# the A tile's split) or u-range (a partial fold) that wrote it
STEP, BROWS, AFOLD, PART = 1 << 40, 2 << 40, 3 << 40, 4 << 40


def _pair_stride(nfr):
    """pfb_mma_pair_stride: nfr padded to 8 mod 16 (frames a phase pair)."""
    return nfr + (24 - nfr % 16) % 16


def _chunk_phases(k, d, el):
    """pfb_chunk_phases: the most phases a chunk of el lanes touches."""
    dc, p = min(d, PHASES), k // d
    return min((el + p - 2) // p + 1, dc)


def _mma_chunk_geom(k, q, d, lanes, uc, rows=TILE):
    """pfb_mma_chunk_geom, sizes in 32-bit words: nkb blocks and L lanes a
    chunk, uc taps a u-range, at most npc phases, in pairs of Lf frames
    (two words a frame), a staged window; an A tile, a B buffer and a
    staging buffer (two of each), for a block of ``rows`` rows."""
    el, nkb = _chunk_lanes(k, d, lanes)
    uc = min(uc, q)
    lf = _pair_stride(_chunk_frames(k, d, nkb, uc, rows))
    npc = _chunk_phases(k, d, el)
    return dict(nkb=nkb, L=el, uc=uc, npc=npc, Lf=lf,
                a=nkb * _a_block_words(rows), b=2 * nkb * NTB * 32 * 2,
                taps=uc * 8 * nkb,
                s=uc * 8 * nkb + 4 * ((npc + 1) // 2) * lf)


def _mma_chunk_bytes(k, q, d, lanes, uc, rows=TILE):
    """pfb_mma_chunk_bytes: two of each buffer, or the output tile."""
    g = _mma_chunk_geom(k, q, d, lanes, uc, rows)
    return 4 * max(2 * (g["a"] + g["b"] + g["s"]), rows * OUT_STRIDE)


def _bf16_split(re, im):
    """The hi and lo words of float32 (re, im): hi = bf16(re) | bf16(im) << 16
    rounded to nearest even, as __floats2bfloat162_rn, and lo the same of
    (re - hi_re, im - hi_im), each difference rounded to float32."""
    def bits(v):
        b = torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16)
        return (b.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF,
                b.float().numpy())
    (hr, fr), (hi_, fi) = bits(re), bits(im)
    (lr, _), (li, _) = bits(re - fr), bits(im - fi)
    return hr | (hi_ << 16), lr | (li << 16)


class _PfbMmaBlock:
    """pfb_front_mma_chunked's block in its shared memory: 32-bit words
    filled with a NaN, a tag a word (what wrote it last, -1 nothing) and
    the copies each role has in flight. The producers walk the steps
    (chunk, u-range): wait for their copies, start the next step's taps and
    window into the other staging buffer, fold the current step into its
    chunk's A tile (thread by thread, at the kernel's indices), and hand a
    folded chunk over; the consumers walk the chunks: wait for their B
    copies, start the next chunk's B rows into the other B buffer, wait for
    the chunk's fold and multiply it fragment by fragment. The producers
    run as far ahead as the named barriers let them (full(c) after chunk
    c's fold; free(c) after chunk c's product, which chunk c + 2's fold
    waits for). Every read checks that the word was written by the step,
    chunk or u-range it belongs to and that no copy in flight lands on it;
    every staging checks that each word is written once, inside its
    buffer. A block of ``rows`` rows (256, 128 or 64) holds rows/32 m-tile
    pairs; producer warp w folds pair w % (rows/32) in the 8-lane blocks kb
    of residue w // (rows/32) mod 256/rows, consumer warp w multiplies that
    pair by 8*rows/256 n-tiles from (w // (rows/32))*8*rows/256."""

    def __init__(self, x, hp, bank, k, d, group, g0, lanes, uc, grade,
                 rows=TILE):
        q = hp.shape[0]
        self.k, self.q, self.d, self.p = k, q, d, k // d
        self.group, self.g0, self.grade = group, g0, grade
        self.rows, self.mtiles = rows, rows // 16
        self.pairs, self.split = rows // 32, _split(rows)
        self.x = (x.real.astype(np.float32), x.imag.astype(np.float32))
        self.hq = pfb_chunk_taps(torch.from_numpy(hp), d).numpy()
        tab = pfb_mma_chunk_tables(torch.from_numpy(bank), d).numpy()
        self.kbg, self.nt_all = tab.shape[1], tab.shape[2]
        self.btab = tab.reshape(-1).view(np.uint32)
        self.dc = min(d, PHASES)
        self.kb0 = -(-self.dc * self.p // 8)          # blocks a group, KB0
        self.g = g = _mma_chunk_geom(k, q, d, lanes, uc, rows)
        self.chunks = list(_chunks(k, d, lanes))
        self.steps = [(c, p0, ka, kz, u0, min(q, u0 + g["uc"]))
                      for c, (p0, _, ka, kz, _) in enumerate(self.chunks)
                      for u0 in range(0, q, g["uc"])]
        self.b0 = 2 * g["a"]                 # A tiles at 0, then B, stage
        self.s0 = self.b0 + 2 * g["b"]
        size = self.s0 + 2 * g["s"]
        assert 4 * size <= _mma_chunk_bytes(k, q, d, lanes, uc, rows)
        self.mem = np.full(max(size, rows * OUT_STRIDE), NAN_WORD, np.uint32)
        self.tag = np.full(self.mem.size, -1, np.int64)
        self.pending = {"p": [], "c": []}
        self.inflight = np.zeros(self.mem.size, bool)
        self.full, self.free = set(), set()
        self.acc = np.zeros((rows, 4 * NTB), np.complex128)
        # (step, 8-lane block) -> the producer warps that fold it
        self.folders = {}
        self.folds = {}
        # word indices staged and read, by (kind, step or chunk)
        self.staged, self.seen = {}, {}

    # -- memory ---------------------------------------------------------
    def store(self, idx, vals, tag):
        self.mem[idx] = vals
        self.tag[idx] = tag

    def copy(self, role, idx, vals, tag, lo, hi):
        """Copies in flight (cp.async), each word once, inside [lo, hi)."""
        idx = np.asarray(idx).ravel()
        assert np.unique(idx).size == idx.size, "a word staged twice"
        assert idx.min() >= lo and idx.max() < hi, "a copy outside its buffer"
        self.inflight[idx] = True
        self.pending[role].append((idx, np.asarray(vals).ravel(), tag))

    def wait(self, role):
        """cp.async.wait_group 0: the role's copies land."""
        for idx, vals, tag in self.pending[role]:
            self.store(idx, vals, tag)
            self.inflight[idx] = False
        self.pending[role] = []

    def read(self, idx, tag, kind=None):
        assert (self.tag[idx] == tag).all(), "read a word not written for it"
        assert not self.inflight[idx].any(), \
            "a copy lands in a buffer being read"
        if kind is not None:
            self.seen.setdefault((kind, tag), []).append(np.ravel(idx))
        return self.mem[idx]

    # -- producers ------------------------------------------------------
    def span(self, step):
        """(pa, npc, s_lo, nfr, lf, tl) of a step's window and taps."""
        _, _, ka, kz, u0, u1 = step
        pa, pb, s_lo, s_hi = _lane_span(self.p, ka, kz)
        nfr = (u1 - 1 - u0) * self.p + s_hi - s_lo + self.rows
        return pa, pb - pa + 1, s_lo, nfr, _pair_stride(nfr), \
            8 * -(-(kz - ka) // 8)

    def stage_step(self, si, sb):
        """The step's taps (16-byte copies of runs of pfb_chunk_taps' rows,
        item i = (u, e) in the producers' order) and window
        (pfb_mma_stage_window: items (pair pp, frame k) stepped by the
        producers, both phases of a pair at words 2*(pp*lf + k) + e of a
        plane, a phase past the window's as zero) into staging buffer
        sb."""
        step = self.steps[si]
        _, p0, ka, _, u0, u1 = step
        g, p = self.g, self.p
        pa, npc, s_lo, nfr, lf, tl = self.span(step)
        assert npc <= g["npc"] and lf <= g["Lf"] and (u1 - u0) * tl <= \
            g["taps"]
        base = self.s0 + sb * g["s"]
        n4 = tl // 4
        i = np.arange((u1 - u0) * n4)
        u, e = i // n4, i % n4
        col = 8 * (p0 // self.dc) * self.kb0 + ka + 4 * e
        four = np.arange(4)
        idx = [base + (u * tl + 4 * e)[:, None] + four]
        vals = [self.hq[(u0 + u)[:, None], col[:, None] + four]]
        self.staged[("taps", STEP + si)] = idx[0].ravel()
        np2 = (npc + 1) // 2
        visit = _stepped(np2, nfr, PRODUCERS)
        pp, kk = visit % np2, visit // np2
        pl = np.concatenate([2 * pp, 2 * pp + 1])
        kk = np.concatenate([kk, kk])
        for plane, xs in enumerate(self.x):
            w = _stage(xs, self.g0, self.d, u0 * p + s_lo, nfr, p0 + pa,
                       2 * np2)
            w[:, npc:] = 0             # a phase past the window: zeros
            idx.append(base + g["taps"] + plane * 2 * np2 * lf
                       + 2 * ((pl >> 1) * lf + kk) + (pl & 1))
            vals.append(w[kk, pl].astype(np.float32))
        self.staged[("window", STEP + si)] = np.concatenate(idx[1:])
        self.copy("p", np.concatenate([a.ravel() for a in idx]),
                  np.concatenate([v.ravel() for v in vals]).view(np.uint32),
                  STEP + si, base, base + g["s"])

    def fold(self, si):
        """pfb_mma_fold of step si into A tile c & 1: the producer warp w of
        pair mp = w % pairs whose residue w // pairs is kb's mod split,
        thread (gid, tig), m-tile 2*mp + mt, register q = 2*h + rr, lane
        ka + 8*kb + tig + 4*h at row 32*mp + 16*mt + gid + 8*rr."""
        step = self.steps[si]
        c, p0, ka, kz, u0, u1 = step
        g, p = self.g, self.p
        pa, npc, s_lo, nfr, lf, tl = self.span(step)
        base = self.s0 + (si & 1) * g["s"]
        xw, plane = base + g["taps"], 2 * ((npc + 1) // 2) * lf
        mtiles, pairs = self.mtiles, self.pairs
        mp, lane, mt, q = np.ix_(np.arange(pairs), np.arange(32),
                                 np.arange(2), np.arange(4))
        gid, tig, h, rr = lane >> 2, lane & 3, q >> 1, q & 1
        row = 32 * mp + 16 * mt + gid + 8 * rr
        shape = (pairs, 32, 2, 4)
        tag = STEP + si
        for kb in range(tl // 8):
            # the warps whose loop kb = kb0, kb0 + split, ... visits kb
            self.folders[(si, kb)] = [
                w for w in range(PRODUCERS // 32)
                if kb in range(w // pairs, tl // 8, self.split)]
            kap = ka + 8 * kb + tig + 4 * h
            ok = kap < kz
            pl = kap // p - pa
            xo = np.where(ok, 2 * ((pl >> 1) * lf + kap % p - s_lo)
                          + (pl & 1), 0)
            xr = np.broadcast_to(xw + 2 * row + xo, shape)
            tp = np.broadcast_to(base + 8 * kb + tig + 4 * h, shape)
            slot = np.broadcast_to(
                (((kb * 2) * mtiles + 2 * mp + mt) * 32 + lane) * 4 + q
                + (c & 1) * g["a"], shape)
            lo_slot = slot + mtiles * 32 * 4
            f32 = np.float32
            if p == 4 and self.q == 4 and u1 - u0 == 4 and \
                    ka + 8 * kb + 8 <= kz:
                fr, fi = self.fold_slide(xw + 2 * (32 * mp + gid) + xo, h,
                                         plane, tp, tl, tag, mt, rr)
                u = u1 - u0
            elif u0 == 0:
                h0 = self.read(tp, tag, "taps").view(f32)
                fr = self.read(xr, tag, "window").view(f32) * h0
                fi = self.read(xr + plane, tag, "window").view(f32) * h0
                u = 1
            else:
                fr = self.read(slot, PART + c * 4096 + u0).view(f32)
                fi = self.read(lo_slot, PART + c * 4096 + u0).view(f32)
                u = 0
            for uu in range(u, u1 - u0):
                hu = self.read(tp + uu * tl, tag, "taps").view(f32)
                fr = fr + self.read(xr + 2 * uu * p, tag,
                                    "window").view(f32) * hu
                fi = fi + self.read(xr + plane + 2 * uu * p, tag,
                                    "window").view(f32) * hu
            if u1 < self.q:   # the partials wait in the thread's own words
                self.store(slot, fr.view(np.uint32), PART + c * 4096 + u1)
                self.store(lo_slot, fi.view(np.uint32), PART + c * 4096 + u1)
                continue
            whole = np.zeros((self.rows, 8), np.complex64)
            whole[row, np.broadcast_to(tig + 4 * h, shape)] = fr + 1j * fi
            for j in range(8):
                if ka + 8 * kb + j < kz:
                    self.folds[p0 * p + ka + 8 * kb + j] = whole[:, j]
            hi, lo = _bf16_split(fr, fi)
            self.store(slot, hi, AFOLD + c)
            if self.grade == "bf16x3":
                self.store(lo_slot, lo, AFOLD + c)

    def fold_slide(self, xp, h, plane, tp, tl, tag, mt, rr):
        """pfb_mma_fold_slide<4>: per plane the 10 8-byte words xp + 8*m
        (xp: frame gid of the thread's lane tig, phase pair of lanes tig
        and tig + 4, so word e = h is lane tig + 4*h), each read once,
        serve rows gid + 8*j at tap u as m = 2*j + u; each sum x*t[0], then
        + x*t[u] in ascending u."""
        f32 = np.float32
        xp = xp - h   # the pair's first word (lane tig)
        assert (xp % 2 == 0).all(), "an 8-byte load off its alignment"
        t = [self.read(tp + u * tl, tag, "taps").view(f32) for u in range(4)]
        w = [[self.read(xp + 8 * m + h + pn * plane, tag,
                        "window").view(f32) for m in range(10)]
             for pn in range(2)]
        j = 2 * mt + rr
        out = []
        for pn in range(2):
            acc = np.choose(j, [w[pn][2 * jj] for jj in range(4)]) * t[0]
            for u in range(1, 4):
                acc = acc + np.choose(
                    j, [w[pn][2 * jj + u] for jj in range(4)]) * t[u]
            out.append(acc)
        return out

    def producers(self):
        self.stage_step(0, 0)
        c = 0
        for si, (sc, *_, u0, u1) in enumerate(self.steps):
            self.wait("p")
            if si + 1 < len(self.steps):
                self.stage_step(si + 1, (si + 1) & 1)
            if u0 == 0 and sc >= 2:
                yield ("free", sc - 2)
            self.fold(si)
            if u1 == self.q:
                self.full.add(sc)
                c += 1
        assert c == len(self.chunks)

    # -- consumers ------------------------------------------------------
    def stage_b(self, c, b):
        """pfb_mma_stage_b: chunk c's B rows, a fragment a lane, 16-byte
        copies of contiguous table rows, into B buffer b; an n-tile past NT
        as zeros."""
        p0, _, ka, _, nk = self.chunks[c]
        g = self.g
        base = self.b0 + b * g["b"]
        kbg0 = (p0 // self.dc) * self.kb0 + ka // 8
        per = NTB * 16
        i = np.arange(2 * nk * per)
        part, r = i // (nk * per), i % (nk * per)
        kb, e = r // per, r % per
        dst = base + 2 * (((part * g["nkb"] + kb) * NTB) * 32 + 2 * e)
        src = 2 * (((part * self.kbg + kbg0 + kb) * self.nt_all
                    + self.group * NTB) * 32 + 2 * e)
        live = self.group * NTB + e // 16 < self.nt_all
        four = np.arange(4)
        self.store((dst[~live][:, None] + four).ravel(), 0, BROWS + c)
        self.staged[("B", BROWS + c)] = (dst[:, None] + four).ravel()
        self.copy("c", dst[live][:, None] + four,
                  self.btab[(src[live][:, None] + four).ravel()],
                  BROWS + c, base, base + g["b"])

    def product(self, c):
        """pfb_mma_product of chunk c: consumer warp cw of pair mp = cw %
        pairs reads the 16-byte words [kb][part][2*mp + m][lane] of A tile
        c & 1 and the B entries of its n-tiles; A's fragment register
        q of lane (gid, tig) is lane tig + 4*(q >> 1) at row 32*mp + 16*m +
        gid + 8*(q & 1). Each pass conj(w) * A, w = (G[c, v], G[c, K + v]),
        summed in complex128."""
        _, _, _, _, nk = self.chunks[c]
        g = self.g
        at = (c & 1) * g["a"]
        bb = self.b0 + (c & 1) * g["b"]
        mtiles, pairs, nw = self.mtiles, self.pairs, NTB // self.split
        cw, lane, m, q = np.ix_(np.arange(8), np.arange(32), np.arange(2),
                                np.arange(4))
        mp = cw % pairs
        row = np.broadcast_to(32 * mp + 16 * m + (lane >> 2) + 8 * (q & 1),
                              (8, 32, 2, 4))
        col = np.broadcast_to((lane & 3) + 4 * (q >> 1), (8, 32, 2, 4))
        hits = np.zeros((self.rows, 8), int)
        np.add.at(hits, (row, col), 1)
        assert (hits == self.split).all()
        # each (pair, n-tile) is one consumer warp's: its pair, n-tiles n0..
        owner = np.zeros((pairs, NTB), int)
        for w in range(8):
            n0 = w // pairs * nw
            owner[w % pairs, n0:n0 + nw] += 1
        assert (owner == 1).all()
        nt, cl, j = np.ix_(np.arange(NTB), np.arange(4), np.arange(8))
        for kb in range(nk):
            a_at = at + (((kb * 2) * mtiles + 2 * mp + m) * 32 + lane) * 4 + q
            parts = [a_at] + ([a_at + mtiles * 32 * 4]
                              if self.grade == "bf16x3" else [])
            a = []
            for at_ in parts:
                re_, im_ = _bf16_pair(self.read(at_, AFOLD + c))
                y = np.zeros((self.rows, 8), np.complex128)
                y[row, col] = re_ + 1j * im_
                a.append(y)
            w = []
            for part in range(2):
                # lane 4*g + t's two words of n-tile nt: the fragment of
                # its even GEMM column (g even: entry 4*(g/2) + t of
                # pfb_mma_tables' layout) or odd one (the same words with
                # their halves swapped, the new low half negated)
                words = self.read(bb + 2 * (((part * g["nkb"] + kb) * NTB
                                             + np.arange(NTB)[:, None]) * 32
                                            + np.arange(32)[None, :])[..., None]
                                  + np.arange(2), BROWS + c, "B")
                ev = words.reshape(NTB, 4, 2, 4, 2)[:, :, 0]   # (nt,cl,t,i)
                od = words.reshape(NTB, 4, 2, 4, 2)[:, :, 1].astype(np.uint32)
                live = max(0, min(NTB, self.nt_all - self.group * NTB))
                assert np.array_equal(   # (n-tiles past NT: zeros staged)
                    od[:live],
                    ((ev[:live] >> 16) | (ev[:live] << 16)) ^ 0x8000)
                # lane j = t + 4*i of the block, channel 4*nt + cl
                re_, im_ = _bf16_pair(ev[nt, cl, j & 3, j >> 2])
                # (nt, cl, j) -> (j, channel 4*nt + cl)
                w.append((re_ - 1j * im_).transpose(2, 0, 1).reshape(8, -1))
            self.acc += a[0] @ w[0] + a[0] @ w[1]
            if self.grade == "bf16x3":
                self.acc += a[1] @ w[0]

    def consumers(self):
        n = len(self.chunks)
        self.stage_b(0, 0)
        for c in range(n):
            self.wait("c")
            if c + 1 < n:
                self.stage_b(c + 1, (c + 1) & 1)
            yield ("full", c)
            self.product(c)
            if c + 2 < n:
                self.free.add(c)

    def run(self):
        """Both roles to the end, the producers first wherever the barriers
        let both run: (accumulators (rows, 32) complex128, {lane kappa of
        the one-chunk order: its whole fold (rows,) complex64})."""
        gens = {"p": self.producers(), "c": self.consumers()}
        waits = {"p": None, "c": None}
        while gens:
            moved = False
            for role in ("p", "c"):
                while role in gens:
                    w = waits[role]
                    if w is not None and w[1] not in (
                            self.free if w[0] == "free" else self.full):
                        break
                    try:
                        waits[role] = next(gens[role])
                    except StopIteration:
                        del gens[role]
                    moved = True
            assert moved, "the roles wait on each other"
        assert not self.pending["p"] and not self.pending["c"]
        return self.acc, self.folds


def _pfb_front_mma(x, hp, bank, k, d, group, g0, lanes, uc, grade,
                   rows=TILE):
    """``pfb_front_mma_chunked`` for channel group ``group``, the plan
    (lanes, uc) and a block of ``rows`` rows, in its shared memory
    (_PfbMmaBlock): (y (rows, 32) complex128, {kappa: whole fold (rows,)
    complex64})."""
    return _PfbMmaBlock(x, hp, bank, k, d, group, g0, lanes, uc, grade,
                        rows).run()


def _signal(n, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal(n) + 1j * r.standard_normal(n)).astype(
        np.complex64)


# (K, D, T): the three kinds of overflow at full size (the B table and
# bank at K = 640 and 712, the taps and window at Q = 127 with P = 64,
# both at K = 512, Q = 8) and a phase split across chunks (D = 89, P = 8);
# the main paths' P = 4, Q = 4 (the bf16 front's sliding-window fold) at
# a small K; each with forced plans (lanes, fold taps) of one 8-lane
# block a chunk and all Q taps, and of 16 and 24 lanes with u-ranges of 3
# and 40 taps where Q exceeds them
PFB_CASES = [(640, 64, 1280), (712, 89, 2848), (64, 1, 8128),
             (128, 2, 16256), (512, 32, 4096), (64, 16, 256)]
PLANS = [(8, 1 << 30), (16, 3), (24, 40)]
# a front against its plain version, of max|y|: float32 sums of 2K
# products a channel (and Q-term folds at f32) in another order; their
# worst case 2K * 2^-24 of the sum of |terms| is 8.5e-5 at K = 712, the
# cases read up to 1.3e-6
FRONT_TOL = 1e-5


def _case(k, d, t, c=5, m=100):
    """Tables and a signal of the second block (g0 = TILE*D) that ends m
    outputs in, so that the window's last samples read as zeros."""
    hp = _poly_taps(_lowpass(t, 0.4 / k), k)
    bins = sorted({0, 1, 7, k // 2, k - 3})[:c]
    bank = _dft_bank_stacked(bins, k)
    n = t + d * (TILE + m - 1)
    x = _signal(n, seed=k + d)
    return hp, bank, x, len(bins), m


def _plain_front(x, hp, bank, t, d):
    """graded_uniform_front at f32, (M, C) complex128."""
    want = graded_uniform_front(
        TCA(torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy())),
        torch.from_numpy(hp), torch.from_numpy(bank), t, d)
    return (want.re.double().numpy() + 1j * want.im.double().numpy()).T


@pytest.mark.parametrize("k,d,t", PFB_CASES)
def test_chunked_f32_front_transliteration(k, d, t):
    """pfb_front_chunked at three forced plans and pfb_front at the plan
    (K, Q), each in its shared-memory layout: every plan bit-equal to the
    one-chunk plan (the same fmaf sequence), and within FRONT_TOL of
    max|y| of graded_uniform_front at f32."""
    hp, bank, x, c, m = _case(k, d, t)
    q = hp.shape[0]
    want = _plain_front(x, hp, bank, t, d)[TILE:TILE + m]
    one = _pfb_front_f32(x, hp, bank, d, 0, TILE * d, k, q)
    got = one[0][:m, :c] + 1j * one[1][:m, :c].astype(np.float64)
    assert _rel(got, want) <= FRONT_TOL
    for lanes, uc in PLANS:
        re, im = _pfb_front_f32(x, hp, bank, d, 0, TILE * d, lanes, uc)
        assert np.array_equal(re, one[0]) and np.array_equal(im, one[1]), \
            (lanes, uc)


# (K, D, T, C): a second group of 32 channels with 1 and with 15 of them,
# at one chunk and in chunks of phases split across chunks (P = 4); the
# first block (window from sample -D, as the FM kernel's) and a ragged
# last one
WIDE_CASES = [(64, 16, 512, 33), (64, 4, 256, 47), (200, 50, 800, 47)]


@pytest.mark.parametrize("k,d,t,c", WIDE_CASES)
def test_f32_front_second_channel_group(k, d, t, c):
    """Both channel groups of a block of C = 33 or 47 channels (the second
    partly past C, whose bank reads as zeros) through pfb_front and
    pfb_front_chunked, in the first block (g0 = -D) and a last one ending
    m < 256 outputs in: each plan bit-equal to the one-chunk plan, the
    channels past C zero, every real channel within FRONT_TOL of max|y| of
    graded_uniform_front."""
    hp = _poly_taps(_lowpass(t, 0.4 / k), k)
    q = hp.shape[0]
    bank = _dft_bank_stacked([(7 * i + 3) % k for i in range(c)], k)
    m = 77
    n = t + d * (TILE + m - 1)
    x = _signal(n, seed=k + c)
    want = _plain_front(x, hp, bank, t, d)
    for g0, rows in ((-d, slice(0, TILE - 1)), (TILE * d, slice(0, m))):
        first = g0 < 0
        for group in (0, 1):
            one = _pfb_front_f32(x, hp, bank, d, group, g0, k, q)
            y = one[0] + 1j * one[1].astype(np.float64)
            live = min(PFB_CH, c - group * PFB_CH)
            assert not y[:, live:].any()
            ref = want[(0 if first else TILE):, group * PFB_CH:][
                :TILE - 1 if first else m, :live]
            got = y[1:, :live] if first else y[rows, :live]
            assert _rel(got, ref) <= FRONT_TOL, (g0, group)
            for lanes, uc in PLANS:
                re, im = _pfb_front_f32(x, hp, bank, d, group, g0, lanes, uc)
                assert np.array_equal(re, one[0]) and \
                    np.array_equal(im, one[1]), (g0, group, lanes, uc)


def _stepped(npc, nfr, nt):
    """The items (k, pl) pfb_stage_window's nt threads visit, each from its
    index, stepped by nt with the kernel's carry; returns the visits as
    flat item indices k*npc + pl."""
    t = np.arange(nt)
    pl, k = t % npc, t // npc
    dpl, dk = nt % npc, nt // npc
    seen = []
    while (k < nfr).any():
        live = k < nfr
        seen.append((k * npc + pl)[live])
        pl, k = pl + dpl, k + dk
        c = pl >= npc
        pl, k = np.where(c, pl - npc, pl), k + c
    return np.concatenate(seen) if seen else np.zeros(0, int)


@pytest.mark.parametrize("nt", [PFB_THREADS, PFB_THREADS - CONSUMERS])
@pytest.mark.parametrize("npc,nfr", [(1, 300), (16, 263), (12, 271),
                                     (13, 267), (3, 129), (9, 271),
                                     (5, 3)])
def test_f32_staging_steps_visit_every_item_once(npc, nfr, nt):
    """pfb_stage_window steps its items (a sample of each phase and frame)
    by its thread count, all threads (pfb_front) or the producers
    (pfb_front_chunked), with a carry in place of a division: every item is
    visited once."""
    got = np.sort(_stepped(npc, nfr, nt))
    assert np.array_equal(got, np.arange(npc * nfr))


def test_f32_front_constants_match_the_source():
    """The constants this file mirrors equal fronts.cuh's, and the
    shared-memory sizes the transliteration lays out are the ones the
    kernels ask for (pfb_smem_bytes, pfb_chunk_bytes) at the cases'
    plans: the 4 x 4 register tiles of 512 threads cover the block's 256
    rows x 32 channels."""
    import re
    from gsdr_tpu_torch.kernels import _build

    src = (_build.CSRC / "fronts.cuh").read_text()
    consts = dict(re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M))
    assert {name: int(consts[name]) for name in (
        "kTile", "kCG", "kPhaseChunk", "kPfbNT", "kPfbThreads",
        "kPfbFoldLanes", "kPfbRows", "kPfbCols", "kPfbWideRows",
        "kPfbConsumers")} == {
        "kTile": TILE, "kCG": CG, "kPhaseChunk": PHASES, "kPfbNT": NTB,
        "kPfbThreads": PFB_THREADS, "kPfbFoldLanes": FOLD_LANES,
        "kPfbRows": TILE_ROWS, "kPfbCols": TILE_COLS,
        "kPfbWideRows": WIDE_ROWS, "kPfbConsumers": CONSUMERS}
    assert re.search(r"^constexpr int kPfbCh = 4 \* kPfbNT;", src, re.M)
    assert PFB_THREADS * TILE_ROWS * TILE_COLS == TILE * PFB_CH
    assert CONSUMERS * WIDE_ROWS * TILE_COLS == TILE * PFB_CH
    # the witnesses of tests/test_torch_cuda.py: the FM tile kernel's 4,608
    # static bytes push K=288, D=24, Q=6 out of one chunk, not AM's
    assert 232_448 - 4_608 < _smem_bytes(288, 6, 24, 288, 6) <= 232_448
    assert _smem_bytes(640, 2, 64, 640, 2) > 232_448
    assert _smem_bytes(64, 8, 64, 64, 8) <= 232_448 - 4_608


# the card's opt-in shared memory a block and the FM PFB tile kernel's
# static shared memory (the AM one has none)
SMEM_OPTIN = 232_448
FM_STATIC = 4_608


def _mma_plan(k, q, d, room, rows=TILE):
    """fronts.cuh's pfb_chunk for the bf16 chunked kernel (its one-chunk
    kernel not fitting) in a block of ``rows`` rows: for each chunk of
    8*nkb lanes, nkb up to a group's, all Q taps a u-range where the block
    fits, else the most that do; the plan with the fewest chunks x
    u-ranges, the larger chunk on a tie, but below 256 rows on a tie the
    most taps a u-range, then the smallest chunk."""
    p, dc = k // d, min(d, PHASES)
    best, plan = None, (0, 0)
    for nkb in range(min(-(-k // 8), -(-dc * p // 8)), 0, -1):
        uc = q
        if _mma_chunk_bytes(k, q, d, 8 * nkb, q, rows) > room:
            lo, hi = 0, q - 1
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if _mma_chunk_bytes(k, q, d, 8 * nkb, mid, rows) <= room:
                    lo = mid
                else:
                    hi = mid - 1
            if lo == 0:
                continue
            uc = lo
        if not (8 * nkb < k or uc < q):
            continue
        chunks = sum(-(-(-(-min(dc, d - p0) * p // 8)) // nkb)
                     for p0 in range(0, d, dc))
        cost = chunks * -(-q // uc)
        if best is None or cost < best or (
                rows < TILE and cost == best and uc >= plan[1]):
            best, plan = cost, (8 * nkb, uc)
    return plan


# (K, D, T, room, plan): the main paths' grids, B2's pfb_nfm_lmr_320 and
# B3-PFB's pfb_airband_480, and the K=640 and K=712 witnesses through B2
MAIN_PLANS = [(640, 160, 2560, SMEM_OPTIN - FM_STATIC, (32, 4)),
              (960, 240, 3840, SMEM_OPTIN, (32, 4)),
              (640, 64, 1280, SMEM_OPTIN - FM_STATIC, (32, 2)),
              (712, 89, 2848, SMEM_OPTIN - FM_STATIC, (32, 4))]


@pytest.mark.parametrize("k,d,t,room,plan", MAIN_PLANS)
def test_mma_chunk_plans_at_the_main_paths(k, d, t, room, plan):
    """The planner's plan for the bf16 chunked kernel at the main paths'
    grids: two A tiles of 8-lane blocks (16 KB each a block), two B
    buffers and two staging buffers fit the block with every fold tap in
    one u-range; one more 8-lane block does not."""
    q = -(-t // k)
    assert _mma_plan(k, q, d, room) == plan
    assert _mma_chunk_bytes(k, q, d, *plan) <= room
    assert _mma_chunk_bytes(k, q, d, plan[0] + 8, q) > room


@pytest.mark.parametrize("k,d,t,room,plan", MAIN_PLANS[:2])
def test_mma_staging_stages_each_item_once(k, d, t, room, plan):
    """At the NFM and airband plans, the block in its shared memory
    (_PfbMmaBlock, which checks every copy's words once inside its buffer,
    every read against the step or chunk that wrote it and against the
    copies in flight): each chunk's B rows are staged once into the buffer
    its product reads and every staged B word is read; each step's taps
    likewise; each step's window words are staged once and the fold reads
    only staged words, all but the edge frames of the chunk's first and
    last phase (the window spans s_lo..s_hi of all its phases)."""
    q = -(-t // k)
    hp = _poly_taps(_lowpass(t, 0.4 / k), k)
    bank = _dft_bank_stacked([0, 1, k // 2, k - 1], k)
    x = _signal(t + d * (2 * TILE + 7), seed=3)
    block = _PfbMmaBlock(x, hp, bank, k, d, 0, TILE * d, *plan, "bf16x3")
    block.run()
    assert len(block.chunks) == 2 * -(-d // PHASES)
    for (kind, tag), staged in block.staged.items():
        read = np.unique(np.concatenate(block.seen[(kind, tag)]))
        assert np.unique(staged).size == staged.size, (kind, tag)
        assert np.isin(read, staged).all(), (kind, tag)
        if kind in ("B", "taps"):
            assert read.size == staged.size, (kind, tag)
        else:
            assert read.size >= 0.98 * staged.size, (kind, tag)


def test_mma_front_constants_match_the_source():
    """The block the transliteration mirrors is fronts.cuh's: the A tile's
    words a block, the phase stride, two of each buffer, 8 consumer and 8
    producer warps, and the named barriers."""
    import re
    from gsdr_tpu_torch.kernels import _build

    src = (_build.CSRC / "fronts.cuh").read_text()
    consts = dict(re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M))
    assert int(consts["kPfbConsumers"]) == CONSUMERS == TILE
    assert int(consts["kBarConsumers"]) not in (1, 2, 3, 4, 5)
    for line in (
            "return 2 * (rows / 16) * 32 * 4;",
            "return kPfbConsumers / rows;",
            "return (uc - 1) * P + span + rows;",
            "return nfr + (24 - nfr % 16) % 16;",
            "g.nkb = pfb_chunk_blocks(K, D, lanes);",
            "g.L = pfb_chunk_lanes(K, D, lanes);",
            "g.npc = pfb_chunk_phases(K, D, g.L);",
            "g.Lf = pfb_mma_pair_stride(pfb_chunk_frames(K, D, g.nkb, g.uc, "
            "rows));",
            "g.abytes = (size_t)g.nkb * pfb_a_block_words(rows) * "
            "sizeof(uint32_t);",
            "const size_t out = (size_t)rows * (8 * nt + 1) * sizeof(float);",
            # the warps of each role over the m-tile pairs (pfb_mma_split)
            "return pfb_mma_split(kRows) == 1 ? w : w % (kRows / 32);",
            "return pfb_mma_split(kRows) == 1 ? 0 : w / (kRows / 32);",
            "for (int kb = kb0; kb < tl / 8; kb += kSplit) {",
            "pfb_mma_pair<kRows>(tid >> 5), pfb_mma_share<kRows>(tid >> 5),",
            "(cur.kz - cur.ka + 7) / 8, g.nkb, pfb_mma_pair<kRows>(tid >> 5),",
            "pfb_mma_share<kRows>(tid >> 5) * kNw, tid & 31);",
            "const uint2* bl = bs + n0 * 32 + lane;",
            "const int n0 = pfb_mma_share<kRows>(threadIdx.x >> 5) * kNw;",
            "const int r = 32 * pfb_mma_pair<kRows>(threadIdx.x >> 5) + 16 * mt "
            "+ gid;",
            "const int col = 8 * (n0 + nt) + 2 * tig;",
            "g.bbytes = 2 * (size_t)g.nkb * nt * 32 * sizeof(uint2);",
            "const size_t all = 2 * (g.abytes + g.bbytes + g.sbytes);",
            "if constexpr (kRows < kTile) {\n#pragma unroll 2\n"
            "    for (int kb = 0; kb < nk; ++kb)\n"
            "      pfb_mma_block_product<kGrade, kNT, kNw, kRows>(d, at, bl, kb, "
            "nkb, mp,",
            "float* d = xw + 2 * (pp * lf + k);",
            "for (int m = 0; m < kN; ++m) w[m] = x[4 * m];"):
        assert line in src, line
    assert re.search(r"g\.sbytes = \(\(size_t\)g\.uc \* 8 \* g\.nkb \+\s+"
                     r"4 \* \(size_t\)\(\(g\.npc \+ 1\) / 2\) \* g\.Lf\) \*"
                     r"\s+sizeof\(float\);", src)
    assert A_BLOCK_WORDS == 4096 and PRODUCERS == TILE
    for nfr in (256, 271, 272, 287, 288, 300):
        assert _pair_stride(nfr) % 16 == 8 and 0 <= \
            _pair_stride(nfr) - nfr < 16


@pytest.mark.parametrize("grade", ["bf16x3", "bf16x2"])
@pytest.mark.parametrize("k,d,t", PFB_CASES)
def test_chunked_mma_front_transliteration(grade, k, d, t):
    """pfb_front_mma_chunked at forced plans and its one-chunk plan: the
    whole fold of every lane bit-equal to the fold the plain version
    splits (x*hp[0], then + x*hp[u] in ascending u, each rounded), so the
    split is taken after the whole fold; the products equal across plans
    (the same fragments in the same block order) and within 1e-6 of
    max|y| of graded_uniform_front at the grade (the passes' sums in
    another order)."""
    hp, bank, x, c, m = _case(k, d, t)
    q = hp.shape[0]
    g0 = TILE * d
    xt = TCA(torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()))
    want = graded_uniform_front(xt, torch.from_numpy(hp),
                                torch.from_numpy(bank), t, d,
                                precision=grade)
    want = (want.re.double().numpy() + 1j * want.im.double().numpy())
    want = want[:, TILE:TILE + m].T
    # the plain version's fold of the block's rows, lane v
    xp = np.zeros(g0 + (TILE - 1) * d + q * k, np.complex64)
    xp[:x.shape[0]] = x
    idx = g0 + np.arange(TILE)[:, None] * d + np.arange(k)[None, :]
    fre = xp.real[idx] * hp[0]
    fim = xp.imag[idx] * hp[0]
    for u in range(1, q):
        fre = fre + xp.real[idx + u * k] * hp[u]
        fim = fim + xp.imag[idx + u * k] * hp[u]
    p = k // d
    ref = None
    for lanes, uc in [(k, q)] + PLANS:
        y, folds = _pfb_front_mma(x, hp, bank, k, d, 0, g0, lanes, uc, grade)
        assert sorted(folds) == list(range(k))
        for kap, f in folds.items():
            v = kap // p + (kap % p) * d
            assert np.array_equal(f.real, fre[:, v]) and \
                np.array_equal(f.imag, fim[:, v]), (lanes, uc, kap)
        ref = y if ref is None else ref
        assert np.array_equal(y, ref), (lanes, uc)
    assert _rel(ref[:m, :c], want) <= FRONT_TOL


@pytest.mark.parametrize("grade", ["bf16x3", "bf16x2"])
@pytest.mark.parametrize("rows", MMA_ROWS[1:])
@pytest.mark.parametrize("k,d,t,plan", [(64, 16, 256, (16, 4)),
                                        (512, 32, 4096, (16, 3)),
                                        (712, 89, 2848, (24, 40))])
def test_chunked_mma_front_row_tiles_bit_equal(grade, rows, k, d, t, plan):
    """pfb_front_mma_chunked in blocks of 128 and 64 rows (at the sliding
    fold's P = 4, Q = 4, and across u-ranges): the 256/rows blocks that
    cover the 256-row block's rows give its outputs and every lane's whole
    fold bit for bit, each 8-lane block of a step folded by one producer
    warp of each m-tile pair (its residue mod 256/rows), whatever the
    block's rows."""
    hp, bank, x, _, _ = _case(k, d, t)
    g0 = TILE * d
    want, want_folds = _pfb_front_mma(x, hp, bank, k, d, 0, g0, *plan, grade)
    pairs = rows // 32
    for i in range(TILE // rows):
        block = _PfbMmaBlock(x, hp, bank, k, d, 0, g0 + i * rows * d, *plan,
                             grade, rows)
        y, folds = block.run()
        part = slice(i * rows, (i + 1) * rows)
        assert np.array_equal(y, want[part]), (rows, i)
        assert sorted(folds) == sorted(want_folds)
        for kap, f in folds.items():
            assert np.array_equal(f, want_folds[kap][part]), (rows, i, kap)
        for (si, kb), warps in block.folders.items():
            assert sorted(w % pairs for w in warps) == list(range(pairs)), \
                (si, kb, warps)


# The H100's streaming multiprocessors
SMS = 132
MIN_ROWS = 64     # the fewest rows of a chunked bf16 block (kMmaMinRows)


def _pfb_rows(c, m, overlap, sms=SMS):
    """fronts.cuh's pfb_mma_rows, mma_chunk_block's rule with the channels
    held at 32: 256 rows, halved while the grid of ceil(M / (rows -
    overlap)) row tiles x ceil(C / 32) channel groups at half the rows
    still fits one wave of ``sms`` SMs, down to 64; 256 where C or M < 1
    (any)."""
    rows = TILE
    if c < 1 or m < 1:
        return rows

    def blocks(r):
        return -(-m // (r - overlap)) * -(-c // PFB_CH)
    while rows > MIN_ROWS and blocks(rows // 2) <= sms:
        rows //= 2
    return rows


def _pfb_grid(c, m, overlap, rows):
    return -(-m // (rows - overlap)) * -(-c // PFB_CH)


# (cell, C, M, overlap, rows, blocks): the benchmark's four cells (M the
# outputs of a block: 160,000 / 160 and 160,320 / 240 live, 983,040 / D
# captured), the FM chain's tiles overlapping by one output
CELL_ROWS = [("nfm320.live20ms", 320, 1000, 1, 128, 80),
             ("airband480.live20ms", 480, 668, 0, 128, 90),
             ("nfm320.capture", 320, 6144, 1, 256, 250),
             ("airband480.capture", 480, 4096, 0, 256, 240)]


@pytest.mark.parametrize("cell,c,m,overlap,rows,blocks", CELL_ROWS)
def test_pfb_row_tile_fills_the_card_at_the_cells(cell, c, m, overlap, rows,
                                                  blocks):
    """The row rule on the H100's 132 SMs: a live block of either cell
    takes 128 rows (80 and 90 blocks, where 256 took 40 and 45; 64 would
    take 160 and 165, more than a wave), a capture block keeps 256 (250
    and 240 blocks; 128 would take 490 and 480)."""
    assert _pfb_rows(c, m, overlap) == rows, cell
    assert _pfb_grid(c, m, overlap, rows) == blocks, cell
    assert _pfb_grid(c, m, overlap, TILE) <= SMS or rows == TILE
    if rows > MIN_ROWS:
        assert _pfb_grid(c, m, overlap, rows // 2) > SMS


def test_pfb_row_tile_rule_edges():
    """Any M or C (< 1) keeps 256 rows; the FM chain's overlap of one
    output counts (M = 1016 outputs of 32 channels on 16 SMs: 8 tiles of
    127 new outputs, 17 of 63 at 64 rows, against 8 and 16 tiles of 128
    and 64 without); one channel group of a short call goes down to 64,
    and a grid over a wave at 256 rows keeps them."""
    assert _pfb_rows(320, 0, 1) == TILE and _pfb_rows(0, 1000, 1) == TILE
    assert _pfb_rows(320, -5, 0) == TILE
    assert _pfb_rows(32, 1016, 1, sms=16) == 128    # 8 tiles; 64 rows: 17
    assert _pfb_rows(32, 1016, 0, sms=16) == 64     # 16 tiles of 64
    assert _pfb_rows(32, 100, 1) == MIN_ROWS
    assert _pfb_rows(5000, 100, 1) == TILE          # 157 groups: over a wave


@pytest.mark.parametrize("k,d,t,room,rows,plan",
                         [(640, 160, 2560, SMEM_OPTIN - 2_832, 128, (32, 4)),
                          (960, 240, 3840, SMEM_OPTIN, 128, (32, 4)),
                          (640, 160, 2560, SMEM_OPTIN - 1_808, 64, (64, 4)),
                          (960, 240, 3840, SMEM_OPTIN, 64, (64, 4))])
def test_mma_chunk_plans_at_smaller_row_tiles(k, d, t, room, rows, plan):
    """The planner for the bytes of the block the cells' live launches
    take (the FM kernel's static shared memory shrinks with its rows:
    2,832 B at 128, 1,808 at 64): at 128 rows every fold tap in one
    u-range and chunks of 4 blocks, two a group (chunks of 7 and 1 fit too
    and stage as many windows), at 64 rows a whole group a chunk."""
    q = -(-t // k)
    assert _mma_plan(k, q, d, room, rows) == plan
    assert _mma_chunk_bytes(k, q, d, *plan, rows) <= room
    group = min(d, PHASES) * (k // d)
    if plan[0] < group:   # a larger chunk fits too, a whole group does not
        assert _mma_chunk_bytes(k, q, d, plan[0] + 8, q, rows) <= room
        assert _mma_chunk_bytes(k, q, d, group, q, rows) > room


def test_pfb_row_tile_rule_matches_the_sources():
    """The rule _pfb_rows mirrors is fronts.cuh's (mma_chunk_block with
    the channels held at kPfbCh) and the launchers take it with their
    overlaps (the FM chain's tiles share one output, the AM chain's none),
    plan it before the chunks, and pass the rows through."""
    import re
    from gsdr_tpu_torch.kernels import _build

    src = (_build.CSRC / "fronts.cuh").read_text()
    consts = dict(re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M))
    assert int(consts["kMmaMinRows"]) == MIN_ROWS
    for line in (
            "return C < 1 ? kTile",
            ": mma_chunk_block(C, M, kPfbCh, kMmaMinRows, overlap, kPfbCh)",
            "MmaBlock b{min_ch, kTile};",
            "while (b.rows > min_rows && blocks(b.ch, b.rows / 2) <= sms) "
            "b.rows /= 2;",
            "return (M + out - 1) / out * ((C + ch - 1) / ch);",
            "const long out = rows - overlap;",
            "if (best < 0 || cost < best ||\n"
            "        (rows < kTile && cost == best && uc >= plan[1])) {",
            "if (rows == kTile / 2) return f(std::integral_constant<int, "
            "kTile / 2>{});",
            "return f(std::integral_constant<int, kMmaMinRows>{});",
            "return f(std::integral_constant<int, kTile>{});"):
        assert line in src, line
    # the rows with_pfb_rows instantiates are the wrappers' row counters'
    assert PFB_ROWS == (TILE, TILE // 2, int(consts["kMmaMinRows"]))
    fm = (_build.CSRC / "fm_chain.cu").read_text()
    am = (_build.CSRC / "am_chain.cu").read_text()
    assert "gsdr::pfb_mma_rows(C, M, kTile - kOut)" in fm
    assert "constexpr int kOut = kTile - 1;" in fm
    assert "constexpr int kNew = kRows - 1;" in fm
    assert "extern \"C\" int fm_chain_tile_outputs(int rows) { return rows - 1; }" \
        in fm
    assert "gsdr::pfb_mma_rows(C, M, 0)" in am
    for lib in (fm, am):
        assert "const int rows = pfb_rows(grade, C, M);" in lib
        assert "plan, rows);" in lib
        assert ("plan[2] = gsdr::use_chunked_pfb(plan[0], plan[1], K, Q) ? "
                "rows : kTile;") in lib


# ---------------------------------------------------------------------------
# The receivers and the plain version against the JAX package at those grids
# ---------------------------------------------------------------------------

WIDE_FS = 8_000_000.0
SKIP = 32         # outputs of the zero-primed start left out (T/D = 16)
ENV_ATOL = 1e-5   # as tests/test_torch_am_radio.py


def _nfm_lmr(channels):
    """Land-mobile NFM on the 12.5-kHz raster of an 8-MHz capture (the
    Fs/640 grid), 2.5-kHz deviation, a 2560-tap low-pass (Q = 4), D = 160
    (P = 4, 50-kHz audio); ``channels`` contiguous channels of the 320."""
    return JFm(sample_rate=WIDE_FS, tuning_frequency=0.0,
               channel_frequencies=tuple(12_500.0 * (i - channels // 2)
                                         for i in range(channels)),
               frequency_deviation=2_500.0, decimation=160,
               low_pass_taps=tuple(_lowpass(2560, 5_000.0 / WIDE_FS)
                                   .tolist()), impl="pfb")


# The airband's 8.33-kHz raster is 25/3 kHz, which no binary float holds,
# and the grid detection (ops.pfb.uniform_grid, the JAX package's too)
# takes the shifts' exact binary values: the capture runs at 7.99992 MHz,
# whose Fs/960 = 8333.25 Hz is exact (0.083 Hz a channel off the raster)
AIRBAND_FS = 7_999_920.0


def _airband(channels):
    """VHF airband AM on the 8.33-kHz raster (the Fs/960 grid of a
    7.99992-MHz capture), a 3840-tap low-pass (Q = 4), D = 240 (P = 4);
    ``channels`` contiguous channels of the 480."""
    return JAm(sample_rate=AIRBAND_FS, tuning_frequency=0.0,
               channel_frequencies=tuple(AIRBAND_FS / 960
                                         * (i - channels // 2)
                                         for i in range(channels)),
               decimation=240,
               low_pass_taps=tuple(_lowpass(3840, 3_000.0 / AIRBAND_FS)
                                   .tolist()), impl="pfb")


def _grid_carriers(model, n, am=False, seed=7):
    """An FM carrier (the model's deviation) or a 50%-AM carrier on every
    channel, tone 300 + 40*k Hz."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / model.sample_rate
    sig = np.zeros(n, np.complex128)
    c = len(model.channel_frequencies)
    for k, f in enumerate(model.channel_frequencies):
        tone = 300.0 + 40.0 * k
        msg = np.sin(2 * np.pi * tone * t + r.uniform(0, 6))
        ph = 2 * np.pi * (f - model.tuning_frequency) * t + r.uniform(0, 6)
        if am:
            sig += 0.6 * (1.0 + 0.5 * msg) * np.exp(1j * ph) / c * 8
        else:
            sig += np.exp(1j * (ph + model.frequency_deviation / tone * msg)) / c
    return sig.real.astype(np.float32), sig.imag.astype(np.float32)


@pytest.mark.parametrize("name", ["pfb_nfm_lmr", "pfb_airband"])
def test_receiver_matches_jax_pfb_at_wide_grids(name):
    """The port's FmChannelizer (Fs/640 grid, D = 160, T = 2560) and
    AmReceiver (Fs/960, D = 240, T = 3840) at impl='pfb_torch', the plain
    chain of the PFB front that the chunked B2 and B3-PFB run on the card,
    against JAX's impl='pfb' (its XLA fold and DFT bank) on the CPU, over
    three streamed steps. Reduced from the deployed 320 and 480 channels
    to 24 contiguous channels, and to steps of 256 (FM) and 128 (AM)
    outputs, so that the CPU runs them in about a second; the grid, taps,
    D and deviation are the deployed ones. FM audio within 1e-4 of
    max|audio| after the first SKIP outputs (both plain float32 chains in
    other orders, as tests/test_torch_fm_radio.py's wideband case), the
    carries within 1e-4; AM envelopes within ENV_ATOL; the RF tails and n0
    equal."""
    fm = name == "pfb_nfm_lmr"
    jm = _nfm_lmr(24) if fm else _airband(24)
    fields = dict(dataclasses.asdict(jm), impl="xla")
    tm = (fm_channelizer_from_fields if fm else am_receiver_from_fields)(
        fields, device="cpu")
    tm = type(tm)(**{**_fields(tm), "impl": "pfb_torch"}, device="cpu")
    assert tm.front == "pfb" and tm.pfb_grid[0] == (640 if fm else 960)
    d = jm.decimation
    block = d * (256 if fm else 128)
    re, im = _grid_carriers(jm, 3 * block, am=not fm)
    js, ts = jm.init(), tm.init()
    yj_all, yt_all = [], []
    for i in range(3):
        sl = slice(i * block, (i + 1) * block)
        js, yj = jm.step(js, JCA(jnp.asarray(re[sl]), jnp.asarray(im[sl])))
        ts, yt = tm.step(ts, TCA(torch.from_numpy(re[sl]),
                                 torch.from_numpy(im[sl])))
        yj_all.append(np.asarray(yj))
        yt_all.append(yt.numpy())
    yj, yt = np.concatenate(yj_all, -1), np.concatenate(yt_all, -1)
    assert yt.shape == yj.shape == (24, 3 * block // d)
    if fm:
        assert _rel(yt[:, SKIP:], yj[:, SKIP:]) <= 1e-4
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


def _fields(model):
    """The constructor arguments of a port receiver, impl included."""
    kw = dict(sample_rate=model.sample_rate,
              tuning_frequency=model.tuning_frequency,
              channel_frequencies=model.channel_frequencies,
              decimation=model.decimation,
              low_pass_taps=model.low_pass_taps, impl=model.impl,
              precision=model.precision)
    if hasattr(model, "frequency_deviation"):
        kw.update(frequency_deviation=model.frequency_deviation,
                  deemphasis_tau=model.deemphasis_tau)
    return kw


def test_pfb_fm_chain_reference_matches_jax_kernel_interpret_at_k640():
    """The plain version the card holds the chunked B2 to,
    pfb_fm_chain_reference at f32, against JAX's PFB-fronted kernel
    (pfb_fm_chain_pallas) interpreted at K = 640, D = 64, T = 1280 (the
    B-table overflow's witness), 8 of the 640 bins, one step of 1280
    outputs (one block of the JAX plan): audio within 2e-4 of max|audio|
    after the zero-primed first output, the carries within 2e-4 of
    max|audio| (tests/test_torch_fm_radio.py's PFB case)."""
    k, d, t = 640, 64, 1280
    fs = 1_000_000.0
    jm = JFm(sample_rate=fs, tuning_frequency=0.0,
             channel_frequencies=tuple(-(fs / k) * i
                                       for i in (0, 1, 2, 5, 9, 320, 500, 639)),
             frequency_deviation=300.0, decimation=d,
             low_pass_taps=tuple(_lowpass(t, 0.4 / k).tolist()), impl="pfb",
             precision="f32")
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    k_grid, bins = tm.pfb_grid
    assert k_grid == k
    n = d * 1280
    re, im = _grid_carriers(jm, n, seed=3)
    ifs = int(fs)
    b, a = jm._deemph()
    n0, tail, cf, cz = jm.init()
    buf = JCA(jnp.concatenate([tail.re, jnp.asarray(re)]),
              jnp.concatenate([tail.im, jnp.asarray(im)]))
    rot0 = (n0 + jnp.int32(ifs - (t - 1) % ifs)) % ifs
    yj, cfj, czj = pfb_fm_chain_pallas(
        buf, jm.low_pass_taps, jm._lo_table(), rot0, d, jm.gain, b, a, cf,
        cz, tuple(jm._shifts()), fs, bins, k_grid, precision="f32",
        interpret=True)
    tn0, ttail, tcf, tcz = tm.init()
    tbuf = TCA(torch.cat([ttail.re, torch.from_numpy(re)]),
               torch.cat([ttail.im, torch.from_numpy(im)]))
    trot0 = torch.remainder(tn0 + (ifs - (t - 1) % ifs), ifs).to(torch.int32)
    yt, cft, czt = pfb_fm_chain_reference(
        tbuf, tm.poly_taps, tm.dft_bank, t, tm.lo_table, trot0, d, tm.gain,
        tm.deemph, tcf, tcz)
    yj = np.asarray(yj)
    assert tuple(yt.shape) == yj.shape == (8, n // d)
    assert _rel(yt.numpy()[:, 1:], yj[:, 1:]) <= 2e-4
    scale = float(np.max(np.abs(yj[:, 1:])))
    for got, want in ((cft.re, cfj.re), (cft.im, cfj.im), (czt, czj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=2e-4 * scale)


def test_pfb_variants_apply_to_the_sources():
    """Every edit of tools/pfb_variants.py (the variants and ablations of
    the bf16 chunked PFB front timed on the card) finds its text once in
    the sources."""
    import importlib.util
    from gsdr_tpu_torch.kernels import _build

    tools = _build.CSRC.parents[2] / "tools"
    sys.path.insert(0, str(tools))
    try:
        spec = importlib.util.spec_from_file_location(
            "pfb_variants", tools / "pfb_variants.py")
        variants = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(variants)
    finally:
        sys.path.remove(str(tools))
    for name, edits in variants.VARIANTS.items():
        for source, text, _ in edits:
            assert (_build.CSRC / source).read_text().count(text) == 1, name
