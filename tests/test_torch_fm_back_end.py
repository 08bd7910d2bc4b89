"""The FM chain's back end in one launch (``csrc/fm_chain.cu``): a numpy
transliteration of its de-emphasis, the cheap check of the kernel's index
logic before a card run.

  - each tile block's zero-state scan as ``fm_chain_tile`` forms it (the
    same float32 multiplies and fmaf's in the same order), its aggregate
    (the tile's zero-state end) published at once;
  - the look-back of ``start_state`` in ticket order (tile t / groups,
    group t % groups), each predecessor seen as published inclusive or as
    aggregate only at random, with its stop at the first composed power
    that is exactly 0 in float32, and the forward composition from there;
  - the start state added to each output in registers, out =
    fmaf(a^(j - j0), z_start, fmaf(b0, d, z[j - 1])), the inclusive state
    published, the last tile's as zf; the scratch's slots k*C + c and the
    header's refresh of the slots a call does not write.

Held to a transliteration of the parent's three launches (the tile, the
Kogge-Stone tile scan, the inject): bit for bit where a^255 is 0 in
float32, within 1e-6 of max|audio| elsewhere; and to
``fm_chain_reference``'s de-emphasis at f32 on the CPU. The host's
one-chunk channel planner is read from the source."""

import re

import numpy as np
import pytest
import torch

from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.kernels import _build
from gsdr_tpu_torch.kernels.chain import graded_bank_front
from gsdr_tpu_torch.kernels.fm_chain import (
    deemphasis_triple,
    fm_chain_reference,
)
from gsdr_tpu_torch.ops.channelize import rotate_bank
from gsdr_tpu_torch.ops.quad_demod import quad_fm_demod

F32 = np.float32


def _constants():
    """fronts.cuh's kTile and kCG."""
    src = (_build.CSRC / "fronts.cuh").read_text()
    consts = dict(re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M))
    return int(consts["kTile"]), int(consts["kCG"])


TILE, CG = _constants()
OUT = TILE - 1          # new outputs a tile block (fm_chain.cu kOut)


def _c_ternary(expr):
    """A C expression of comparisons, && and right-nested ?: as Python."""
    expr = expr.strip()
    if "?" not in expr:
        return expr.replace("&&", "and").replace("||", "or")
    cond, rest = expr.split("?", 1)
    yes, no = rest.split(":", 1)
    return (f"({_c_ternary(yes)}) if ({_c_ternary(cond)}) "
            f"else ({_c_ternary(no)})")


def _one_chunk_channels():
    """fm_chain.cu's one_chunk_channels(C) as a Python function."""
    src = (_build.CSRC / "fm_chain.cu").read_text()
    body = re.search(r"constexpr int one_chunk_channels\(int C\) \{\s*"
                     r"return ([^;]+);", src).group(1)
    code = compile(_c_ternary(body), "one_chunk_channels", "eval")
    return lambda c: eval(code, {"kCG": CG}, {"C": c})


def _fmaf(a, b, c):
    """float32 fma, correctly rounded: the exact product in float64, the
    sum rounded to odd (TwoSum's error nudges an even result one ulp
    toward it), then one rounding to float32."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64)
               for v in (a, b, c))
    p = a * b
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even & np.isfinite(s),
                 np.nextafter(s, s + err), s)
    return s.astype(np.float32)


def _ipow(a, k):
    """fm_chain.cu's ipow: float32 square-and-multiply."""
    r, b = F32(1), F32(a)
    k = int(k)
    while k:
        if k & 1:
            r = F32(r * b)
        b = F32(b * b)
        k >>= 1
    return r


def _tiles(dsc, b0, cc, a):
    """Every tile block's zero-state pass, as fm_chain_tile: per tile k
    (rows r of outputs j = k*OUT - 1 + r, real where 0 < r and j < M),
    (out0 (C, ntiles, TILE), zend (C, ntiles), n_real (ntiles,)): out0 the
    outputs b0*d + z[j-1] from a zero tile start, zend the state at the
    tile's last real row."""
    c, m = dsc.shape
    ntiles = -(-m // OUT)
    rows = np.arange(ntiles)[:, None] * OUT - 1 + np.arange(TILE)[None, :]
    real = (rows > np.arange(ntiles)[:, None] * OUT - 1) & (rows < m)
    d = np.where(real[None], dsc[:, np.clip(rows, 0, m - 1)], F32(0))
    z = (F32(cc) * d).astype(np.float32)              # z = cc * dsc
    w = z.reshape(c, ntiles, TILE // 32, 32)
    as_ = F32(a)
    for s in (1, 2, 4, 8, 16):                      # warp scan
        v = np.zeros_like(w)
        v[..., s:] = w[..., :-s]
        w = np.where(np.arange(32) >= s, _fmaf(as_, v, w), w)
        as_ = F32(as_ * as_)
    a32 = as_
    a_lane = np.array([_ipow(a, ln + 1) for ln in range(32)], np.float32)
    edge = w[..., 31]                                 # (C, ntiles, warps)
    sprev = np.zeros_like(edge)
    acc = np.zeros(edge.shape[:2], np.float32)
    for q in range(1, TILE // 32):
        acc = _fmaf(a32, acc, edge[..., q - 1])
        sprev[..., q] = acc
    w = _fmaf(a_lane, sprev[..., None], w)
    z = w.reshape(c, ntiles, TILE)
    zp = np.concatenate([z[..., :1], z[..., :-1]], axis=-1)
    out0 = _fmaf(F32(b0), d, zp)
    n_real = np.minimum(OUT, m - np.arange(ntiles) * OUT)
    zend = z[:, np.arange(ntiles), n_real]
    return out0, zend, n_real


def _store(out0, m):
    """(C, M) outputs of the tile rows (rows 1..OUT of each tile)."""
    c, ntiles, _ = out0.shape
    return out0[..., 1:].reshape(c, ntiles * OUT)[:, :m]


def _parent(dsc, b0, cc, a, zi, scan=1024):
    """The parent's three launches: the tile (zero-state outputs and
    zend), fm_chain_tile_scan (per channel a Kogge-Stone scan of the
    tiles' affine maps in chunks of `scan` tiles, warps of 32 and a scan
    of the warp totals) and fm_chain_inject. Returns (audio, zf)."""
    c, m = dsc.shape
    out0, zend, n_real = _tiles(dsc, b0, cc, a)
    ntiles = zend.shape[1]
    zstart = np.zeros((c, ntiles), np.float32)
    zstart[:, 0] = zi
    zf = np.zeros(c, np.float32)
    carry = np.asarray(zi, np.float32).copy()
    for base in range(0, ntiles, scan):
        k = base + np.arange(scan)
        live = k < ntiles
        big_a = np.where(live, [_ipow(a, n_real[i]) if i < ntiles else 1
                                for i in k], F32(1)).astype(np.float32)
        big_a = np.broadcast_to(big_a, (c, scan)).copy()
        u = np.zeros((c, scan), np.float32)
        u[:, live] = zend[:, k[live]]
        ua, uu = big_a.reshape(c, -1, 32), u.reshape(c, -1, 32)
        for s in (1, 2, 4, 8, 16):
            ap = np.ones_like(ua)
            up = np.zeros_like(uu)
            ap[..., s:], up[..., s:] = ua[..., :-s], uu[..., :-s]
            on = np.arange(32) >= s
            uu = np.where(on, _fmaf(ua, up, uu), uu)
            ua = np.where(on, (ua * ap).astype(np.float32), ua)
        wa, wu = ua[..., 31].copy(), uu[..., 31].copy()   # (c, warps)
        for s in (1, 2, 4, 8, 16):
            ap = np.ones_like(wa)
            up = np.zeros_like(wu)
            ap[:, s:], up[:, s:] = wa[:, :-s], wu[:, :-s]
            on = np.arange(wa.shape[1]) >= s
            wu = np.where(on, _fmaf(wa, up, wu), wu)
            wa = np.where(on, (wa * ap).astype(np.float32), wa)
        pa = np.concatenate([np.ones((c, 1), np.float32), wa[:, :-1]], 1)
        pu = np.concatenate([np.zeros((c, 1), np.float32), wu[:, :-1]], 1)
        warp_on = np.arange(ua.shape[1]) > 0
        uu = np.where(warp_on[:, None], _fmaf(ua, pu[..., None], uu), uu)
        ua = np.where(warp_on[:, None], (ua * pa[..., None]).astype(
            np.float32), ua)
        z_after = _fmaf(ua, carry[:, None, None], uu).reshape(c, scan)
        for i in np.nonzero(live)[0]:
            kk = base + i
            if kk + 1 < ntiles:
                zstart[:, kk + 1] = z_after[:, i]
            else:
                zf = z_after[:, i].copy()
        carry = z_after[:, -1].copy()
    audio = _store(out0, m)
    j = np.arange(m)
    pw = np.array([_ipow(a, v) for v in range(OUT)], np.float32)
    return _fmaf(pw[j % OUT], zstart[:, j // OUT], audio), zf


class _Scratch:
    """The scratch of one stream: header (epoch index, tickets), then a
    stamped word a slot for aggregates and one for inclusive states
    (csrc/lookback.cuh, fm_chain.cu's Scratch), kept across calls.
    ``refresh`` False leaves out the header's refresh."""

    def __init__(self, slots, period=(1 << 32) - 1, refresh=True):
        self.slots, self.period, self.index = slots, period, 0
        self.do_refresh = refresh
        self.agg = np.zeros((slots, 2))      # (value, epoch)
        self.incl = np.zeros((slots, 2))

    def refresh(self, written):
        """The block of a call's first ticket: slot h mod slots, where the
        call writes none of it."""
        s = self.index % self.slots
        if self.do_refresh and s >= written:
            self.agg[s] = (0.0, self.index + 1)
            self.incl[s] = (0.0, self.index + 1)


def _window_state(sc, c, ch, tile, big_a, zi, epoch):
    """(terminal state, first tile composed forward, predecessors read
    before the stop) of channel ch's look-back: fm_chain_tile's
    window_state over the tiles of its window (one poll), start_state's
    walk where no stop lies within it; both take the same stop for the
    same published words: tile -1 (zi), a composed power A^m exactly 0 in
    float32 (z_start of that tile weighs nothing: 0 before it), a
    published inclusive state."""
    p = F32(1)
    for m in range(1, tile + 2):
        i = tile - m
        if i < 0:
            return F32(zi), 0, m - 1
        p = F32(p * big_a)
        if p == 0:
            assert sc.agg[i * c + ch][1] == epoch
            return F32(0), i, m - 1
        val, ep = sc.incl[i * c + ch]
        if ep == epoch:
            return F32(val), i + 1, m
        assert sc.agg[i * c + ch][1] == epoch
    raise AssertionError("a look-back ran past tile -1")


def _one_pass(dsc, b0, cc, a, zi, kch, rng, scratch=None, p_incl=0.5):
    """fm_chain_tile in one launch, blocks of kch channels in ticket order,
    on ``scratch`` (a fresh one: None): returns (audio, zf, walks), walks
    the predecessors each look-back read before it stopped. A block's
    aggregate lands at once (before its own look-back); its inclusive
    states land at once with probability p_incl, else at the end of the
    call, so a look-back meanwhile reads the word an earlier call left
    there, and takes it only where it carries this call's epoch."""
    c, m = dsc.shape
    out0, zend, n_real = _tiles(dsc, b0, cc, a)
    ntiles = zend.shape[1]
    groups = -(-c // kch)
    sc = scratch or _Scratch(ntiles * c)
    assert sc.slots >= ntiles * c
    epoch = sc.index + 1
    sc.refresh(ntiles * c)
    big_a = _ipow(a, OUT)
    pw = np.array([_ipow(a, r - 1) if r > 0 else 0 for r in range(TILE)],
                  np.float32)
    out = out0.copy()
    zf = np.zeros(c, np.float32)
    pending, walks = [], []
    for t in range(ntiles * groups):
        tile, group = divmod(t, groups)
        chans = range(group * kch, min(c, (group + 1) * kch))
        for ch in chans:                           # the aggregate
            sc.agg[tile * c + ch] = (zend[ch, tile], epoch)
        for ch in chans:              # thread ch: window_state, start_state
            z, start, walk = _window_state(sc, c, ch, tile, big_a, zi[ch],
                                           epoch)
            for i in range(start, tile):
                val, ep = sc.agg[i * c + ch]
                assert ep == epoch
                z = _fmaf(big_a, z, F32(val))
            walks.append(walk)
            out[ch, tile] = _fmaf(pw, z, out0[ch, tile])
            incl = _fmaf(_ipow(a, n_real[tile]), z, zend[ch, tile])
            if rng.random() < p_incl:
                sc.incl[tile * c + ch] = (incl, epoch)
            else:
                pending.append((tile * c + ch, incl))
            if tile == ntiles - 1:
                zf[ch] = incl
    for slot, incl in pending:
        sc.incl[slot] = (incl, epoch)
    sc.index = (sc.index + 1) % sc.period
    return _store(out, m), zf, walks


def _dsc(c, m, seed):
    """Discriminator outputs of FM audio: a tone and noise, |d| < pi."""
    rng = np.random.default_rng(seed)
    j = np.arange(m)
    d = (0.5 * np.sin(2 * np.pi * 0.013 * j + rng.uniform(0, 6, (c, 1)))
         + 0.2 * rng.standard_normal((c, m)))
    return d.astype(np.float32)


def _deemph(fs_audio, tau=75e-6):
    """The bilinear de-emphasis triple of FmChannelizer at the audio rate
    (b0, cc, a): b = (w, w)/(1 + w), a = (1, (w - 1)/(1 + w))."""
    w = np.tan(1.0 / (2 * fs_audio * tau))
    b0 = w / (1 + w)
    return tuple(F32(v) for v in deemphasis_triple((b0, b0),
                                                   (1.0, (w - 1) / (1 + w))))


# (name, (b0, cc, a)): the flagship's 250-kHz audio (a ~ 0.948, a^255 ~
# 1.2e-6, the look-back's power is 0 at 8 tiles), FM wideband critical's
# 15.6 kHz (a ~ 0.375, a^255 = 0), fm_demod's identity (a = 0), a = 0.90
# (fm_rx at 128 kHz) and a = 0.999 (a^255 ~ 0.77: nothing stops the
# look-back but an inclusive state or tile -1)
CASES = {
    "flagship": _deemph(250e3),
    "wideband": _deemph(1e6 / 64),
    "identity": tuple(F32(v) for v in deemphasis_triple((1, 0), (1, 0))),
    "a090": (F32(0.05), F32(0.05), F32(0.90)),
    "a0999": (F32(5e-4), F32(5e-4), F32(0.999)),
}


def _exact(a):
    return _ipow(a, OUT) == 0


def test_cases_span_both_regimes():
    """The cases' a and a^255, as the card probe prints them: exact (0)
    at FM wideband critical and fm_demod, not at the flagship's 250-kHz
    de-emphasis, whose a^255 is ~1.2e-6."""
    assert CASES["identity"][2] == 0 and CASES["identity"][1] == 0
    assert _exact(CASES["wideband"][2]) and _exact(CASES["identity"][2])
    assert 0.94 < CASES["flagship"][2] < 0.95
    assert 1e-6 < _ipow(CASES["flagship"][2], OUT) < 2e-6
    assert not _exact(CASES["a090"][2]) and not _exact(CASES["a0999"][2])


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("c, m", [(1, OUT * 9 + 37), (3, OUT * 12),
                                  (5, OUT * 7 + 1), (16, OUT * 5 + 200),
                                  (17, OUT * 4 + 3)])
def test_one_pass_against_the_parent(name, c, m):
    """The one-pass back end against the parent's three launches at tile
    edges and a ragged last tile, zi != 0: bit for bit where a^255 is 0 in
    float32 (np.array_equal: -0 equals +0, as torch.equal), else within
    1e-6 of max|audio|, zf within 1e-6 max(1, max|audio|)."""
    b0, cc, a = CASES[name]
    dsc = _dsc(c, m, seed=c * 100 + m)
    zi = np.random.default_rng(c).uniform(-0.5, 0.5, c).astype(np.float32)
    kch = _one_chunk_channels()(c)
    want, zf_want = _parent(dsc, b0, cc, a, zi)
    got, zf, _ = _one_pass(dsc, b0, cc, a, zi, kch,
                           np.random.default_rng(m))
    if _exact(a):
        assert np.array_equal(got, want) and np.array_equal(zf, zf_want)
    else:
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 1e-6 * scale
        assert float(np.abs(zf - zf_want).max()) <= 1e-6 * max(1.0, scale)


@pytest.mark.parametrize("name", ["flagship", "a090", "a0999"])
def test_look_back_does_not_depend_on_what_is_published(name):
    """The start states compose in the order of the recursion from the
    state where the look-back stopped, so which predecessors had
    published their inclusive states changes no bit: none visible (every
    look-back walks to the zero power or tile -1), all, and at random.
    At a = 0.999 with 40 tiles no power reaches 0: the look-backs that see
    no inclusive state walk back to tile -1."""
    b0, cc, a = CASES[name]
    c, m = 3, OUT * 40 - 11
    dsc = _dsc(c, m, seed=9)
    zi = np.array([0.3, -0.2, 0.0], np.float32)
    runs = [_one_pass(dsc, b0, cc, a, zi, 4, np.random.default_rng(s),
                      p_incl=p) for s, p in ((0, 0.0), (1, 1.0), (2, 0.5),
                                             (3, 0.2))]
    for audio, zf, _ in runs[1:]:
        assert np.array_equal(audio, runs[0][0])
        assert np.array_equal(zf, runs[0][1])
    walks = runs[0][2]
    if name == "a0999":
        assert max(walks) == 39
    else:
        # within the 16 tiles a block of 16 channels polls at once
        stop = 8 if name == "flagship" else 4
        assert max(walks) == stop - 1 and np.all(np.array(runs[1][2]) <= 1)


def test_exact_power_stops_at_the_first_predecessor():
    """Where a^255 is 0 every look-back reads one aggregate and no
    inclusive state, whatever is published."""
    b0, cc, a = CASES["wideband"]
    dsc = _dsc(5, OUT * 30, seed=4)
    zi = np.zeros(5, np.float32)
    for p in (0.0, 1.0):
        _, _, walks = _one_pass(dsc, b0, cc, a, zi, 8,
                                np.random.default_rng(0), p_incl=p)
        assert max(walks) == 0


@pytest.mark.parametrize("name", ["flagship", "a090", "identity"])
def test_one_pass_against_the_plain_chain(name):
    """The de-emphasis of fm_chain_reference at f32 (its blocked IIR scan)
    on the chain's own discriminator output: the one-pass back end within
    1e-5 of max|audio|, zf alike, over 9 tiles of 3 channels."""
    b0, cc, a = CASES[name]
    c, t, d, m = 3, 16, 2, OUT * 8 + 100
    rng = np.random.default_rng(12)
    nb = (m - 1) * d + t
    x = TCA(torch.from_numpy(rng.standard_normal(nb).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(nb).astype(np.float32)))
    bank = torch.from_numpy(
        rng.standard_normal((2 * c, 2, t)).astype(np.float32) / t)
    lo = torch.from_numpy(rng.uniform(0, 0.01, (c, 4)).astype(np.float32))
    n0 = torch.tensor(17, dtype=torch.int32)
    carry_f = TCA(torch.ones(c, 1), torch.zeros(c, 1))
    zi = np.array([0.1, -0.3, 0.2], np.float32)
    deemph = torch.tensor([b0, cc, a], dtype=torch.float32)
    gain = 0.7
    audio, _, zf = fm_chain_reference(x, bank, lo, n0, d, gain, deemph,
                                      carry_f, torch.from_numpy(zi[:, None]))
    y = rotate_bank(graded_bank_front(x, bank, d), lo, n0, d)
    disc = quad_fm_demod(TCA(torch.cat([carry_f.re, y.re], -1),
                             torch.cat([carry_f.im, y.im], -1)), gain)
    got, zf_got, _ = _one_pass(disc.numpy(), b0, cc, a, zi, 4,
                               np.random.default_rng(1))
    scale = float(audio.abs().max())
    assert float(np.abs(got - audio.numpy()).max()) <= 1e-5 * scale
    assert float(np.abs(zf_got - zf.numpy()[:, 0]).max()) <= \
        1e-5 * max(1.0, scale)


def test_one_chunk_channel_planner():
    """one_chunk_channels: 4 up to C = 4, 8 up to 8, kCG = 16 above (a
    block of 16 per group at C = 17), and the widest block for any C."""
    plan = _one_chunk_channels()
    assert [plan(c) for c in range(1, 18)] == [4] * 4 + [8] * 4 + [16] * 9
    assert plan(0) == CG == 16 and plan(-1) == CG


def _calls(sc, shapes, p_incl):
    """Calls (C, M, seed) on ``sc``: True where each equals the same call
    on a fresh scratch, bit for bit."""
    b0, cc, a = CASES["a090"]
    same = []
    for c, m, seed in shapes:
        dsc = _dsc(c, m, seed=seed)
        zi = np.random.default_rng(seed).uniform(-1, 1, c).astype(np.float32)
        kch = _one_chunk_channels()(c)
        got = _one_pass(dsc, b0, cc, a, zi, kch, np.random.default_rng(seed),
                        scratch=sc, p_incl=p_incl)
        fresh = _one_pass(dsc, b0, cc, a, zi, kch,
                          np.random.default_rng(seed), p_incl=p_incl)
        same.append(np.array_equal(got[0], fresh[0])
                    and np.array_equal(got[1], fresh[1]))
    return same


def test_scratch_slots_and_refresh_over_calls():
    """Calls of other sizes share one scratch without a reset: at an epoch
    period of 25 over 12 slots (2 * slots - 1 under the period, as the
    launch's 0x7fffffff slots are under 2^32 - 1), 60 random calls of 1-4
    channels and 1-3 tiles each equal the same call on a fresh scratch,
    bit for bit, and so does the worst pattern: a call over every slot,
    calls of one slot until its epoch comes round, then a call over every
    slot whose inclusive states all land late. Without the refresh that
    last call takes a word an earlier call stamped: the check has
    teeth."""
    period, slots = 25, 12
    rng = np.random.default_rng(3)
    shapes = [(int(rng.integers(1, 5)), int(rng.integers(1, 3 * OUT + 1)),
               s) for s in range(60)]
    assert all(_calls(_Scratch(slots, period), shapes, 0.5))
    worst = ([(4, 3 * OUT, 0)] + [(1, 7, s) for s in range(1, period)],
             [(4, 3 * OUT, 99)])
    sc = _Scratch(slots, period)
    assert all(_calls(sc, worst[0], 1.0) + _calls(sc, worst[1], 0.0))
    sc = _Scratch(slots, period, refresh=False)
    assert all(_calls(sc, worst[0], 1.0))
    assert _calls(sc, worst[1], 0.0) == [False]


@pytest.mark.parametrize("tool", ["back_end_variants", "back_end_timeline"])
def test_back_end_tools_apply_to_the_sources(tool):
    """Every edit of tools/back_end_variants.py (the look-back's ablations
    timed on the card) and tools/back_end_timeline.py (its timestamps)
    finds its text once in the sources."""
    import importlib.util
    import sys

    tools = _build.CSRC.parents[2] / "tools"
    sys.path.insert(0, str(tools))
    try:
        spec = importlib.util.spec_from_file_location(tool,
                                                      tools / f"{tool}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(tools))
    edits = (list(module.VARIANTS.values()) if tool == "back_end_variants"
             else [module.EDITS])
    for group in edits:
        for source, text, _ in group:
            assert (_build.CSRC / source).read_text().count(text) == 1, text
