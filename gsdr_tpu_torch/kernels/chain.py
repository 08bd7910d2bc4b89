"""What the port's kernel wrappers share (the fused chains ``fm_chain`` and
``am_chain``, the standalone ``channelize``, ``qpsk256`` and ``iir``).

  - ``ChainKernel``, the wrapper of one kernel entry point: it launches the
    kernel for CUDA tensors, counts the launches, and takes the plain
    version only for tensors on the CPU;
  - the operand checks made before a launch;
  - the block plan, asked before a launch: the taps a block of the dense
    front stages at once (``dense_chunk``: the whole bank where it fits,
    else chunks), and the lanes and fold taps a block of the PFB front
    stages at once (``pfb_chunk``: everything where it fits, else chunks
    of lanes and of fold taps), so both fronts take any geometry the JAX
    package's plans take. The libraries that launch a front answer it
    themselves (``<library>_fits`` in ``csrc/``), from the same geometry
    they launch with, so no copy of the geometry lives here;
  - the grades of both fronts (``GRADES``): 'f32' on the FP32 FMAs,
    'bf16x3' and 'bf16x2' on the tensor cores, as the JAX package's
    kernels define them; the bf16 split of the taps, the window and the
    fold (``split_bf16``), the tensor-core fronts' B tables
    (``dense_mma_tables``, ``pfb_mma_tables``; for the PFB front's chunked
    kernel its taps and B table in its lane order, ``pfb_chunk_taps`` and
    ``pfb_mma_chunk_tables``, picked by ``pfb_operands``), the f32 fronts'
    tap and bank tables (``dense_f32_tables``, ``pfb_f32_tables``) and the
    plain versions of the fronts at each grade (``graded_bank_front``,
    ``graded_uniform_front``);
  - ``select_front``, the receivers' choice between the dense and the PFB
    front, made once at construction;
  - ``hold_for_graph``: what a launch captured in a CUDA graph needs kept
    alive beyond the tensors the capture allocates (the look-back
    scratch);
  - ``LookBackScratch``: the per-stream scratch of a kernel with a
    decoupled look-back (B5's IIR and the FM chain's de-emphasis,
    ``csrc/lookback.cuh``), never reset between calls;
  - ``CHAIN_CLOCKS`` and ``counted_launch``: the counters of the chain
    kernels' counted instantiations (``csrc/clocks.cuh``), launched where
    tracing counts (``utils/profiling.py``).
"""

import contextlib
import contextvars
import ctypes
import functools

import torch
from torch.utils.weak import WeakIdKeyDictionary

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.kernels._build import load_library
from gsdr_tpu_torch.ops.channelize import mix_fir_decimate_bank
from gsdr_tpu_torch.ops.pfb import (
    pfb_preferred,
    uniform_bank_front,
    uniform_grid,
)
from gsdr_tpu_torch.utils import profiling
from gsdr_tpu_torch.utils.precision import full_f32

# The fronts' grades and their codes in the C interface: the number of
# tensor-core passes, 0 for the FP32-FMA fronts.
GRADES = {"f32": 0, "bf16x2": 2, "bf16x3": 3}

# The output rows a block of the PFB front's chunked kernel takes at the
# bf16 grades (csrc/fronts.cuh, pfb_mma_rows; every other block the
# first, kTile)
PFB_ROWS = (256, 128, 64)


class ChainKernel:
    """Wrapper of one kernel entry point. ``launch(buf, *args, **kw)`` runs
    the kernel; ``plain(buf, *args, **kw)`` is its plain version, taken
    when the input ``buf`` (planar, or a real tensor) lies on the CPU.
    Each takes the defaults of its own signature: the graded wrappers
    (``fm_chain``, ``pfb_fm_chain``, ``am_chain``, ``pfb_am_chain``,
    ``channelize_kernel``) launch at 'bf16x3', the JAX kernels' default
    grade, and their plain versions run 'f32', as the models do on the CPU
    (the JAX package's XLA path); a caller who wants the same grade on
    both passes ``precision``. The dense-front launches also take
    ``chunk``, the taps a block stages at once (default: the library's
    plan, ``dense_chunk``), and the PFB-front launches ``plan``, the
    (lanes, fold taps) a block stages at once (default ``pfb_chunk``'s),
    which the card tests force smaller to run the chunked paths at small
    geometries, ``fm_chain`` ``channels``, the channels of its bf16
    block, and the PFB-front launches ``rows``, the output rows of the
    chunked kernel's block at the bf16 grades (default the library's
    plan, ``pfb_block``); the plain versions have no such arguments.
    ``launches`` counts kernel launches and nothing else; ``row_tiles``,
    of a wrapper made with ``row_tiles=PFB_ROWS``, counts its chunked
    bf16 launches by the rows of their blocks (as ``launches``, a CUDA
    graph's capture and not its replays)."""

    def __init__(self, name, plain, launch, row_tiles=()):
        self.name = name
        self.plain = plain
        self.launch = launch
        self.launches = 0
        self.row_tiles = dict.fromkeys(row_tiles, 0)

    def __call__(self, buf, *args, **kwargs):
        dev = buf.device
        if dev.type == "cpu":
            return self.plain(buf, *args, **kwargs)
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: tensors on {dev}, need cuda or cpu")
        out = self.launch(buf, *args, **kwargs)
        self.launches += 1
        return out


_graph_refs = contextvars.ContextVar("graph_refs", default=None)
_unowned_refs = {}


@contextlib.contextmanager
def graph_refs(refs):
    """Inside the block, ``hold_for_graph`` appends to the list ``refs``:
    the capture of one CUDA graph, whose owner keeps ``refs``."""
    token = _graph_refs.set(refs)
    try:
        yield refs
    finally:
        _graph_refs.reset(token)


def hold_for_graph(obj):
    """Keep ``obj`` alive as long as the CUDA graph being captured: a
    wrapper calls it for device memory that it keeps itself and that a
    captured launch reads or writes. Outside ``graph_refs`` (a capture
    that ``utils.compile.compile_step`` did not start) ``obj`` is kept for
    the life of the process."""
    refs = _graph_refs.get()
    if refs is None:
        _unowned_refs[id(obj)] = obj
    else:
        refs.append(obj)


class _Slots:
    """A look-back scratch of ``slots`` slots on one (device, stream):
    zeroed when allocated, then reused by every call on that stream
    without a reset. Its header, on the device, counts the calls (each
    stamps its published states with a new epoch) and their tickets; the
    kernel advances it, so eager calls and replays of a CUDA graph share a
    scratch in any order."""

    __slots__ = ("buf", "slots")

    def __init__(self, slots, nbytes, dev):
        self.slots = slots
        self.buf = torch.zeros(nbytes, dtype=torch.uint8, device=dev)


class LookBackScratch:
    """The scratches of one library's look-back, one per (device, stream)
    in ``by_stream`` (keyed by (device index, stream)); ``nbytes(slots)``
    is the library's size of a scratch of ``slots`` slots, ``min_slots``
    the slots the first scratch of a stream holds."""

    def __init__(self, library, nbytes, min_slots):
        self.library = library
        self.nbytes = nbytes
        self.min_slots = min_slots
        self.by_stream = {}

    def get(self, dev, stream, slots):
        """The scratch of (dev, stream) with room for ``slots`` slots; a
        larger one replaces it when a call needs more. Inside a CUDA-graph
        capture the scratch must exist already (a warm-up call outside the
        capture makes it), and the graph keeps it alive: its launch holds
        the pointer, even after an eager call has replaced it here."""
        key = (dev.index, stream)
        s = self.by_stream.get(key)
        capturing = torch.cuda.is_current_stream_capturing()
        if s is None or s.slots < slots:
            if capturing:
                raise RuntimeError(
                    f"{self.library}: no scratch of {slots} slots on the "
                    "capturing stream; run the step once on that stream "
                    "before the capture")
            n = max(slots, self.min_slots)
            s = self.by_stream[key] = _Slots(n, self.nbytes(n), dev)
        if capturing:
            hold_for_graph(s)
        return s


# The counters of a counted chain kernel, in the order of their slots
# (csrc/clocks.cuh, Counter): launches and blocks; the SM clocks of the
# blocks, of their front call, of the consumer and the producer warps'
# front, and of the warps' waits for a folded chunk (consumers), for a
# free A tile and for their staging (producers); the look-back's poll
# clocks (a block's longest thread) and polls (the FM chain's).
CHAIN_CLOCKS = ("launches", "blocks", "block_clocks", "front_clocks",
                "consumer_front_clocks", "full_wait_clocks",
                "producer_front_clocks", "free_wait_clocks",
                "stage_wait_clocks", "poll_clocks", "polls")


def counted_launch(counters, dev, grade, plan, k, q):
    """The address of ``counters``' buffer on ``dev`` for a PFB-front
    launch at the grade code ``grade`` and the plan (lanes, fold taps)
    where tracing counts (``profiling.COUNTERS``) and the launch has a
    counted instantiation (the chunked kernel at bf16x3), else None. A
    graph being captured keeps the buffer (``hold_for_graph``)."""
    if profiling.level < profiling.COUNTERS or grade != GRADES["bf16x3"] \
            or (plan[0] >= k and plan[1] >= q):
        return None
    buf = counters.buffer(dev)
    if torch.cuda.is_current_stream_capturing():
        hold_for_graph(buf)
    return buf.data_ptr()


def grade_code(fn, precision):
    """The C interface's code of a grade; raise for another."""
    if precision not in GRADES:
        raise ValueError(f"{fn}: precision must be one of {tuple(GRADES)}, "
                         f"got {precision!r}")
    return GRADES[precision]


def split_bf16(x):
    """(hi, lo) bfloat16 parts of a float32 tensor, both rounded to nearest
    even: hi = bf16(x), lo = bf16(x - hi). The JAX package's split of the
    taps (``_split_g``) and of the window (``_window_dot``)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def graded_bank_front(x, tap_bank, decimation, precision="f32"):
    """The plain version of the dense front at a grade: planar (N,) x
    through the (2C, 2, T) bank to the un-rotated planar (C, M).

    'f32' is ``mix_fir_decimate_bank(impl='torch')``. 'bf16x3' splits the
    taps and the window as the kernels do (``split_bf16``) and sums three
    full-float32 convolutions of the bf16-valued planes, gh*xh + gl*xh +
    gh*xl, in the JAX package's order; 'bf16x2' the first two. Every
    product of two bf16 values is exact in float32, so this equals the
    grade up to summation order."""
    grade_code("graded_bank_front", precision)
    if precision == "f32":
        return mix_fir_decimate_bank(x, tap_bank, decimation, impl="torch")
    gh, gl = (p.float() for p in split_bf16(tap_bank))
    (xh_re, xl_re), (xh_im, xl_im) = split_bf16(x.re), split_bf16(x.im)
    xh = ComplexArray(xh_re.float(), xh_im.float())
    passes = [(xh, gh), (xh, gl)]
    if precision == "bf16x3":
        passes.append((ComplexArray(xl_re.float(), xl_im.float()), gh))
    y = None
    for xs, g in passes:
        p = mix_fir_decimate_bank(xs, g, decimation, impl="torch")
        y = p if y is None else ComplexArray(y.re + p.re, y.im + p.im)
    return y


def graded_uniform_front(x, poly_taps, dft_bank, num_taps, decimation,
                         precision="f32"):
    """The plain version of the PFB front at a grade: planar (N,) x through
    the (Q, K) polyphase taps and the planes-major (2C, 2K) DFT bank to the
    un-rotated planar (C, M), M = (N - T)//D + 1.

    'f32' is ``uniform_bank_front``. At 'bf16x3' and 'bf16x2' the fold
    A[j, v] = sum_u hp[u, v] x[jD + v + uK] is made in float32 as the
    kernel makes it, x*hp[0] first, then + x*hp[u] for ascending u, each
    product and sum rounded on its own (samples past N read as zeros);
    A and the bank are split (``split_bf16``) and the passes Gh*Ah + Gl*Ah
    (+ Gh*Al at bf16x3) summed in full float32 in that order, as the JAX
    package's ``_nt_grade_dot``. Every product of two bf16 values is exact
    in float32, so this equals the grade up to summation order."""
    grade_code("graded_uniform_front", precision)
    if precision == "f32":
        return uniform_bank_front(x, poly_taps, dft_bank, num_taps,
                                  decimation)
    q, k = poly_taps.shape
    d = int(decimation)
    if k % d != 0:
        raise ValueError(f"uniform PFB needs D | K (D={d}, K={k})")
    n = x.shape[-1]
    m = (n - int(num_taps)) // d + 1
    if m <= 0:
        raise ValueError(f"need at least {num_taps} samples, got {n}")
    span = (m - 1) * d + q * k
    idx = (torch.arange(m, device=poly_taps.device)[:, None] * d
           + torch.arange(k, device=poly_taps.device)[None, :])

    def fold(plane):
        xp = torch.nn.functional.pad(plane, (0, max(0, span - n)))
        a = xp[idx] * poly_taps[0]
        for u in range(1, q):
            a = a + xp[idx + u * k] * poly_taps[u]
        return a                                             # (M, K)

    fold_all = torch.cat([fold(x.re), fold(x.im)], dim=1)   # (M, 2K)
    ah, al = (p.float() for p in split_bf16(fold_all))
    gh, gl = (p.float() for p in split_bf16(dft_bank))
    passes = [(gh, ah), (gl, ah)]
    if precision == "bf16x3":
        passes.append((gh, al))
    y = None
    with full_f32():
        for g, a in passes:
            p = torch.matmul(g, a.t())                       # (2C, M)
            y = p if y is None else y + p
    c = dft_bank.shape[0] // 2
    return ComplexArray(y[:c], y[c:])


def _mma_words(w):
    """The tensor-core B operand of a complex bank given as w (C, L, 2), the
    even GEMM column (plane 0, plane 1) of channel c at row l: int32
    (2, ceil(L/8), ceil(C/4), 16, 2), part 0 the bf16 high and part 1 the
    low parts; entry [part][kb][nt][4*cl + q][i] holds row 8*kb + q + 4*i
    of channel 4*nt + cl, plane 0 in the low 16 bits; zero past L and C."""
    c, el, _ = w.shape
    kb, nt = -(-el // 8), -(-c // 4)
    padded = torch.zeros((4 * nt, 8 * kb, 2), dtype=torch.float32,
                         device=w.device)
    padded[:c, :el] = w
    parts = []
    for part in split_bf16(padded):
        words = part.contiguous().view(torch.int32).reshape(nt, 4, kb, 2, 4)
        parts.append(words.permute(2, 0, 1, 4, 3).reshape(kb, nt, 16, 2))
    return torch.stack(parts).contiguous()


_MMA_TABLES = WeakIdKeyDictionary()


def _cached_table(bank, build, kind="mma"):
    """build(bank), kept while the tensor lives and rebuilt after it is
    written in place; one table of each ``kind`` a tensor."""
    hits = _MMA_TABLES.setdefault(bank, {})
    hit = hits.get(kind)
    if hit is not None and hit[0] == bank._version:
        return hit[1]
    table = build(bank)
    hits[kind] = (bank._version, table)
    return table


def dense_mma_tables(tap_bank):
    """The tensor-core front's B operand for a (2C, 2, T) complex tap bank
    (``make_complex_tap_bank``), on its device: int32 (2, KB, NT, 16, 2),
    KB = ceil(T/8), NT = ceil(C/4), part 0 the bf16 high and part 1 the
    low parts (``split_bf16``). Entry [part][kb][nt][4*cl + q][i] is the
    (gr, -gi) pair of channel 4*nt + cl at tap 8*kb + q + 4*i, the bank's
    even row 2c, plane 0 in the low 16 bits; zero past T and C. Both bf16
    grades read it: each takes the taps high and low.

    Built once per bank tensor and kept while the tensor lives (a model's
    buffer, ``pfb_channelize``'s cached bank); rebuilt after the tensor is
    written in place. Callers must not write to it."""
    return _cached_table(
        tap_bank, lambda b: _mma_words(b[0::2].transpose(1, 2)))


def dense_f32_tables(tap_bank):
    """The f32 dense front's tap operand for a (2C, 2, T) complex tap bank
    (``make_complex_tap_bank``), on its device: float32 (ceil(C/8), T, 8,
    2); entry [g][t][cl] is (gr, gi) of channel c = 8*g + cl at tap t,
    the bank's rows 4c (gr, applied to x_re) and 4c + 2 (gi) at column t,
    zero past C. A group's 8 channels of one tap are 64 contiguous bytes
    and a chunk of its taps one contiguous range, which a block copies 16
    bytes a thread. Cached per tensor as ``dense_mma_tables``."""
    def build(bank):
        c2, _, t = bank.shape
        c = c2 // 2
        ng = -(-c // 8)
        table = torch.zeros((ng * 8, t, 2), dtype=torch.float32,
                            device=bank.device)
        table[:c, :, 0] = bank[0::2, 0]
        table[:c, :, 1] = bank[1::2, 0]
        return table.reshape(ng, 8, t, 2).transpose(1, 2).contiguous()

    return _cached_table(tap_bank, build, "dense_f32")


def _dft_rows(bank, fn):
    """(re rows, C, K) of a planes-major (2C, 2K) DFT bank, or raise where
    row C+c is not (-G[c, K:], G[c, :K]) bit for bit, the sign of a zero
    included: the kernels form the im rows from the re rows."""
    c2, k2 = bank.shape
    c, k = c2 // 2, k2 // 2
    re, im = bank[:c], bank[c:]

    def same(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    if c2 % 2 or k2 % 2 or not (same(im[:, :k], -re[:, k:])
                                and same(im[:, k:], re[:, :k])):
        raise ValueError(
            f"{fn}: dft_bank must be a planes-major (2C, 2K) DFT bank whose "
            f"row C+c is (-G[c, K:], G[c, :K])")
    return re, c, k


def pfb_mma_tables(dft_bank):
    """The tensor-core PFB front's B operand for a planes-major (2C, 2K)
    DFT bank (``ops.pfb._dft_bank_stacked``), on its device: the layout of
    ``dense_mma_tables`` over lanes v in place of taps, int32
    (2, ceil(K/8), ceil(C/4), 16, 2); entry [part][kb][nt][4*cl + q][i] is
    the bf16 pair (G[c, v], G[c, K+v]) of channel c = 4*nt + cl at lane
    v = 8*kb + q + 4*i, the split of the JAX package's ``_split_g``. The
    bank's im rows are not stored: row C+c must be row c with its halves
    swapped and the new first half negated, (G[c, K+v], G[c, v]) =
    (-wi, wr) -> (wi, wr), which every DFT bank satisfies and the kernel
    forms in registers; a bank without that structure raises. Cached per
    tensor as ``dense_mma_tables``."""
    def build(bank):
        re, c, k = _dft_rows(bank, "pfb_mma_tables")
        return _mma_words(torch.stack([re[:, :k], re[:, k:]], dim=-1))

    return _cached_table(dft_bank, build)


@functools.lru_cache(maxsize=None)
def pfb_lane_order(k, decimation):
    """The lanes v of the bf16 PFB front's chunked kernel
    (``fronts.cuh``, pfb_front_mma_chunked) in its order, -1 for padding:
    groups of Dc = min(D, 16) phases from p0, a group's lanes kappa = pl*P
    + s (v = p0 + pl + s*D, P = K/D) in ascending kappa, padded to whole
    blocks of 8 lanes, so that group g starts at lane 8*g*ceil(Dc*P/8)
    and a chunk's lanes are one run of the order."""
    k, d = int(k), int(decimation)
    p, dc = k // d, min(d, 16)
    order = []
    for p0 in range(0, d, dc):
        lanes = [p0 + kap // p + (kap % p) * d
                 for kap in range(min(dc, d - p0) * p)]
        order += lanes + [-1] * (-len(lanes) % 8)
    return tuple(order)


def _lane_gather(table, k, decimation):
    """table (..., K, ...) with its lane axis (axis 1) in
    ``pfb_lane_order``, zeros at padding lanes."""
    order = torch.tensor(pfb_lane_order(k, decimation), device=table.device)
    out = torch.zeros((table.shape[0], order.numel()) + table.shape[2:],
                      dtype=table.dtype, device=table.device)
    live = order >= 0
    out[:, live] = table[:, order[live]]
    return out


def pfb_mma_chunk_tables(dft_bank, decimation):
    """The B operand of the bf16 PFB front's chunked kernel, one pair of
    words a lane of the warp: int32 (2, KBg, ceil(C/4), 32, 2), KBg blocks
    of 8 lanes of ``pfb_lane_order(K, D)``, zero at padding lanes. Entry
    [part][kb][nt][4*g + t] holds the m16n8k16 B fragment of thread (g, t)
    of the warp for n-tile nt, block kb: for even g ``pfb_mma_tables``'
    entry [part][kb'][nt][4*(g/2) + t] of the block's lanes (kb' their
    block there, the lanes v = order[8*kb + t + 4*i]); for odd g (the odd
    GEMM column, the channel's im row) the same words with their halves
    swapped and the new low half negated, so the kernel forms nothing in
    registers and a chunk's B rows are one contiguous range. A bank
    without the DFT structure raises, as for ``pfb_mma_tables``. Cached per
    bank tensor and D, as ``dense_mma_tables``."""
    d = int(decimation)

    def build(bank):
        re, c, k = _dft_rows(bank, "pfb_mma_chunk_tables")
        if d < 1 or k % d:
            raise ValueError(f"pfb_mma_chunk_tables: need D | K (D={d}, "
                             f"K={k})")
        w = torch.stack([re[:, :k], re[:, k:]], dim=-1)     # (C, K, 2)
        words = _mma_words(_lane_gather(w, k, d))          # (.., 16, 2)
        lane = torch.arange(32, device=bank.device)
        g = lane // 4
        out = words[:, :, :, 4 * (g // 2) + lane % 4].long() & 0xFFFFFFFF
        odd = ((out >> 16) | ((out & 0xFFFF) << 16)) ^ 0x8000
        out = torch.where((g % 2 == 1)[:, None], odd, out)
        return torch.where(out >= 1 << 31, out - (1 << 32),
                           out).to(torch.int32).contiguous()

    return _cached_table(dft_bank, build, ("mma_chunk", d))


def pfb_chunk_taps(poly_taps, decimation):
    """The (Q, K) polyphase taps with their lanes in ``pfb_lane_order(K,
    D)``: float32 (Q, 8*KBg), zero at padding lanes, so that a u-range's
    taps of a chunk are one contiguous run of each row, which the bf16
    PFB front's chunked kernel copies 16 bytes at a time. Cached per tap
    tensor and D, as ``dense_mma_tables``."""
    d = int(decimation)

    def build(taps):
        k = taps.shape[1]
        if d < 1 or k % d:
            raise ValueError(f"pfb_chunk_taps: need D | K (D={d}, K={k})")
        return _lane_gather(taps, k, d).contiguous()

    return _cached_table(poly_taps, build, ("chunk_taps", d))


def pfb_operands(poly_taps, dft_bank, decimation, grade, plan):
    """(taps, bank table) a PFB launch of ``grade`` and ``plan`` (lanes,
    uc) reads: at 'f32' the taps and ``pfb_f32_tables``; at the bf16
    grades the taps and ``pfb_mma_tables`` for the one-chunk kernel,
    ``pfb_chunk_taps`` and ``pfb_mma_chunk_tables`` for the chunked one
    (lanes < K or uc < Q, ``fronts.cuh``'s use_chunked_pfb)."""
    if not grade:
        return poly_taps, pfb_f32_tables(dft_bank)
    q, k = poly_taps.shape
    lanes, uc = plan
    if int(lanes) < k or int(uc) < q:
        return (pfb_chunk_taps(poly_taps, decimation),
                pfb_mma_chunk_tables(dft_bank, decimation))
    return poly_taps, pfb_mma_tables(dft_bank)


def pfb_f32_tables(dft_bank):
    """The f32 PFB front's bank operand for a planes-major (2C, 2K) DFT
    bank (``ops.pfb._dft_bank_stacked``), on its device: float32
    (ceil(C/32), K, 32, 2); entry [g][v][cl] is (G[c, v], G[c, K+v]) of
    channel c = 32*g + cl at lane v, zero past C, so that a block's
    32 channels of one lane are 256 contiguous bytes. The bank's im rows
    are not stored: row C+c must be (-G[c, K:], G[c, :K]) bit for bit,
    which every DFT bank satisfies, and the kernel takes (-G[c, K+v],
    G[c, v]) in their place, the same values, so its sums are the full
    bank's; a bank without that structure raises. Cached per tensor as
    ``dense_mma_tables``."""
    def build(bank):
        re, c, k = _dft_rows(bank, "pfb_f32_tables")
        ng = -(-c // 32)
        table = torch.zeros((ng * 32, k, 2), dtype=torch.float32,
                            device=bank.device)
        table[:c, :, 0] = re[:, :k]
        table[:c, :, 1] = re[:, k:]
        return table.reshape(ng, 32, k, 2).transpose(1, 2).contiguous()

    return _cached_table(dft_bank, build, "f32")


def check_operands(fn, operands, dev):
    """Raise unless every (tensor, shape) in ``operands`` is a contiguous
    float32 tensor of that shape on ``dev``."""
    for name, (x, shape) in operands.items():
        if (x.device != dev or x.dtype != torch.float32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"{fn}: {name} must be a contiguous float32 tensor of "
                f"shape {shape} on {dev}; got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}, "
                f"contiguous={x.is_contiguous()}")


@functools.lru_cache(maxsize=None)
def load_chain_library(library):
    """The built library ``csrc/<library>.cu``, with the C signatures the
    libraries share declared: ``<library>_error_string`` and, in those that
    launch a front, ``<library>_fits(pfb, grade, C, T, K, Q, D, *plan)``;
    in those with a counted kernel, its counter slots checked against
    ``CHAIN_CLOCKS``."""
    lib = load_library(library)
    if hasattr(lib, library + "_fits"):
        fits = getattr(lib, library + "_fits")
        fits.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)]
        fits.restype = ctypes.c_int
    if hasattr(lib, library + "_counter_slots"):
        slots = getattr(lib, library + "_counter_slots")
        slots.argtypes = []
        slots.restype = ctypes.c_int
        if slots() != len(CHAIN_CLOCKS):
            raise RuntimeError(f"{library}: {slots()} counter slots in the "
                               f"library, {len(CHAIN_CLOCKS)} in CHAIN_CLOCKS")
    errs = getattr(lib, library + "_error_string")
    errs.argtypes = [ctypes.c_int]
    errs.restype = ctypes.c_char_p
    return lib


def cuda_error(library, what, err):
    """Raise a RuntimeError for a nonzero CUDA error code of ``library``."""
    if err != 0:
        lib = load_chain_library(library)
        msg = getattr(lib, library + "_error_string")(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def _block_plan(library, device_index, pfb, grade, channels, num_taps, k, q,
                decimation, outputs=0):
    """``<library>_fits``' plan on the card ``device_index``, three ints:
    for the dense front the taps a block stages at once and the channels
    and rows of the block that launches them (for ``outputs`` M outputs,
    0: any M), for the PFB front the (lanes, fold taps) a chunk takes (and
    0); a first 0 where no block fits."""
    lib = load_chain_library(library)
    plan = (ctypes.c_int * 3)(0, 0, 0)
    with torch.cuda.device(device_index):
        err = getattr(lib, library + "_fits")(
            int(pfb), grade, channels, num_taps, k, q, decimation, outputs,
            plan)
    cuda_error(library, f"{library}_fits", err)
    return plan[0], plan[1], plan[2]


def _card_index(device):
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def dense_chunk(library, device, num_taps, decimation, precision="f32",
                num_channels=None, num_outputs=None):
    """The taps a block of ``library``'s dense front stages at once on the
    card ``device`` at the grade ``precision``: T where the whole bank and
    its window fit the block's shared memory (one pass, as at the flagship,
    am_d and the transmux's K=32, Q=8), else chunks: each chunked block
    holds two staging buffers and stages the next chunk while it
    multiplies one, so a chunk is the largest multiple of 8 whose block
    lets two blocks share a SM where that chunk spans D taps or more (one
    window of all D phases a chunk, as the 2049-tap long filter's at D=4),
    else the largest that fits (the transmux at Q=127, D=32). The block
    walks the bank in ascending chunks, with the same sums in the same
    order. The library plans it from the geometry it launches with
    (``csrc/fronts.cuh``, ``dense_chunk``); the block depends on C (at
    'f32' 8, 16 or 32 channels, ``toeplitz_front``) and, for the bf16
    grades' chunked kernel, on the outputs M too (``mma_chunk_block``: 4-32
    channels and, in B3 and B4, 64-256 rows, to fill the card), so
    ``num_channels`` and ``num_outputs`` (as ``front_supported``; None: any
    C or M, the widest block) set its plan."""
    return dense_block(library, device, num_taps, decimation, precision,
                       num_channels, num_outputs)[0]


def dense_block(library, device, num_taps, decimation, precision="f32",
                num_channels=None, num_outputs=None):
    """(chunk, channels, rows) of the dense launch ``dense_chunk`` plans:
    its chunk of taps and the channels and output rows of the block that
    launches it."""
    grade = grade_code(library, precision)
    return _block_plan(library, _card_index(torch.device(device)), False,
                       grade, int(num_channels or 0), int(num_taps), 0, 0,
                       int(decimation), int(num_outputs or 0))


def pfb_chunk(library, device, k, q, decimation, precision="f32"):
    """(lanes, fold taps) a block of ``library``'s PFB front stages at once
    on the card ``device`` at the grade ``precision``, for the Fs/k grid
    with Q = q fold taps and D | k: (k, q), one chunk, where the one-chunk
    block fits (as at FM and AM wideband critical and ``wideband_rx``);
    else chunks of a multiple of 8 lanes of the one-chunk order and
    u-ranges of fold taps, the plan that stages the fewest windows; the
    block walks them with the same values in the same order, so a chunked
    launch equals the one-chunk launch. (0, 0) where no block fits, which
    no grid with P = k/D up to a few hundred meets (the JAX package's plans
    take P <= ~117). The library plans it (``csrc/fronts.cuh``,
    ``pfb_chunk``), here for a block of any C and M (256 rows;
    ``pfb_block`` plans for the block of a given C and M)."""
    return pfb_block(library, device, k, q, decimation, precision)[:2]


def pfb_block(library, device, k, q, decimation, precision="f32",
              num_channels=None, num_outputs=None):
    """(lanes, fold taps, rows) of the PFB launch ``pfb_chunk`` plans: its
    plan and the output rows of the block that takes it. The chunked
    kernel at 'bf16x3' and 'bf16x2' takes 256 rows, or 128 or 64 where
    the grid of ``num_outputs`` M outputs in row tiles x ceil(C / 32)
    channel groups (``num_channels`` C) at half the rows still fits one
    wave of the card's SMs (``csrc/fronts.cuh``, ``pfb_mma_rows``: a 20-ms
    block of the land-mobile NFM raster, 1000 outputs of 320 channels, in
    128 rows, 80 blocks on the H100's 132 SMs); every row's fold and every
    column's sum are the same at any rows. Every other block takes 256."""
    grade = grade_code(library, precision)
    k, d = int(k), int(decimation)
    if d < 1 or k % d:
        raise ValueError(f"{library}: the PFB front needs D | K (D={d}, "
                         f"K={k})")
    return _block_plan(library, _card_index(torch.device(device)), True,
                       grade, int(num_channels or 0), k * int(q), k, int(q),
                       d, int(num_outputs or 0))


def front_supported(library, device, num_taps, decimation, k=None,
                    precision="f32", num_channels=None):
    """True when ``library``'s kernel can run this front on ``device`` at
    the grade ``precision``: the dense front (``k`` None), which stages its
    taps in chunks (``dense_chunk``) and so takes any T and D, or the PFB
    front on the Fs/k grid, which needs D | k and stages its lanes and
    fold taps in chunks (``pfb_chunk``), and so takes every grid the JAX
    package's PFB plans take; on the card the answer is the library's
    plan. The plain chains on the CPU take any geometry.
    ``num_channels`` is the bank's C, on which the channelizer's block
    depends at the bf16 grades and every dense block at 'f32' (None: any
    C, the widest block). A library without the grade raises."""
    grade_code(library, precision)
    t, d = int(num_taps), int(decimation)
    if k is not None and int(k) % d != 0:
        return False
    device = torch.device(device)
    if device.type != "cuda":
        return True
    if k is not None:
        k = int(k)
        return pfb_chunk(library, device, k, -(-t // k), d, precision)[0] > 0
    return dense_chunk(library, device, t, d, precision, num_channels) > 0


def check_pfb_tables(fn, poly_taps, dft_bank, num_taps, decimation):
    """(C, K, Q) of PFB-front tables, or raise on shapes that are not a
    (ceil(T/K), K) tap table and a (2C, 2K) bank with D | K."""
    q, k = poly_taps.shape
    c2, k2 = dft_bank.shape
    d = int(decimation)
    if k2 != 2 * k or c2 % 2 or d < 1 or k % d or q * k < int(num_taps) \
            or q != -(-int(num_taps) // k):
        raise ValueError(
            f"{fn}: poly_taps {tuple(poly_taps.shape)}, dft_bank "
            f"{tuple(dft_bank.shape)}, T={num_taps}, D={d}: need "
            f"(ceil(T/K), K) and (2C, 2K) with D | K")
    return c2 // 2, k, q


def pfb_launch_plan(library, device, k, q, decimation, precision, plan,
                    num_channels, num_outputs, rows=None):
    """The (lanes, fold taps, rows) a PFB launch of C = ``num_channels``
    and M = ``num_outputs`` takes: ``plan`` where the caller forces one,
    else ``pfb_block``'s; ``rows`` where the caller forces them (card
    tests' knobs), else ``pfb_block``'s where the launch runs the chunked
    kernel at a bf16 grade (so a forced plan keeps the planned block),
    else 256. Raise where no block fits."""
    planned = pfb_block(library, device, k, q, decimation, precision,
                        num_channels, num_outputs)
    lanes, uc = (int(v) for v in (planned[:2] if plan is None else plan))
    if lanes <= 0:
        raise ValueError(
            f"{library}: no block of the PFB front fits the card for K={k}, "
            f"D={decimation}, Q={q} at precision={precision!r}")
    mma = grade_code(library, precision) and (lanes < k or uc < q)
    if rows is None:
        rows = planned[2] if mma else PFB_ROWS[0]
    return lanes, uc, int(rows)


def select_front(model, library, impl, shifts, sample_rate, decimation,
                 num_taps, device, precision="f32"):
    """The (K, bins) grid a receiver runs its PFB front on, or None for
    the dense front; shared by FmChannelizer and AmReceiver, whose kernels
    live in ``library``.

    'pfb' and 'pfb_torch' need every shift on an Fs/K grid with D | K
    (raise otherwise), and 'pfb' on the card needs the PFB kernel to plan
    the grid at the model's grade ``precision`` (``front_supported``),
    which it does for every grid the JAX package's PFB plans take. 'auto'
    on the card takes the PFB front exactly where ``pfb_preferred``
    returns a grid, as the JAX package's 'auto' takes its PFB kernel on a
    TPU, and the dense front otherwise; 'auto' on the CPU runs the dense
    plain chain, as the JAX models do off the TPU. Both kernels stage
    what outgrows a block in chunks (``dense_chunk``, ``pfb_chunk``), so
    no branch keeps the dense front because the PFB block does not fit.
    The choice is made once, here, before any launch.
    """
    d, t = int(decimation), int(num_taps)
    on_card = device.type == "cuda"
    if impl in ("pfb", "pfb_torch"):
        grid = uniform_grid(shifts, sample_rate, multiple_of=d)
        if grid is None:
            raise ValueError(
                f"{model}: impl={impl!r} needs every channel shift on an "
                f"Fs/K grid with D | K (Fs={sample_rate}, D={d})")
        if impl == "pfb" and not front_supported(library, device, t, d,
                                                 grid[0], precision):
            raise ValueError(
                f"{model}: the PFB kernel does not take K={grid[0]}, D={d}, "
                f"T={t} at precision={precision!r}; use impl='pfb_torch' or "
                f"the dense front")
        return grid
    if impl == "auto" and on_card:
        return pfb_preferred(shifts, sample_rate, d, t)
    return None
