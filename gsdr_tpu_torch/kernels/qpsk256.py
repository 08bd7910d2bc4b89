"""QPSK256 nearest-neighbour demodulator: the Hopper kernel, its wrapper,
its host-side candidate grid and its plain version.

Counterpart of ``gsdr_tpu/kernels/qpsk256_pallas.py``
(``qpsk256_demodulate_pallas``). For planar samples x (..., N) and a
256-point planar table it returns the index (..., N) of the nearest
point, argmin_i |c_i|^2 - 2 (c_i.re x.re + c_i.im x.im), the lowest index
winning ties, as ``out_dtype`` (int32 by default; uint8 for the modems).

  - ``candidate_grid``: the G x G cells over the table's bounding box and,
    per cell, the ascending list of the points that can be nearest in it
    (float64 on the host, built once per (table, device) and cached);
  - ``qpsk256_kernel``: the wrapper, counted under ``qpsk256``; it
    launches ``csrc/qpsk256.cu`` for CUDA tensors (a sample in the box
    scores its cell's list, one outside it all 256 points) and takes the
    plain version, ``qpsk256_reference`` (the score matrix as one
    full-float32 matmul, then ``torch.argmin``), only for tensors on the
    CPU. Both take |c|^2 as the float32 re*re + im*im of the same table
    planes (the kernel with its roundings pinned), bit for bit.
"""

import ctypes
import functools
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from gsdr_tpu_torch.kernels.chain import (
    ChainKernel,
    check_operands,
    cuda_error,
    load_chain_library,
)
from gsdr_tpu_torch.utils.precision import full_f32

NUM_POINTS = 256
GRID = 64                 # cells per side of the candidate grid
MAX_GRID = 64             # csrc/qpsk256.cu's kMaxGrid
MAX_CANDIDATES = 32768    # csrc/qpsk256.cu's kMaxCandidates
BLOB_ALIGN = 16           # csrc/qpsk256.cu's kBlobAlign
BOX_MARGIN = 0.1          # the box's margin on each side, of its side
CELL_WIDEN = 1e-3         # a cell's list covers it widened by this, of its side
U32 = 2.0 ** -24          # float32 unit roundoff


def score_table(constellation):
    """(ct (2, 256), c2 (256,)): the planar table stacked, and |c|^2 as the
    float32 re*re + im*im."""
    re, im = constellation.re, constellation.im
    return torch.stack([re, im]), re * re + im * im


def qpsk256_reference(x, constellation):
    """The plain version: scores c2 - 2 (x @ ct) for all 256 points in one
    matmul, then the first minimum; int32 indices shaped like x."""
    ct, c2 = score_table(constellation)
    xf = torch.stack([x.re.reshape(-1), x.im.reshape(-1)], dim=-1)   # (N, 2)
    with full_f32():
        cross = torch.matmul(xf, ct)                                 # (N, 256)
    best = torch.argmin(c2[None, :] - 2.0 * cross, dim=-1)
    return best.to(torch.int32).reshape(x.re.shape)


# ---------------------------------------------------------------------------
# The candidate grid
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class CandidateGrid:
    """G x G square cells of side 1/inv_cell from (x0, y0) (float32
    values, as the kernel maps a sample: cell (floor((x.re - x0) *
    inv_cell), floor((x.im - y0) * inv_cell))), and per cell
    gx * G + gy the ascending point indices cand[offsets[cell]:
    offsets[cell + 1]]. ``blob`` is the kernel's layout: the offsets as
    little-endian uint16, then the uint8 indices, padded to BLOB_ALIGN
    bytes. g = 0: no grid (the table defeats it), every sample searches
    all points."""

    g: int
    x0: np.float32
    y0: np.float32
    inv_cell: np.float32
    offsets: np.ndarray
    cand: np.ndarray

    @property
    def blob(self):
        raw = self.offsets.astype("<u2").tobytes() + self.cand.tobytes()
        raw += bytes(-len(raw) % BLOB_ALIGN)
        return np.frombuffer(raw, np.uint8)

    def cells(self, re, im):
        """The cell of each float32 sample as the kernel computes it, -1
        outside the box (or not finite)."""
        re = torch.as_tensor(re, dtype=torch.float32)
        im = torch.as_tensor(im, dtype=torch.float32)
        if self.g == 0:
            return torch.full(re.shape, -1, dtype=torch.int64,
                              device=re.device)
        fx = (re - float(self.x0)) * float(self.inv_cell)
        fy = (im - float(self.y0)) * float(self.inv_cell)
        inside = (fx >= 0) & (fx < self.g) & (fy >= 0) & (fy < self.g)
        cell = (torch.where(inside, fx, 0).to(torch.int64) * self.g
                + torch.where(inside, fy, 0).to(torch.int64))
        return torch.where(inside, cell, -1)


def _rounding_margin(c, reach):
    """Twice the bound on the float32 score error of one point, at points
    within ``reach`` of the origin, for any score the kernel or the plain
    version forms. Each forms |c|^2 as re*re + im*im rounded three times,
    an error <= 2.01 u |c|^2 (u = 2^-24); the cross term re*xr + im*xi,
    however it is fused, <= 2.01 u |c||x| (|re xr| + |im xi| <= |c||x|);
    and |c|^2 - 2 cross once more, <= u (|c|^2 + 2|c||x|)(1 + 3u). So one
    score lies within E = 4u (|c|^2 + 2|c||x|) of the exact |x - c|^2 -
    |x|^2, and two scores compare right whenever their exact values differ
    by more than 2E; the margin doubles that for slack."""
    rc = float(np.max(np.abs(c)))
    return 4.0 * 4.0 * U32 * (rc * rc + 2.0 * rc * reach)


def _lists(pts, g, x0, y0, cell):
    """Per cell the mask of the points that can be nearest in it: c stays
    iff dmin(cell, c)^2 <= min_c' dmax(cell, c')^2 + margin, over the cell
    widened by CELL_WIDEN of its side."""
    edge = x0 + cell * np.arange(g + 1)
    lo_x, hi_x = edge[:-1] - CELL_WIDEN * cell, edge[1:] + CELL_WIDEN * cell
    edge = y0 + cell * np.arange(g + 1)
    lo_y, hi_y = edge[:-1] - CELL_WIDEN * cell, edge[1:] + CELL_WIDEN * cell
    cr, ci = pts.real[None, :], pts.imag[None, :]

    def near_far(lo, hi, c):
        near = np.maximum(0.0, np.maximum(lo[:, None] - c, c - hi[:, None]))
        far = np.maximum(np.abs(c - lo[:, None]), np.abs(c - hi[:, None]))
        return near * near, far * far

    nx, fx = near_far(lo_x, hi_x, cr)                       # (g, 256)
    ny, fy = near_far(lo_y, hi_y, ci)
    dmin = nx[:, None, :] + ny[None, :, :]                  # (g, g, 256)
    dmax = fx[:, None, :] + fy[None, :, :]
    reach = float(np.max(np.hypot(np.array([lo_x[0], hi_x[-1]])[:, None],
                                  np.array([lo_y[0], hi_y[-1]])[None, :])))
    thr = dmax.min(axis=-1, keepdims=True) + _rounding_margin(pts, reach)
    return (dmin <= thr).reshape(g * g, NUM_POINTS)


def candidate_grid(re, im):
    """The CandidateGrid of a 256-point table given as float32 numpy planes:
    a square box around the points, BOX_MARGIN of its side wider on each
    side, cut into g x g cells, g = GRID (halved while the lists exceed
    MAX_CANDIDATES entries, 0 when nothing fits or the table is not
    finite)."""
    g = GRID
    re = np.asarray(re, np.float32)
    im = np.asarray(im, np.float32)
    pts = re.astype(np.float64) + 1j * im.astype(np.float64)
    if not np.all(np.isfinite(pts)):
        g = 0
    side = max(float(np.ptp(pts.real)), float(np.ptp(pts.imag)), 1e-30)
    side *= 1.0 + 2.0 * BOX_MARGIN
    cx = 0.5 * (pts.real.max() + pts.real.min()) if g else 0.0
    cy = 0.5 * (pts.imag.max() + pts.imag.min()) if g else 0.0
    while g > 0:
        x0, y0 = np.float32(cx - side / 2), np.float32(cy - side / 2)
        inv_cell = np.float32(g / side)
        keep = _lists(pts, g, float(x0), float(y0), 1.0 / float(inv_cell))
        counts = keep.sum(axis=1)
        if counts.sum() <= MAX_CANDIDATES:
            offsets = np.concatenate([[0], np.cumsum(counts)])
            cand = np.nonzero(keep)[1].astype(np.uint8)   # row-major: ascending
            return CandidateGrid(g, x0, y0, inv_cell, offsets.astype(np.int64),
                                 cand)
        g //= 2
    return CandidateGrid(0, np.float32(0), np.float32(0), np.float32(0),
                         np.zeros(1, np.int64), np.zeros(0, np.uint8))


@functools.lru_cache(maxsize=16)
def _device_grid(re_bytes, im_bytes, device):
    """(CandidateGrid, its blob on ``device``) of a table by content."""
    grid = candidate_grid(np.frombuffer(re_bytes, np.float32),
                          np.frombuffer(im_bytes, np.float32))
    blob = grid.blob
    if blob.size == 0:
        blob = np.zeros(BLOB_ALIGN, np.uint8)
    return grid, torch.from_numpy(blob.copy()).to(device)


_by_tensor = OrderedDict()


def table_grid(constellation):
    """(CandidateGrid, device blob) of a planar table on the card. Built
    once per table content and device; a table tensor seen
    before (same storage, unmodified) is found without a copy to the
    host. The cache holds its tables, so their storage is not reused."""
    re, im = constellation.re, constellation.im
    key = (re.data_ptr(), im.data_ptr(), re._version, im._version,
           str(re.device))
    hit = _by_tensor.get(key)
    if hit is not None:
        _by_tensor.move_to_end(key)
        return hit[0]
    host_re = re.detach().cpu().numpy().astype(np.float32)
    host_im = im.detach().cpu().numpy().astype(np.float32)
    out = _device_grid(host_re.tobytes(), host_im.tobytes(), re.device)
    _by_tensor[key] = (out, re, im)
    while len(_by_tensor) > 16:
        _by_tensor.popitem(last=False)
    return out


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    """The built qpsk256 library, its launch signature declared."""
    lib = load_chain_library("qpsk256")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.qpsk256_launch.argtypes = [p] * 5 + [i, ctypes.c_long, p, i, i, f,
                                             f, f, i, p]
    lib.qpsk256_launch.restype = i
    return lib


BLOCKS_PER_SM = 4         # blocks of a launch at most, per SM


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index):
    """Blocks of the launch at most, striding over the samples."""
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(
        device_index).multi_processor_count


OUT_BYTES = {torch.uint8: 1, torch.int32: 4}


def _plain(x, constellation, out_dtype=torch.int32):
    """The plain version behind the wrapper, in ``out_dtype``."""
    return qpsk256_reference(x, constellation).to(out_dtype)


def _launch(x, constellation, out_dtype=torch.int32):
    dev = x.re.device
    shape = tuple(x.re.shape)
    check_operands("qpsk256", {
        "x.re": (x.re, shape), "x.im": (x.im, shape),
        "constellation.re": (constellation.re, (NUM_POINTS,)),
        "constellation.im": (constellation.im, (NUM_POINTS,))}, dev)
    if out_dtype not in OUT_BYTES:
        raise ValueError(f"qpsk256: out_dtype must be torch.uint8 or "
                         f"torch.int32, got {out_dtype}")
    out = torch.empty(shape, dtype=out_dtype, device=dev)
    n = out.numel()
    if n == 0:
        return out
    cg, blob = table_grid(constellation)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _library().qpsk256_launch(
            x.re.data_ptr(), x.im.data_ptr(), constellation.re.data_ptr(),
            constellation.im.data_ptr(), out.data_ptr(), OUT_BYTES[out_dtype],
            n, blob.data_ptr(), blob.numel(), cg.g, cg.x0, cg.y0,
            cg.inv_cell, _max_blocks(dev.index), stream)
    cuda_error("qpsk256", "qpsk256 kernel launch", err)
    return out


qpsk256_kernel = ChainKernel("qpsk256", _plain, _launch)
