"""The pole-diagonalized IIR kernel B5: host side, wrapper and plain
version.

Counterpart of ``gsdr_tpu/kernels/iir_pallas.py``. An exact IIR of order
m in [1, 8] with distinct poles is, with M = Q diag(p) Q^-1, a set of
independent complex first-order scans, one per pole representative (a
conjugate pair collapses to one scan of weight 2):

    s_k[n] = p_k s_k[n-1] + w_k x[n],       s_k[-1] = (Q^-1 zi)_k
    y[n]   = b0 x[n] + sum_k wgt_k Re(q_k s_k[n-1])
    zf     = sum_k wgt_k Re(Qcol_k s_k[N-1])

  - ``diagonalize`` (float64 numpy, the same pairing and separation limit
    as the JAX function) and ``iir_kernel_supported``;
  - ``coef_table``: the float32 table the kernel reads, constants and the
    float64 powers p^(span*j) and p^(tile*e) of the look-back (the layout
    of ``csrc/iir.cu``);
  - ``iir_filter``: the diagonalization and, on the card, the table, built
    once per (normalized b, a, device) and kept on the device;
  - ``iir_kernel``: the wrapper, counted under ``iir``; it launches
    ``csrc/iir.cu`` for CUDA tensors (one grid launch a call: a chained
    scan with a decoupled look-back that reads back no further than
    ``look_back_horizon``, its published states stamped with a call
    counter that the kernel keeps in its per-stream scratch, so the
    scratch is never reset and a call captured in a CUDA graph is a new
    call at every replay) and takes the plain version,
    ``iir_diag_reference``, only for tensors on the CPU.
"""

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.kernels.chain import (
    ChainKernel,
    LookBackScratch,
    check_operands,
    cuda_error,
    load_chain_library,
)

MAX_PAIRS = 4          # order <= 8
POLE_SEP_TOL = 1e-6    # poles closer than this go to the plain scan
MAX_ORDER = 2 * MAX_PAIRS

# coef layout of csrc/iir.cu, complex values as (re, im) float pairs
_B0 = 0
_POLE = 2
_W = _POLE + 2 * MAX_PAIRS
_Q = _W + 2 * MAX_PAIRS
_QCOL = _Q + 2 * MAX_PAIRS
_QINV = _QCOL + 2 * MAX_PAIRS * MAX_ORDER
_POW = _QINV + 2 * MAX_PAIRS * MAX_ORDER


def _look_pow(threads):
    """Offset of the look-back powers, after the thread powers."""
    return _POW + 2 * MAX_PAIRS * (threads + 1)


class Diag:
    """Host-side pole decomposition of a (b, a) filter (float64)."""

    __slots__ = ("b0", "poles", "w", "q", "wgt", "qcols", "qinv_rows", "m")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def diagonalize(b, a):
    """(b, a) -> Diag with one entry per pole-pair representative, or None
    when the filter cannot run on the kernel (repeated poles, a defective
    M, or order outside [1, 8])."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    b = b / a[0]
    a = a / a[0]
    m = len(b) - 1
    if not (1 <= m <= MAX_ORDER):
        return None
    # transposed-DF-II state matrix and input vector (ops/iir.py layout)
    M = np.zeros((m, m))
    M[:, 0] = -a[1:]
    for i in range(m - 1):
        M[i, i + 1] = 1.0
    c = b[1:] - a[1:] * b[0]
    vals, vecs = np.linalg.eig(M)
    if m > 1:
        sep = min(abs(vals[i] - vals[j])
                  for i in range(m) for j in range(i + 1, m))
        if sep < POLE_SEP_TOL:
            return None
    try:
        qinv = np.linalg.inv(vecs)
    except np.linalg.LinAlgError:
        return None
    w_full = qinv @ c.astype(np.complex128)
    q_full = vecs[0, :]
    # one representative per conjugate pair (imag > 0), weight 2 for true
    # pairs, 1 for real poles
    sel, wgt = [], []
    used = np.zeros(m, bool)
    for i in range(m):
        if used[i]:
            continue
        p = vals[i]
        if abs(p.imag) < 1e-12:
            sel.append(i)
            wgt.append(1.0)
            used[i] = True
        else:
            if p.imag < 0:
                continue  # its conjugate partner is the representative
            j = int(np.argmin(np.abs(vals - np.conj(p)) + used * 1e9))
            sel.append(i)
            wgt.append(2.0)
            used[i] = used[j] = True
    if len(sel) > MAX_PAIRS:
        return None
    return Diag(
        b0=float(b[0]),
        poles=[complex(vals[i]) for i in sel],
        w=[complex(w_full[i]) for i in sel],
        q=[complex(q_full[i]) for i in sel],
        wgt=[float(g) for g in wgt],
        qcols=[vecs[:, i].copy() for i in sel],
        qinv_rows=[qinv[i, :].copy() for i in sel],
        m=m,
    )


def iir_kernel_supported(b, a):
    """True when host (b, a) can run on the kernel: 1-D, equal length,
    order in [1, 8] with distinct poles."""
    try:
        b = np.asarray(b, np.float64)
        a = np.asarray(a, np.float64)
    except (TypeError, ValueError):
        return False
    if b.ndim != 1 or a.ndim != 1 or b.shape != a.shape:
        return False
    return diagonalize(b, a) is not None


def coef_table(diag, span, threads, window):
    """The float32 table of ``csrc/iir.cu``: b0, and per pole p, w, wgt*q,
    the wgt-weighted Q column, the Q^-1 row, p^(span*j) for j = 0..threads
    and the look-back multipliers p^(span*threads*e) for e = 0..window,
    every value formed in float64 and rounded once."""
    plen = threads + 1
    look = _look_pow(threads)
    t = np.zeros(look + 2 * MAX_PAIRS * (window + 1))
    t[_B0] = diag.b0

    def put(off, z):
        z = np.asarray(z, np.complex128).reshape(-1)
        t[off:off + 2 * z.size:2] = z.real
        t[off + 1:off + 2 * z.size:2] = z.imag

    for k, p in enumerate(diag.poles):
        put(_POLE + 2 * k, p)
        put(_W + 2 * k, diag.w[k])
        put(_Q + 2 * k, diag.wgt[k] * diag.q[k])
        put(_QCOL + 2 * MAX_ORDER * k, diag.wgt[k] * diag.qcols[k])
        put(_QINV + 2 * MAX_ORDER * k, diag.qinv_rows[k])
        put(_POW + 2 * plen * k,
            np.power(np.complex128(p), span * np.arange(plen)))
        put(look + 2 * (window + 1) * k,
            np.power(np.complex128(p), span * threads * np.arange(window + 1)))
    return t.astype(np.float32)


@dataclass(frozen=True, eq=False)
class IirFilter:
    """A diagonalized filter ready for ``iir_kernel`` on one device: its
    Diag and, on the card, the coef table there (None on the CPU)."""

    diag: Diag
    table: object


def _coeff_key(b, a):
    """(b, a) rounded to float32, as the plain scan runs them, normalized
    by a[0] in float64: tuples of Python floats, a cache key that holds
    the values exactly."""
    b = np.asarray(b, np.float32).astype(np.float64)
    a = np.asarray(a, np.float32).astype(np.float64)
    if a.ndim != 1 or b.shape != a.shape or a.size == 0 or a[0] == 0.0:
        return None
    return tuple((b / a[0]).tolist()), tuple((a / a[0]).tolist())


@functools.lru_cache(maxsize=64)
def _diag(b_key, a_key):
    return diagonalize(b_key, a_key)


@functools.lru_cache(maxsize=64)
def _filter(b_key, a_key, device):
    diag = _diag(b_key, a_key)
    table = None
    if device.type == "cuda":
        g = _geometry()
        host = coef_table(diag, g.span, g.threads, g.window)
        if host.size != g.coef_len:
            raise RuntimeError(f"iir coef table of {host.size} floats, the "
                               f"kernel reads {g.coef_len}")
        table = torch.tensor(host, device=device)
    return IirFilter(diag, table)


def iir_filter(b, a, device):
    """The cached IirFilter of host coefficients (b, a) on ``device``, or
    None when the kernel cannot take the filter. The diagonalization runs
    once per (normalized b, a), the table is built once per device."""
    key = _coeff_key(b, a)
    if key is None or _diag(*key) is None:
        return None
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _filter(*key, device)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _pow(p, exps):
    """p ** exps in complex128, rounded to complex64."""
    return torch.from_numpy(np.asarray(
        np.power(np.complex128(p), np.asarray(exps)), np.complex64))


def iir_diag_reference(diag, x, zi=None, block=256):
    """The kernel's formulation in plain torch, for a real 1-D x (N,):
    per pole a complex scan, evaluated blockwise. Inside each block of
    ``block`` samples the zero-state scan is a product with the
    lower-triangular (block, block) matrix of powers p^(t-j); the block
    end states are then chained from s0 = Q^-1 zi with the multiplier
    p^block by a Hillis-Steele scan whose multipliers p^(block*d) are
    float64 powers; every output adds p^t times its block's start state.
    Returns (y (N,), zf (m,)) in float32."""
    x = torch.as_tensor(x, dtype=torch.float32)
    n = x.shape[-1]
    dev = x.device
    nb = max(1, -(-n // block))
    xb = torch.nn.functional.pad(x, (0, nb * block - n)).reshape(nb, block)
    xc = xb.to(torch.complex64)
    zi64 = np.zeros(diag.m) if zi is None else \
        torch.as_tensor(zi).detach().cpu().double().numpy().reshape(diag.m)
    y = diag.b0 * xb
    zf = np.zeros(diag.m)
    t = np.arange(block)
    lag = t[:, None] - t[None, :]
    last_b, last_t = divmod(n - 1, block)
    for k, p in enumerate(diag.poles):
        pw = np.power(np.complex128(p), np.maximum(lag, 0)) * (lag >= 0)
        toe = torch.from_numpy(pw.astype(np.complex64)).to(dev)
        s_zs = (diag.w[k] * xc) @ toe.T                 # (nb, block)
        s0 = complex(diag.qinv_rows[k] @ zi64)
        # E[b] = p^block E[b-1] + s_zs[b, -1] from E[-1] = s0
        ends = s_zs[:, -1].clone()
        ends[0] += complex(np.complex128(p) ** block * s0)
        d = 1
        while d < nb:
            ends[d:] = ends[d:] + _pow(p, block * d).to(dev) * ends[:-d]
            d *= 2
        starts = torch.cat([torch.tensor([s0], dtype=torch.complex64,
                                         device=dev), ends[:-1]])
        shifted = torch.nn.functional.pad(s_zs[:, :-1], (1, 0))
        s_prev = shifted + _pow(p, t).to(dev)[None, :] * starts[:, None]
        y = y + diag.wgt[k] * (diag.q[k] * s_prev).real
        s_end = complex(s_zs[last_b, last_t]) \
            + complex(np.complex128(p) ** (last_t + 1)) \
            * complex(starts[last_b])
        zf += diag.wgt[k] * (diag.qcols[k] * s_end).real
    return (y.reshape(-1)[:n].contiguous(),
            torch.tensor(zf, dtype=torch.float32, device=dev))


def _plain(x, filt, zi):
    """The plain version behind the wrapper: iir_diag_reference per row."""
    if isinstance(x, ComplexArray):
        yr, zr = iir_diag_reference(filt.diag, x.re,
                                    None if zi is None else zi.re)
        yi, zim = iir_diag_reference(filt.diag, x.im,
                                     None if zi is None else zi.im)
        return ComplexArray(yr, yi), ComplexArray(zr, zim)
    return iir_diag_reference(filt.diag, x, zi)


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    """The built iir library, its signatures declared."""
    lib = load_chain_library("iir")
    p, pp, i = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int
    lng = ctypes.c_long
    lib.iir_launch.argtypes = [i, pp, pp, pp, pp, p, i, i, lng, lng, p,
                               lng, p]
    lib.iir_launch.restype = i
    lib.iir_geometry.argtypes = [ctypes.POINTER(i)] * 4
    lib.iir_geometry.restype = None
    lib.iir_scratch_bytes.argtypes = [lng]
    lib.iir_scratch_bytes.restype = lng
    return lib


@dataclass(frozen=True)
class Geometry:
    """What ``csrc/iir.cu`` reports of itself (``iir_geometry``): samples
    per thread, threads per tile block, the tiles of one look-back step and
    the table's float count."""

    span: int
    threads: int
    window: int
    coef_len: int

    @property
    def tile(self):
        return self.span * self.threads


@functools.lru_cache(maxsize=None)
def _geometry():
    """The built kernel's Geometry."""
    vals = [ctypes.c_int(0) for _ in range(4)]
    _library().iir_geometry(*(ctypes.byref(v) for v in vals))
    return Geometry(*(v.value for v in vals))


HORIZON_BOUND = 2.0 ** -48    # what a state beyond the look-back weighs
MAX_HORIZON = 1 << 62


@functools.lru_cache(maxsize=256)
def look_back_horizon(radii, tile):
    """The predecessor tiles the look-back reads at most: the least h with
    |p|^(tile h) <= HORIZON_BOUND for every pole radius |p| in ``radii``
    (at least 1; MAX_HORIZON for a pole on or outside the unit circle).
    A tile further back would enter the start state through p^(tile h),
    far under float32's rounding of it (2^-24)."""
    h = 1
    for r in radii:
        if r >= 1.0:
            return MAX_HORIZON
        if r > 0.0:
            h = max(h, math.ceil(math.log(HORIZON_BOUND)
                                 / (tile * math.log(r))))
    return min(h, MAX_HORIZON)


MIN_SLOTS = 8192        # tiles the first scratch of a stream holds
# the look-back's scratch of each (device index, stream) by key
_scratches = LookBackScratch(
    "iir", lambda slots: _library().iir_scratch_bytes(slots), MIN_SLOTS)
_scratch = _scratches.by_stream


def _pointers(ts):
    return (ctypes.c_void_p * len(ts))(
        *(None if t is None else t.data_ptr() for t in ts))


def _launch(x, filt, zi):
    """One grid launch over the rows of x (2 for a planar signal)."""
    planar = isinstance(x, ComplexArray)
    rows = [x.re, x.im] if planar else [x]
    zrows = [None] * len(rows) if zi is None else \
        ([zi.re, zi.im] if planar else [zi])
    dev = rows[0].device
    n = rows[0].shape[-1] if rows[0].ndim == 1 else -1
    if n < 0:
        raise ValueError(f"iir: x must be 1-D, got shape "
                         f"{tuple(rows[0].shape)}")
    m, poles = filt.diag.m, len(filt.diag.poles)
    operands = {f"x[{r}]": (t, (n,)) for r, t in enumerate(rows)}
    operands.update({f"zi[{r}]": (t, (m,)) for r, t in enumerate(zrows)
                     if t is not None})
    check_operands("iir", operands, dev)
    if filt.table is None or filt.table.device != dev:
        raise ValueError(f"iir: the filter's table is not on {dev}")
    ys = [torch.empty(n, dtype=torch.float32, device=dev) for _ in rows]
    zfs = [torch.empty(m, dtype=torch.float32, device=dev) for _ in rows]
    if n == 0:
        zfs = [torch.zeros(m, dtype=torch.float32, device=dev)
               if z is None else z.clone() for z in zrows]
    else:
        tile = _geometry().tile
        slots = len(rows) * -(-n // tile)
        horizon = look_back_horizon(
            tuple(abs(p) for p in filt.diag.poles), tile)
        stream = torch.cuda.current_stream(dev).cuda_stream
        scr = _scratches.get(dev, stream, slots)
        with torch.cuda.device(dev):
            err = _library().iir_launch(
                len(rows), _pointers(rows), _pointers(ys), _pointers(zrows),
                _pointers(zfs), filt.table.data_ptr(), poles, m, n, horizon,
                scr.buf.data_ptr(), scr.slots, stream)
        cuda_error("iir", "iir kernel launch", err)
    if planar:
        return ComplexArray(*ys), ComplexArray(*zfs)
    return ys[0], zfs[0]


iir_kernel = ChainKernel("iir", _plain, _launch)
