"""IIR filtering as an exact blocked parallel scan, with the
pole-diagonalized kernel B5 for 1-D signals on the card.

Counterpart of ``gsdr_tpu/ops/iir.py``, its routing included (the Pallas
route there is kernel B5 here, ``kernels/iir.py``). scipy-style Direct
Form semantics with a[0] = 1,

    y[n] = sum_i b[i] x[n-i] - sum_{i>=1} a[i] y[n-i],

evaluated through the transposed Direct Form II state z in R^m:

    y[n] = b0 x[n] + z[n-1][0]
    z[n] = M z[n-1] + c x[n]

with M[i,0] = -a[i+1], M[i,i+1] = 1 and c[i] = b[i+1] - a[i+1] b0. The
recurrence is linear, so it block-decomposes exactly:

  1. zero-state pass: every block of L samples runs from z = 0, all blocks
     at once (one length-L loop over (batch, B, m) states);
  2. cross-block combine: true block-start states follow the affine
     recurrence Z[b+1] = M^L Z[b] + d[b], composed by an inclusive
     Hillis-Steele scan in log2(B) steps;
  3. correction: the start-state contribution to in-block outputs is
     Z_start @ K^T with K[t] = e0^T M^t, one matmul.

``block_len`` only changes speed; results are exact for any value. For
high orders prefer ``iir_sos`` (cascaded biquads).
"""

import numpy as np
import torch

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.kernels.iir import iir_filter, iir_kernel
from gsdr_tpu_torch.utils.precision import full_f32

_MIN_COEFFS = 2
_MAX_COEFFS = 32


def _normalize_coeffs(b, a, dtype, device):
    b = torch.as_tensor(b, device=device).to(dtype)
    a = torch.as_tensor(a, device=device).to(dtype)
    if b.ndim != 1 or a.ndim != 1 or b.shape[0] != a.shape[0]:
        raise ValueError("b and a must be 1-D with equal length")
    nc = b.shape[0]
    if not (_MIN_COEFFS <= nc <= _MAX_COEFFS):
        raise ValueError(
            f"coeff count must be in [{_MIN_COEFFS}, {_MAX_COEFFS}], got {nc}")
    return b / a[0], a / a[0]


def _state_space(b, a):
    """(M, c, b0) for the transposed DF-II recurrence above."""
    m = b.shape[0] - 1
    b0 = b[0]
    M = torch.diag(torch.ones(m - 1, dtype=b.dtype, device=b.device), 1)
    M[:, 0] = M[:, 0] - a[1:]
    c = b[1:] - a[1:] * b0
    return M, c, b0


def _powers(M, L):
    """K (L, m) with K[t] = e0^T M^t, and M^L (m, m)."""
    m = M.shape[0]
    row = torch.zeros(m, dtype=M.dtype, device=M.device)
    row[0] = 1
    P = torch.eye(m, dtype=M.dtype, device=M.device)
    rows = []
    for _ in range(L):
        rows.append(row)
        row, P = row @ M, P @ M
    return torch.stack(rows), P


def _iir_batched(b, a, x, zi, block_len):
    """Blocked scan of x (R, n) from states zi (R, m) -> (y (R, n), zf)."""
    M, c, b0 = _state_space(b, a)
    m = M.shape[0]
    r_rows, n = x.shape
    L = min(block_len, max(n, 1))
    B = -(-n // L)
    pad = B * L - n
    xb = torch.nn.functional.pad(x, (0, pad)).reshape(r_rows, B, L)

    # 1) zero-state pass over all blocks at once. The last block holds only
    # `rem` real samples, so its zero-state state after `rem` steps is kept
    # for the exact final state.
    MT = M.T
    rem = n - (B - 1) * L
    z = torch.zeros((r_rows, B, m), dtype=x.dtype, device=x.device)
    z_rem = None
    ys = []
    for t in range(L):
        x_t = xb[:, :, t]
        ys.append(b0 * x_t + z[..., 0])
        z = z @ MT + x_t[..., None] * c
        if t == rem - 1:
            z_rem = z[:, -1]
    y_zs = torch.stack(ys, dim=-1)  # (R, B, L)

    # 2) cross-block affine combine, inclusive scan of Z -> M^L Z + d[b].
    K, M_L = _powers(M, L)
    e_a = M_L.expand(B, m, m).clone()
    e_u = z
    s = 1
    while s < B:
        # combine(left=k-s, right=k) = (A_k A_{k-s}, A_k u_{k-s} + u_k)
        new_a = e_a.clone()
        new_u = e_u.clone()
        new_a[s:] = e_a[s:] @ e_a[:-s]
        new_u[:, s:] = (e_a[s:] @ e_u[:, :-s, :, None])[..., 0] + e_u[:, s:]
        e_a, e_u = new_a, new_u
        s *= 2
    tail = e_u[:, :-1] + (e_a[:-1] @ zi[:, None, :, None])[..., 0]
    z_start = torch.cat([zi[:, None, :], tail], dim=1)  # (R, B, m)
    m_rem = torch.linalg.matrix_power(M, rem)
    z_final = (m_rem @ z_start[:, -1, :, None])[..., 0] + z_rem

    # 3) start-state correction: one matmul.
    y = y_zs + z_start @ K.T
    return y.reshape(r_rows, -1)[:, :n], z_final


def _concrete(c):
    """Host coefficients: a Python sequence, a numpy array or a CPU tensor
    (the port's counterpart of JAX's "not a tracer")."""
    return not isinstance(c, torch.Tensor) or c.device.type == "cpu"


def _kernel_filter(b, a, x, impl):
    """The IirFilter of kernel B5 when it takes this call, else None.

    'auto' takes B5 for a 1-D float32 signal (a planar 1-D signal counts)
    on the card with concrete coefficients of a filter the kernel takes;
    'cuda' requires all of that and raises otherwise; 'torch' never takes
    it."""
    if impl == "torch":
        return None
    on_card = x.device.type == "cuda"
    one_d = x.ndim == 1
    concrete = _concrete(b) and _concrete(a)
    filt = iir_filter(b, a, x.device) if concrete and on_card else None
    if impl == "auto":
        if one_d and filt is not None and (
                isinstance(x, ComplexArray) or x.dtype == torch.float32):
            return filt
        return None
    if not on_card:
        raise ValueError("impl='cuda' runs the IIR kernel: it needs a CUDA "
                         f"tensor, got one on {x.device}")
    if not one_d:
        raise ValueError("impl='cuda' takes a 1-D signal; batched signals "
                         "run the plain blocked scan")
    if not concrete:
        raise ValueError("impl='cuda' needs host coefficients (a sequence, "
                         "a numpy array or a CPU tensor)")
    if filt is None:
        raise ValueError("impl='cuda': the IIR kernel takes order 1..8 with "
                         "distinct poles; use impl='torch' for this filter")
    return filt


def _contiguous(x):
    if isinstance(x, ComplexArray):
        return ComplexArray(x.re.contiguous(), x.im.contiguous())
    return x.contiguous()


def _kernel_state(zi, device, m):
    """The initial state (planar or real) as contiguous float32 (m,) on
    ``device``, not copied where it is that already."""
    if isinstance(zi, ComplexArray):
        return ComplexArray(_kernel_state(zi.re, device, m),
                            _kernel_state(zi.im, device, m))
    return torch.as_tensor(zi, dtype=torch.float32,
                           device=device).reshape(m).contiguous()


def iir_block(b, a, x, zi=None, block_len=128, impl="auto"):
    """IIR filter returning (y, final_state) for streaming continuation.

    ``zi`` / the returned state are transposed-DF-II state vectors of
    length coeff_count - 1, with the leading batch axes of ``x``. A planar
    ComplexArray ``x`` with real coefficients filters its two planes
    independently (exact by linearity).

    ``impl``: 'auto' runs the pole-diagonalized kernel B5
    (``kernels/iir.py``) for a 1-D signal on the card with host
    coefficients of order 1..8 and distinct poles, and the plain blocked
    scan otherwise (batched signals, the CPU, other filters); 'torch'
    forces the plain scan; 'cuda' forces B5 and raises where it cannot run.
    B5 runs the float32-rounded coefficients, as the plain scan does.
    """
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"impl must be 'auto', 'torch' or 'cuda', got {impl!r}")
    if not isinstance(x, ComplexArray):
        x = torch.as_tensor(x)
    filt = _kernel_filter(b, a, x, impl)
    if filt is not None:
        zk = None if zi is None else _kernel_state(zi, x.device, filt.diag.m)
        return iir_kernel(_contiguous(x), filt, zk)
    return _iir_block_plain(b, a, x, zi, block_len)


def _iir_block_plain(b, a, x, zi, block_len):
    """The exact blocked scan (module docstring algorithm)."""
    if isinstance(x, ComplexArray):
        xs = torch.stack([x.re, x.im], dim=0)
        zis = None if zi is None else torch.stack([zi.re, zi.im], dim=0)
        y, zf = _iir_block_plain(b, a, xs, zis, block_len)
        return ComplexArray(y[0], y[1]), ComplexArray(zf[0], zf[1])

    x = torch.as_tensor(x)
    dtype = torch.promote_types(x.dtype, torch.float32)
    x = x.to(dtype)
    b, a = _normalize_coeffs(b, a, dtype, x.device)
    m = b.shape[0] - 1
    batch_shape = tuple(x.shape[:-1])
    xb = x.reshape(-1, x.shape[-1])
    if zi is None:
        zi_b = torch.zeros((xb.shape[0], m), dtype=dtype, device=x.device)
    else:
        zi_b = torch.as_tensor(zi, device=x.device).to(dtype).reshape(-1, m)
    with full_f32():
        y, zf = _iir_batched(b, a, xb, zi_b, block_len)
    return y.reshape(batch_shape + (x.shape[-1],)), zf.reshape(batch_shape + (m,))


def iir(b, a, x, zi=None, block_len=128, impl="auto"):
    """Exact IIR filter along the last axis (``impl`` as in iir_block)."""
    y, _ = iir_block(b, a, x, zi=zi, block_len=block_len, impl=impl)
    return y


def iir_reference(b, a, x, zi=None):
    """Sequential golden implementation, one sample at a time; validates
    the blocked scan. ``zi`` broadcasts against the batch axes of ``x``."""
    x = torch.as_tensor(x)
    dtype = torch.promote_types(x.dtype, torch.float32)
    x = x.to(dtype)
    b, a = _normalize_coeffs(b, a, dtype, x.device)
    M, c, b0 = _state_space(b, a)
    m = M.shape[0]
    batch_shape = tuple(x.shape[:-1])
    xb = x.reshape(-1, x.shape[-1])
    z = torch.zeros((xb.shape[0], m), dtype=dtype, device=x.device)
    if zi is not None:
        z = z + torch.as_tensor(zi, device=x.device).to(dtype).reshape(-1, m)
    ys = []
    with full_f32():
        for t in range(xb.shape[-1]):
            x_t = xb[:, t]
            ys.append(b0 * x_t + z[:, 0])
            z = z @ M.T + c * x_t[:, None]
    return torch.stack(ys, dim=-1).reshape(batch_shape + (x.shape[-1],))


def _sos_sections(sos):
    """The (b, a) rows of an (S, 6) [b0 b1 b2 a0 a1 a2] cascade: float32
    numpy rows for host coefficients (so that each section stays concrete
    for the kernel route), tensor slices for a tensor on the card."""
    if not _concrete(sos):
        return [(sos[s, :3], sos[s, 3:]) for s in range(sos.shape[0])]
    rows = np.asarray(sos, np.float32)
    if rows.ndim != 2 or rows.shape[1] != 6:
        raise ValueError(f"sos must be (S, 6), got shape {rows.shape}")
    return [(rows[s, :3], rows[s, 3:]) for s in range(rows.shape[0])]


def iir_sos_block(sos, x, zi=None, block_len=128, impl="auto"):
    """Cascade of second-order sections returning (y, final_state).

    ``sos`` is (S, 6) scipy-style [b0 b1 b2 a0 a1 a2] rows. ``zi`` / the
    returned state stack the sections' transposed-DF-II states on a
    LEADING axis, shape (S,) + batch + (2,), planar for a planar ``x``.
    Every section goes through ``iir_block`` with ``impl``.
    """
    y = x
    zfs = []
    for s, (b, a) in enumerate(_sos_sections(sos)):
        zi_s = None if zi is None else zi[s]
        y, zf = iir_block(b, a, y, zi=zi_s, block_len=block_len, impl=impl)
        zfs.append(zf)
    if zfs and isinstance(zfs[0], ComplexArray):
        return y, ComplexArray(torch.stack([z.re for z in zfs]),
                               torch.stack([z.im for z in zfs]))
    return y, torch.stack(zfs)


def iir_sos(sos, x, zi=None, block_len=128, impl="auto"):
    """Cascade of second-order sections (numerically robust high-order
    IIR); pass ``zi`` (see iir_sos_block) for streaming continuation."""
    y, _ = iir_sos_block(sos, x, zi=zi, block_len=block_len, impl=impl)
    return y
