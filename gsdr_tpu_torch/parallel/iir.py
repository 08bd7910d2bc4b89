"""Exact IIR filtering across a time-sharded sample axis.

Counterpart of ``gsdr_tpu/parallel/iir.py``: the blocked-scan
decomposition of ``ops/iir.py`` one level up.

  1. Every time shard runs ``iir_block`` on its own block, shard 0 from
     the stream's state zi and every other shard from zero state. On the
     card a 1-D block takes kernel B5 (``iir_block``'s 'auto' route);
     batched rows take the plain scan. Each shard ends at a state e_s
     (shard 0's includes zi).
  2. One all_gather over the time axis moves the t states (t x m floats).
  3. Shard s starts at  z_s = sum_{k<s} M^{L(s-1-k)} e_k  and the stream
     ends at  zf = sum_{k<t} M^{L(t-1-k)} e_k,  from powers of the
     state-transition matrix computed in float64 on the host, as JAX's
     ``_host_state_space`` and ``_host_powers`` do, and cast to float32.
  4. Shard s > 0 adds its start state's response: y = y0 + z_s K^T,
     K[t] = e0^T M^t (linearity makes this exact).

JAX's shards all start from zero state and add M^{Ls} zi; starting shard
0 from zi is the same sum, one term earlier, and leaves a one-shard axis
with nothing to correct.

``make_sharded_iir_step`` wraps it as a streaming step, (zi, x) -> (zf,
y), which ``utils.compile.compile_step`` captures over NCCL as JAX jits
it: the host powers are built on the step's first call (the capture's
warm-up), and nothing in the step reads a value back to the host.
"""

import functools

import numpy as np
import torch

from gsdr_tpu_torch.ops.iir import iir_block
from gsdr_tpu_torch.parallel.halo import all_gather
from gsdr_tpu_torch.utils.precision import full_f32


def _host_state_space(b, a):
    """numpy float64 M of the transposed DF-II recurrence, as
    ``ops.iir._state_space`` builds it."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    a = a / a[0]
    m = b.shape[0] - 1
    M = np.zeros((m, m))
    M[:, 0] = -a[1:]
    for i in range(m - 1):
        M[i, i + 1] = 1.0
    return M


def _host_powers(M, L):
    """K (L, m) with K[t] = e0^T M^t, and M^L, in float64 on the host; K
    by doubling (rows [h, 2h) are rows [0, h) times M^h)."""
    m = M.shape[0]
    K = np.zeros((L, m))
    K[0, 0] = 1.0
    h, Mh = 1, M.copy()
    while h < L:
        n = min(h, L - h)
        K[h:h + n] = K[:n] @ Mh
        h, Mh = h + n, Mh @ Mh
    return K, np.linalg.matrix_power(M, L)


@functools.lru_cache(maxsize=16)
def _corrections(b, a, L, t, device):
    """(P, K) on ``device`` in float32: P[j] = M^{Lj} for j = 0..t and K
    (L, m), for host coefficients b, a (tuples) and shards of L samples."""
    M = _host_state_space(b, a)
    K, M_L = _host_powers(M, L)
    P = np.stack([np.linalg.matrix_power(M_L, j) for j in range(t + 1)])
    return (torch.as_tensor(P, dtype=torch.float32, device=device),
            torch.as_tensor(K, dtype=torch.float32, device=device))


def _host_coeffs(c):
    return tuple(float(v) for v in np.asarray(c, np.float64).reshape(-1))


def sharded_iir(b, a, x_local, zi, mesh, axis="time", block_len=128):
    """Exact IIR over a time-sharded last axis; every rank of the axis
    calls it with its own block.

    Args:
      b, a: host coefficient sequences (floats), scipy convention.
      x_local: real (..., L) tensor, this rank's contiguous time block.
      zi: (..., m) state at the stream's start, the same on every rank of
        the axis (only shard 0 reads it), or None for zero state.
      mesh: the rank's ``Mesh``; ``axis`` is its time axis.
      block_len: the plain scan's block length (speed only).

    Returns:
      (y_local (..., L), zf (..., m), the stream's final state, the same
      on every rank) - the state for the next streaming step.
    """
    b, a = _host_coeffs(b), _host_coeffs(a)
    t, s = mesh.shape[axis], mesh.coords[axis]
    y, e = iir_block(b, a, x_local, zi=zi if s == 0 else None,
                     block_len=block_len)
    if t == 1:
        return y, e
    states = all_gather(e, mesh, axis)
    P, K = _corrections(b, a, x_local.shape[-1], t, x_local.device)
    with full_f32():
        zf = sum(states[k] @ P[t - 1 - k].T for k in range(t))
        if s > 0:
            z = sum(states[k] @ P[s - 1 - k].T for k in range(s))
            y = y + z @ K.T
    return y, zf


class ShardedIirStep:
    """``sharded_iir`` as a streaming step for this rank: ``step(zi, x)``
    -> (zf, y), the filter's state carried, the same on every rank of the
    axis; ``init(shape)`` is the zero state for signals of leading shape
    ``shape``. ``mesh`` is the rank's mesh (``compile_step`` reads its
    backend)."""

    def __init__(self, b, a, mesh, axis="time", block_len=128):
        self.b, self.a = _host_coeffs(b), _host_coeffs(a)
        self.mesh, self.axis, self.block_len = mesh, axis, block_len

    def init(self, shape=()):
        order = max(len(self.b), len(self.a)) - 1
        return torch.zeros(tuple(shape) + (order,), dtype=torch.float32,
                           device=self.mesh.device)

    def __call__(self, zi, x):
        y, zf = sharded_iir(self.b, self.a, x, zi, self.mesh, self.axis,
                            self.block_len)
        return zf, y


def make_sharded_iir_step(b, a, mesh, axis="time", block_len=128):
    """``sharded_iir(b, a, x, zi, mesh)`` as a step ``(zi, x) -> (zf, y)``
    over the rank's time block (``ShardedIirStep``)."""
    return ShardedIirStep(b, a, mesh, axis, block_len)
