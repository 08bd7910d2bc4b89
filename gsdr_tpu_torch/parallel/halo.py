"""Halo exchange along a time-sharded sample axis, on torch.distributed.

Counterpart of ``gsdr_tpu/parallel/halo.py``. A FIR window that straddles
a shard boundary needs the left neighbour's edge samples; the JAX package
moves them with one ``lax.ppermute``. Here each rank holds only its own
block, and every exchange is one ``all_gather`` of the shards' edges over
the axis's process group, from which each rank takes its neighbour's.
The edges are T-1+D samples at most, so gathering every shard's costs t
times a few KB. The masked psum of the carried tail is one ``all_reduce``.
There is no ``send``/``recv``: gloo does not take CUDA tensors for
point-to-point, while it does take them for ``all_gather`` and
``all_reduce`` (it stages them through the host itself), so ranks that
share one card run these collectives over gloo on their CUDA tensors.

A collective over an axis of one shard is the identity and is not called:
on a world of one, NCCL's self-copy costs host time and moves nothing.

Functions take a tensor or a planar ``ComplexArray`` on the last axis; a
planar one moves as one stacked tensor. Shard 0 (or the last shard) gets
``fill`` if given, else zeros, as JAX's does. Each collective adds the
elements it hands over to ``mesh.sent`` (``utils.compile.tally``: a step
compiled by ``compile_step`` adds them at every replay).
"""

import torch
import torch.distributed as dist

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.utils.compile import tally


def _stacked(x):
    """(one tensor, rebuild) for a tensor or a planar ComplexArray."""
    if isinstance(x, ComplexArray):
        return (torch.stack([x.re, x.im]),
                lambda v: ComplexArray(v[0], v[1]))
    return x.contiguous(), lambda v: v


def all_gather(x, mesh, axis="time"):
    """Every shard's ``x`` along ``axis``, in shard order (a list)."""
    v, rebuild = _stacked(x)
    if mesh.shape[axis] == 1:
        return [x]
    out = [torch.empty_like(v) for _ in range(mesh.shape[axis])]
    dist.all_gather(out, v, group=mesh.get_group(axis))
    tally(mesh.sent, "all_gather", v.numel())
    return [rebuild(o) for o in out]


def all_reduce_sum(x, mesh, axis="time"):
    """The sum of every shard's ``x`` along ``axis``."""
    if mesh.shape[axis] == 1:
        return x
    v, rebuild = _stacked(x)
    v = v.clone()
    dist.all_reduce(v, group=mesh.get_group(axis))
    tally(mesh.sent, "all_reduce", v.numel())
    return rebuild(v)


def _check_halo(x, halo):
    if not 0 < halo <= x.shape[-1]:  # one neighbour's samples at most
        raise ValueError(f"halo {halo} must lie in [1, {x.shape[-1]}], the "
                         "shard's length")


def _cat(a, b):
    if isinstance(a, ComplexArray):
        return ComplexArray(torch.cat([a.re, b.re], -1),
                            torch.cat([a.im, b.im], -1))
    return torch.cat([a, b], -1)


def _zeros_like(x, n):
    shape = tuple(x.shape[:-1]) + (n,)
    if isinstance(x, ComplexArray):
        return ComplexArray.zeros(shape, device=x.device)
    return torch.zeros(shape, dtype=x.dtype, device=x.device)


def gather_edges(x, mesh, width, axis="time"):
    """Every shard's last ``width`` samples along ``axis``, in shard order:
    what ``left_halo`` and the carried tail read, in one collective."""
    _check_halo(x, width)
    n = x.shape[-1]
    return all_gather(x[..., n - width:], mesh, axis)


def left_halo(x, mesh, halo, fill=None, axis="time"):
    """Prepend the left neighbour's LAST ``halo`` samples (last axis).

    Shard 0 gets ``fill`` (shape (..., halo)) if given, else zeros:
    ``fill`` is how a carried streaming tail enters a time-sharded
    pipeline. Returns (..., halo + N_local)."""
    edges = gather_edges(x, mesh, halo, axis)
    s = mesh.coords[axis]
    if s > 0:
        return _cat(edges[s - 1], x)
    return _cat(_zeros_like(x, halo) if fill is None else fill, x)


def right_halo(x, mesh, halo, fill=None, axis="time"):
    """Append the right neighbour's FIRST ``halo`` samples. The last shard
    gets ``fill`` or zeros. Returns (..., N_local + halo)."""
    _check_halo(x, halo)
    heads = all_gather(x[..., :halo], mesh, axis)
    s = mesh.coords[axis]
    if s < mesh.shape[axis] - 1:
        return _cat(x, heads[s + 1])
    return _cat(x, _zeros_like(x, halo) if fill is None else fill)


def last_shard_tail(x, mesh, halo, axis="time"):
    """The global stream's final ``halo`` samples, replicated to every
    shard: every shard but the last contributes zeros to one sum, as JAX's
    masked psum does."""
    _check_halo(x, halo)
    tail = x[..., x.shape[-1] - halo:]
    if mesh.coords[axis] != mesh.shape[axis] - 1:
        tail = _zeros_like(tail, halo)
    return all_reduce_sum(tail, mesh, axis)
