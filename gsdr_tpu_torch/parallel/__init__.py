"""Distributed layer: meshes, halo exchange, sharded pipelines, on
torch.distributed.

Counterpart of ``gsdr_tpu/parallel``, in PyTorch's SPMD idiom: one
process per shard, each rank holding its own tensors and calling each
sharded function with its own shard. Signals scale over a mesh with two
axes:

  * ``channel``: independent streams, sharded with no communication;
  * ``time``: the sample axis, split into contiguous blocks, one a rank;
    the FIR windows' (T-1)-sample and the discriminator's overlaps become
    halos gathered from the time neighbours (``halo.py``). Oscillator
    phase needs no communication: every rank rotates its outputs at their
    global sample indices.

IIR state is the one sequential dependency: ``iir.py`` carries it across
time shards exactly with one all_gather of per-shard states and powers of
the state-transition matrix from the host (``make_sharded_iir_step`` makes
it a streaming step). The sharded steps compile over NCCL
(``utils.compile.compile_step``, the port's ``jax.jit``); under gloo they
run eagerly. ``multihost.initialize`` brings
up the process group (NCCL, one card a rank, by default; gloo for ranks
that share a card or run on the CPU).
"""

from gsdr_tpu_torch.parallel.mesh import make_mesh
from gsdr_tpu_torch.parallel.halo import left_halo, right_halo
from gsdr_tpu_torch.parallel.iir import make_sharded_iir_step, sharded_iir
from gsdr_tpu_torch.parallel.channelizer import (
    sharded_fir,
    make_sharded_fm_step,
    make_sharded_am_step,
)
from gsdr_tpu_torch.parallel.modem import (
    make_sharded_qpsk_modem,
    make_sharded_qpsk256_modem,
)
from gsdr_tpu_torch.parallel.multihost import initialize, make_pod_mesh

__all__ = [
    "make_mesh",
    "left_halo",
    "right_halo",
    "sharded_iir",
    "make_sharded_iir_step",
    "sharded_fir",
    "make_sharded_fm_step",
    "make_sharded_am_step",
    "make_sharded_qpsk_modem",
    "make_sharded_qpsk256_modem",
    "initialize",
    "make_pod_mesh",
]
