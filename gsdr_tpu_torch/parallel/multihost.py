"""Process-group bring-up and the host-aligned mesh.

Counterpart of ``gsdr_tpu/parallel/multihost.py``. JAX's
``jax.distributed.initialize`` discovers a TPU pod; here the caller names
the process group's transport:

  * NCCL (the default): one card a rank, the card of the rank's
    LOCAL_RANK. More local ranks than cards raise here, before NCCL's own
    error.
  * gloo: ranks that share a card, or run on the CPU. gloo takes the
    collectives of ``halo.py`` on CUDA tensors.

Nothing chooses a transport or the CPU on its own. The mesh keeps JAX's
host-major layout: hosts on the channel axis, which needs no
communication, and each host's ranks on the time axis, which gathers
halos every block.
"""

import os

import torch
import torch.distributed as dist

from gsdr_tpu_torch.parallel.mesh import make_mesh

BACKENDS = ("nccl", "gloo")


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend="nccl"):
    """``torch.distributed.init_process_group`` for this process.

    With ``coordinator_address`` ('host:port') the group rendezvouses at
    tcp://host:port and ``num_processes`` and ``process_id`` are required;
    without it, at env:// (torchrun sets MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK). ``backend`` is 'nccl' (one card a local rank:
    the card LOCAL_RANK, default 0, out of LOCAL_WORLD_SIZE local ranks,
    default 1) or 'gloo'."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend='nccl' needs CUDA; ranks on the CPU "
                               "pass backend='gloo'")
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        cards = torch.cuda.device_count()
        if local_world > cards or local_rank >= cards:
            raise RuntimeError(
                f"backend='nccl' runs one card a rank: {local_world} local "
                f"ranks (this one {local_rank}) on {cards} card(s); ranks "
                "that share a card pass backend='gloo'")
        torch.cuda.set_device(local_rank)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("with a coordinator_address, pass num_processes "
                             "and process_id")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id))
    else:
        dist.init_process_group(
            backend, init_method="env://",
            world_size=-1 if num_processes is None else int(num_processes),
            rank=-1 if process_id is None else int(process_id))


def make_pod_mesh(channel_per_host=None, device="cuda"):
    """('channel', 'time') mesh with host boundaries on the channel axis.

    With H hosts of L local ranks each (L from LOCAL_WORLD_SIZE, else the
    whole world on one host): channel = H * c, time = L / c
    (c = channel_per_host, default 1). Ranks are numbered host-major (as
    torchrun numbers them), so each channel row lies on one host and the
    time axis's halo gathers never cross hosts. ``device`` as
    ``make_mesh``'s."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local < 1 or world % local:
        raise ValueError(f"world size {world} is not a whole number of "
                         f"hosts of {local} ranks")
    c = int(channel_per_host or 1)
    if local % c:
        raise ValueError(f"channel_per_host {c} must divide {local}")
    return make_mesh(channel=(world // local) * c, time=local // c,
                     device=device)
