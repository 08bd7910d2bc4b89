"""The ('channel', 'time') mesh on torch.distributed.

Counterpart of ``gsdr_tpu/parallel/mesh.py``. A JAX mesh names devices and
one program sees every shard; the port runs one process per shard
(PyTorch's SPMD idiom), so a mesh here is this rank's view of the layout:
its shape, this rank's coordinates, the process group of each axis and
the device its tensors live on. Rank r sits at
(channel, time) = divmod(r, time), row-major, as ``np.reshape`` lays out
JAX's devices.

The axis groups are made with ``torch.distributed.new_group``, every rank
making every group in the same order (the call is collective); an axis of
one shard has none.
``DeviceMesh`` is not used: it sets each process's CUDA device from
LOCAL_RANK, which ranks that share one card cannot take.

A 1x1 mesh with no process group initialized is trivial: its collectives
are identities, as a one-device JAX mesh works in one process.
"""

import torch
import torch.distributed as dist

AXES = ("channel", "time")


class Mesh:
    """This rank's view of a ('channel', 'time') mesh.

    ``shape`` maps each axis to its size; ``coords`` maps it to this
    rank's index along it; ``get_group(axis)`` is the axis's process
    group, None for an axis of one shard (its collectives are
    identities); ``device`` holds the rank's tensors; ``backend`` is the
    process group's ('nccl', 'gloo'), None on the trivial mesh. ``sent``
    counts the elements this rank has handed to collectives, by
    collective (``halo.py`` adds to it).
    """

    axis_names = AXES

    def __init__(self, channel, time, rank, groups, device, backend):
        self.shape = {"channel": channel, "time": time}
        self.rank = rank
        self.coords = {"channel": rank // time, "time": rank % time}
        self._groups = groups
        self.device = device
        self.backend = backend
        self.sent = {"all_gather": 0, "all_reduce": 0}

    def get_group(self, axis):
        if axis not in AXES:
            raise ValueError(f"mesh axes are {AXES}, got {axis!r}")
        return self._groups[axis]

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")


def _device(device):
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: device 'cuda' requested but CUDA is not "
                "available; pass device='cpu' (with the gloo backend)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(channel=1, time=1, device="cuda"):
    """This rank's ('channel', 'time') mesh over the default process group.

    ``channel * time`` must equal the world size of the initialized
    process group (``multihost.initialize``); with no process group, only
    the trivial 1x1 mesh. Channel sharding is communication-free (prefer
    it across hosts); time sharding gathers halos every block (keep it on
    one host's links). ``device`` is where the rank's tensors live,
    'cuda' (this process's current card) by default; an NCCL group takes
    only CUDA tensors.
    """
    c, t = int(channel), int(time)
    if c < 1 or t < 1:
        raise ValueError(f"mesh axes must be >= 1, got channel={c}, time={t}")
    device = _device(device)
    if not dist.is_initialized():
        if c * t != 1:
            raise ValueError(
                f"channel*time = {c * t} needs an initialized process group "
                "of that many ranks (gsdr_tpu_torch.parallel.initialize)")
        return Mesh(1, 1, 0, {"channel": None, "time": None}, device,
                    None)
    world = dist.get_world_size()
    if c * t != world:
        raise ValueError(f"channel*time = {c * t} != world size {world}")
    backend = dist.get_backend()
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL process group takes only CUDA tensors; "
                         f"got device {device}")
    rank = dist.get_rank()
    rows = [[ci * t + ti for ti in range(t)] for ci in range(c)]
    cols = [[ci * t + ti for ci in range(c)] for ti in range(t)]
    groups = {"channel": None, "time": None}
    for axis, members in (("time", rows), ("channel", cols)):
        if len(members[0]) == 1:
            continue  # an axis of one shard exchanges nothing
        for ranks in members:
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return Mesh(c, t, rank, groups, device, backend)
