"""Carry a JAX ``FmChannelizer`` configuration and its streaming state
across to the port, through plain Python scalars and numpy arrays.

Nothing here imports JAX: the caller hands over
``dataclasses.asdict(jax_model)`` and numpy copies of the state leaves.
"""

import numpy as np
import torch

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.pipelines.fm_radio import FmChannelizer

_IMPL_MAP = {"auto": "auto", "xla": "torch", "pallas": "cuda"}


def fm_channelizer_from_fields(fields, device="cuda"):
    """The port's FmChannelizer from the fields of a JAX FmChannelizer.

    impl maps 'xla' -> 'torch' and 'pallas' -> 'cuda'; the PFB impls raise
    until the PFB front is ported. The JAX default grade 'bf16x3' has no
    port yet, so it carries over as the port's default 'f32'; 'bf16x2'
    raises.
    """
    fields = dict(fields)
    impl = fields.pop("impl", "auto")
    if impl not in _IMPL_MAP:
        raise NotImplementedError(
            f"impl={impl!r} has no counterpart in the port yet")
    precision = fields.pop("precision", "f32")
    if precision == "bf16x3":
        precision = "f32"
    return FmChannelizer(**fields, impl=_IMPL_MAP[impl], precision=precision,
                         device=device)


def _leaf_to_torch(leaf, device):
    # copies: arrays handed over from JAX are read-only views
    if isinstance(leaf, (tuple, list)):
        re, im = leaf
        return ComplexArray(
            torch.tensor(np.asarray(re), dtype=torch.float32, device=device),
            torch.tensor(np.asarray(im), dtype=torch.float32, device=device))
    return torch.tensor(np.asarray(leaf), dtype=torch.float32, device=device)


def state_from_numpy(state_np, device):
    """Four-leaf numpy state -> torch state. A leaf is either a (re, im)
    pair of arrays (planar) or a plain array."""
    n0, tail, disc, zi = state_np
    return (
        torch.tensor(int(np.asarray(n0)), dtype=torch.int32, device=device),
        _leaf_to_torch(tail, device),
        _leaf_to_torch(disc, device),
        _leaf_to_torch(zi, device),
    )


def state_to_numpy(state):
    """Torch state -> (n0, (re, im), (re, im), zi) numpy leaves."""
    n0, tail, disc, zi = state

    def planar(x):
        return (x.re.detach().cpu().numpy(), x.im.detach().cpu().numpy())

    return (np.asarray(n0.detach().cpu().numpy(), np.int32), planar(tail),
            planar(disc), zi.detach().cpu().numpy())
