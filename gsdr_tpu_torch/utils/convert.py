"""Carry JAX models and streaming states across to the port, through plain
Python scalars and numpy arrays: the receivers ``FmChannelizer`` and
``AmReceiver`` with their states, the modems ``QpskModem`` and
``Qpsk256Modem``, the planar tails of the PFB block streams
(``pfb_channelize_block``, ``pfb_synthesize_block``), and the streaming
layer's stages, chains and chain states (``stream.py``).

Nothing here imports JAX: the caller hands over
``dataclasses.asdict(jax_model)`` and numpy copies of the state leaves.
Taps and constellation tables cross as numpy arrays; there are no learned
weights.
"""

import numpy as np
import torch

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.pipelines.am_radio import AmReceiver
from gsdr_tpu_torch.pipelines.fm_radio import FmChannelizer
from gsdr_tpu_torch.pipelines.qpsk_modem import Qpsk256Modem, QpskModem
from gsdr_tpu_torch.stream import (
    Chain,
    FirStream,
    IirStream,
    MixerStream,
    QuadFmStream,
    SosStream,
)

_IMPL_MAP = {"auto": "auto", "xla": "torch", "pallas": "cuda",
             "pfb": "pfb", "pfb_pallas": "pfb"}


def _port_fields(fields):
    """The JAX model's fields with impl mapped to the port's: 'xla' ->
    'torch', 'pallas' -> 'cuda', and both 'pfb' and 'pfb_pallas' -> 'pfb'
    (the PFB kernel on the card, the plain PFB chain on the CPU). The
    grade (``precision``) carries over as it is."""
    fields = dict(fields)
    impl = fields.pop("impl", "auto")
    if impl not in _IMPL_MAP:
        raise NotImplementedError(
            f"impl={impl!r} has no counterpart in the port yet")
    return dict(fields, impl=_IMPL_MAP[impl])


def fm_channelizer_from_fields(fields, device="cuda"):
    """The port's FmChannelizer from the fields of a JAX FmChannelizer; its
    grade carries over."""
    return FmChannelizer(**_port_fields(fields), device=device)


def am_receiver_from_fields(fields, device="cuda"):
    """The port's AmReceiver from the fields of a JAX AmReceiver; its grade
    carries over."""
    return AmReceiver(**_port_fields(fields), device=device)


def qpsk_modem_from_fields(fields, device="cuda"):
    """The port's QpskModem from the fields of a JAX QpskModem."""
    return QpskModem(**fields, device=device)


def qpsk256_modem_from_fields(fields, device="cuda"):
    """The port's Qpsk256Modem from the fields of a JAX Qpsk256Modem."""
    return Qpsk256Modem(**fields, device=device)


def planar_from_numpy(pair, device):
    """A (re, im) pair of numpy arrays -> a planar float32 tensor pair on
    ``device``: a JAX stream tail, such as the ``new_tail`` of
    ``pfb_channelize_block`` or ``pfb_synthesize_block``, ready to continue
    the stream in the port."""
    re, im = pair
    # copies: arrays handed over from JAX are read-only views
    return ComplexArray(
        torch.tensor(np.asarray(re), dtype=torch.float32, device=device),
        torch.tensor(np.asarray(im), dtype=torch.float32, device=device))


def planar_to_numpy(x):
    """A planar tensor pair -> a (re, im) pair of numpy arrays."""
    return (x.re.detach().cpu().numpy(), x.im.detach().cpu().numpy())


def _leaf_to_torch(leaf, device):
    """A (re, im) pair -> planar; an integer array -> int32 (a mixer's n0);
    a complex array -> complex64; any other array -> float32."""
    if isinstance(leaf, (tuple, list)):
        return planar_from_numpy(leaf, device)
    leaf = np.asarray(leaf)
    if np.issubdtype(leaf.dtype, np.integer):
        dtype = torch.int32
    elif np.iscomplexobj(leaf):
        dtype = torch.complex64
    else:
        dtype = torch.float32
    return torch.tensor(leaf, dtype=dtype, device=device)


def state_from_numpy(state_np, device):
    """numpy state -> torch state, for either model: (n0, *leaves), where a
    leaf is a (re, im) pair of arrays (planar) or a plain array. The FM
    state has four leaves (n0, rf_tail, disc_carry, deemph_zi), the AM
    state two (n0, rf_tail)."""
    n0, *leaves = state_np
    return (torch.tensor(int(np.asarray(n0)), dtype=torch.int32,
                         device=device),
            *(_leaf_to_torch(leaf, device) for leaf in leaves))


def _leaf_to_numpy(x):
    if isinstance(x, ComplexArray):
        return planar_to_numpy(x)
    return x.detach().cpu().numpy()


def state_to_numpy(state):
    """Torch state of either model -> (n0, leaf, ...) numpy leaves, planar
    leaves as (re, im) pairs."""
    n0, *leaves = state
    return (np.asarray(n0.detach().cpu().numpy(), np.int32),
            *(_leaf_to_numpy(x) for x in leaves))


# ---------------------------------------------------------------------------
# The streaming layer
# ---------------------------------------------------------------------------

_STAGES = {"MixerStream": MixerStream, "FirStream": FirStream,
           "IirStream": IirStream, "SosStream": SosStream,
           "QuadFmStream": QuadFmStream}


def _host_value(v):
    """Numpy scalars and arrays, and nested sequences of them, as Python
    floats and tuples (the stages keep their coefficients as host
    tuples)."""
    if isinstance(v, (tuple, list, np.ndarray)):
        return tuple(_host_value(e) for e in v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def stream_stage_from_fields(name, fields):
    """The port's stream stage from the class name and the fields
    (``dataclasses.asdict``) of a JAX stream stage; IirStream and SosStream
    take the port's default impl, 'auto'."""
    if name not in _STAGES:
        raise NotImplementedError(f"stream stage {name!r} has no "
                                  "counterpart in the port")
    return _STAGES[name](**{k: _host_value(v) for k, v in fields.items()})


def chain_from_fields(stages):
    """The port's Chain from [(class name, fields), ...] of the stages of a
    JAX Chain, in order."""
    return Chain(tuple(stream_stage_from_fields(name, fields)
                       for name, fields in stages))


def chain_state_from_numpy(states_np, device):
    """A chain state from numpy leaves, one per stage: int32 n0 of a mixer,
    (re, im) pairs for planar tails, zi vectors and SOS (S,) + batch + (2,)
    stacks, plain arrays for real ones."""
    return tuple(_leaf_to_torch(leaf, device) for leaf in states_np)


def chain_state_to_numpy(states):
    """A chain state -> numpy leaves, planar leaves as (re, im) pairs."""
    return tuple(_leaf_to_numpy(x) for x in states)
