"""Carry JAX models and streaming states across to the port, through plain
Python scalars and numpy arrays: the receivers ``FmChannelizer`` and
``AmReceiver`` with their states, the modems ``QpskModem`` and
``Qpsk256Modem``, and the planar tails of the PFB block streams
(``pfb_channelize_block``, ``pfb_synthesize_block``).

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

_IMPL_MAP = {"auto": "auto", "xla": "torch", "pallas": "cuda",
             "pfb": "pfb", "pfb_pallas": "pfb"}


def _port_fields(fields):
    """The JAX model's fields with impl and precision mapped to the port's.

    impl maps 'xla' -> 'torch', 'pallas' -> 'cuda', and both 'pfb' and
    'pfb_pallas' -> 'pfb' (the PFB kernel on the card, the plain PFB chain
    on the CPU). The JAX default grade 'bf16x3' has no port yet, so it
    carries over as the port's default 'f32'; 'bf16x2' raises.
    """
    fields = dict(fields)
    impl = fields.pop("impl", "auto")
    if impl not in _IMPL_MAP:
        raise NotImplementedError(
            f"impl={impl!r} has no counterpart in the port yet")
    precision = fields.pop("precision", "f32")
    if precision == "bf16x3":
        precision = "f32"
    return dict(fields, impl=_IMPL_MAP[impl], precision=precision)


def fm_channelizer_from_fields(fields, device="cuda"):
    """The port's FmChannelizer from the fields of a JAX FmChannelizer."""
    return FmChannelizer(**_port_fields(fields), device=device)


def am_receiver_from_fields(fields, device="cuda"):
    """The port's AmReceiver from the fields of a JAX AmReceiver."""
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
    if isinstance(leaf, (tuple, list)):
        return planar_from_numpy(leaf, device)
    return torch.tensor(np.asarray(leaf), dtype=torch.float32, device=device)


def state_from_numpy(state_np, device):
    """numpy state -> torch state, for either model: (n0, *leaves), where a
    leaf is a (re, im) pair of arrays (planar) or a plain array. The FM
    state has four leaves (n0, rf_tail, disc_carry, deemph_zi), the AM
    state two (n0, rf_tail)."""
    n0, *leaves = state_np
    return (torch.tensor(int(np.asarray(n0)), dtype=torch.int32,
                         device=device),
            *(_leaf_to_torch(leaf, device) for leaf in leaves))


def state_to_numpy(state):
    """Torch state of either model -> (n0, leaf, ...) numpy leaves, planar
    leaves as (re, im) pairs."""
    n0, *leaves = state

    def leaf_np(x):
        if isinstance(x, ComplexArray):
            return planar_to_numpy(x)
        return x.detach().cpu().numpy()

    return (np.asarray(n0.detach().cpu().numpy(), np.int32),
            *(leaf_np(x) for x in leaves))
