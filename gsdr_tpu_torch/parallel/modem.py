"""Sharded modems: many independent QPSK/QPSK256 streams on a mesh.

Counterpart of ``gsdr_tpu/parallel/modem.py`` (BASELINE config 5: a
256-stream QPSK256 pipeline sharded across hosts). Streams shard over
'channel' and each stream's symbols over 'time'; symbol decisions are
memoryless, so there is no communication at all. Each rank maps its own
(S/c, N/t) tile: RECTANGULAR through the arithmetic paths, any other
table through the table lookup and the exhaustive nearest-neighbour
demodulator, which is kernel B6 on the card (``ops/qpsk256.py``).
Decisions come back int32, as JAX's.
"""

import torch

from gsdr_tpu_torch.carray import as_planar
from gsdr_tpu_torch.ops.qpsk import (
    qpsk_demodulate_symbols,
    qpsk_modulate_symbols,
)
from gsdr_tpu_torch.ops.qpsk256 import (
    RECTANGULAR,
    qpsk256_demodulate,
    qpsk256_demodulate_rect,
    qpsk256_modulate,
    qpsk256_modulate_rect,
)


def make_sharded_qpsk256_modem(modem, mesh):
    """(tx, rx) over this rank's tile of a ('channel', 'time') mesh.

    tx: symbol values int32 (S/c, N/t) -> planar samples; rx: planar
    samples (S/c, N/t) -> int32 symbol values. The modem's table must live
    on the mesh's device."""
    if modem.table.device != mesh.device:
        raise ValueError(f"the modem lives on {modem.table.device}, the "
                         f"mesh on {mesh.device}")
    rect = modem.constellation_type == RECTANGULAR
    amp, table = modem.amplitude, modem.table

    def tx(symbols):
        sym = torch.as_tensor(symbols, device=mesh.device)
        if rect:  # arithmetic, equal to the table lookup
            return qpsk256_modulate_rect(sym, amp)
        return qpsk256_modulate(sym, table)

    def rx(samples):
        x = as_planar(samples, device=mesh.device)
        if rect:
            return qpsk256_demodulate_rect(x, amp, out_dtype=torch.int32)
        return qpsk256_demodulate(x, table, out_dtype=torch.int32)

    return tx, rx


def make_sharded_qpsk_modem(modem, mesh):
    """(tx, rx) for the 4-ary modem over this rank's tile: 2-bit symbol
    values int32 -> planar samples (sign arithmetic, no table), and back.
    Byte packing stays outside: it reshapes, so sharding it over time
    would split bytes."""
    amp = modem.amplitude

    def tx(symbols):
        return qpsk_modulate_symbols(
            torch.as_tensor(symbols, device=mesh.device), amp)

    def rx(samples):
        return qpsk_demodulate_symbols(as_planar(samples, device=mesh.device))

    return tx, rx
