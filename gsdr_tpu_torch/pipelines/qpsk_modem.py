"""QPSK and QPSK256 modem pipelines (mod -> channel -> demod loopback).

Counterpart of ``gsdr_tpu/pipelines/qpsk_modem.py``: packed data bytes to
constellation samples at the transmitter, received samples to hard
decisions and packed bytes at the receiver. Parallel streams are leading
axes. Each modem carries a ``device`` that defaults to 'cuda' and raises
where CUDA is missing; its inputs are moved there. Bytes leave ``rx`` as
``torch.uint8`` unless another ``out_dtype`` is asked for.
"""

import dataclasses
from dataclasses import dataclass

import torch

from gsdr_tpu_torch.carray import as_planar
from gsdr_tpu_torch.ops.qpsk import (
    pack_2bit_symbols,
    qpsk_demodulate_symbols,
    qpsk_modulate,
)
from gsdr_tpu_torch.ops.qpsk256 import (
    CIRCULAR,
    RECTANGULAR,
    qpsk256_constellation,
    qpsk256_demodulate,
    qpsk256_demodulate_circular,
    qpsk256_demodulate_rect,
    qpsk256_modulate,
    qpsk256_modulate_circular,
    qpsk256_modulate_rect,
)


def _device(model, device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{model}: device 'cuda' requested but CUDA is not available; "
            "pass device='cpu' to run the plain versions")
    return device


@dataclass(frozen=True)
class QpskModem:
    """4-ary PSK modem. tx: packed bytes -> planar symbols; rx: samples ->
    packed bytes."""

    amplitude: float = 1.0
    device: str = "cuda"

    def __post_init__(self):
        _device("QpskModem", self.device)

    def tx(self, packed_bytes, num_symbols=None):
        return qpsk_modulate(torch.as_tensor(packed_bytes, device=self.device),
                             amplitude=self.amplitude,
                             num_symbols=num_symbols, planar=True)

    def rx(self, samples, out_dtype=torch.uint8):
        return pack_2bit_symbols(
            qpsk_demodulate_symbols(as_planar(samples, device=self.device)),
            out_dtype=out_dtype)

    def loopback(self, packed_bytes, channel_fn=None):
        """tx -> optional channel impairment -> rx; returns packed bytes."""
        s = self.tx(packed_bytes)
        if channel_fn is not None:
            s = channel_fn(s)
        return self.rx(s)


@dataclass(frozen=True)
class Qpsk256Modem:
    """256-ary modem over either constellation geometry.

    ``exact_tables`` forces the table paths (the table lookup, and the
    exhaustive nearest-neighbour demodulator, which runs the QPSK256
    kernel on the card) in place of the arithmetic fast paths. The fast
    paths are bit-identical for RECTANGULAR; for CIRCULAR the arithmetic
    modulator is within float32 sin/cos accuracy (~1e-7) of the table and
    the ring demodulator differs from the exhaustive one only on exact
    Voronoi-boundary ties.
    """

    constellation_type: int = RECTANGULAR
    amplitude: float = 1.0
    exact_tables: bool = False
    device: str = "cuda"
    table: object = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        device = _device("Qpsk256Modem", self.device)
        # built once: the planar table on the modem's device
        object.__setattr__(self, "table", qpsk256_constellation(
            self.constellation_type, self.amplitude, planar=True,
            device=device))

    def constellation(self):
        return self.table

    def tx(self, symbol_bytes):
        symbols = torch.as_tensor(symbol_bytes, device=self.device)
        if not self.exact_tables:
            if self.constellation_type == RECTANGULAR:
                return qpsk256_modulate_rect(symbols, self.amplitude)
            if self.constellation_type == CIRCULAR:
                return qpsk256_modulate_circular(symbols, self.amplitude)
        return qpsk256_modulate(symbols, self.table)

    def rx(self, samples, out_dtype=torch.uint8):
        x = as_planar(samples, device=self.device)
        if not self.exact_tables:
            if self.constellation_type == RECTANGULAR:
                return qpsk256_demodulate_rect(x, self.amplitude,
                                               out_dtype=out_dtype)
            if self.constellation_type == CIRCULAR:
                return qpsk256_demodulate_circular(x, self.amplitude,
                                                   out_dtype=out_dtype)
        return qpsk256_demodulate(x, self.table, out_dtype=out_dtype)

    def loopback(self, symbol_bytes, channel_fn=None):
        s = self.tx(symbol_bytes)
        if channel_fn is not None:
            s = channel_fn(s)
        return self.rx(s)
