"""Host runtime of the port: the native ring buffer, framer, sample
staging and 2-bit packing (``host.py``, the C ABI of ``native/src``), and
the stream driver (``stream_runner.py``). Counterpart of
``gsdr_tpu/runtime``."""

from gsdr_tpu_torch.runtime.host import (
    Framer,
    HostLib,
    RingBuffer,
    int8_iq_to_planar,
    int16_iq_to_planar,
    native_available,
    pack_2bit,
    unpack_2bit,
)
from gsdr_tpu_torch.runtime.stream_runner import IqFileSource, StreamRunner

__all__ = [
    "HostLib",
    "RingBuffer",
    "Framer",
    "int8_iq_to_planar",
    "int16_iq_to_planar",
    "pack_2bit",
    "unpack_2bit",
    "native_available",
    "StreamRunner",
    "IqFileSource",
]
