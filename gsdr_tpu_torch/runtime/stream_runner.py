"""Stream driver: pump framed RF blocks through a streaming step.

Counterpart of ``gsdr_tpu/runtime/stream_runner.py``. A sample source
(an IQ file, a socket, an SDR driver) feeds the native ring buffer; the
runner takes fixed blocks from it (the overlap is the model's carried
state, not the framer's) and calls ``step(state, block)`` with the state
threaded through. On the card the step is compiled, as the JAX package
jits it (``utils/compile.py``: one CUDA graph, captured at the first
block), and each block goes from one pinned host buffer straight into the
graph's static block, by a copy that does not block the host; the next
block waits for that copy before it reuses the buffer. On the CPU the
step runs as it is.
"""

import numpy as np
import torch

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.runtime.host import (
    RingBuffer,
    int8_iq_to_planar,
    int16_iq_to_planar,
)
from gsdr_tpu_torch.utils.compile import compile_step


class IqFileSource:
    """Reads an interleaved IQ recording (int8, int16 or float32) in chunks
    of ``chunk_samples``, staged to planar float32 by the native
    converters."""

    def __init__(self, path, fmt="int8", chunk_samples=1 << 16):
        if fmt not in ("int8", "int16", "float32"):
            raise ValueError(f"unknown IQ format {fmt}")
        self.path = path
        self.fmt = fmt
        self.chunk = int(chunk_samples)
        self._itemsize = {"int8": 1, "int16": 2, "float32": 4}[fmt]
        self._f = open(path, "rb")

    def read_planar(self):
        """The next chunk as (re, im) float32, or None at the end."""
        raw = self._f.read(self.chunk * 2 * self._itemsize)
        if not raw:
            return None
        if self.fmt == "int8":
            return int8_iq_to_planar(np.frombuffer(raw, np.int8))
        if self.fmt == "int16":
            return int16_iq_to_planar(np.frombuffer(raw, np.int16))
        x = np.frombuffer(raw, np.float32)
        return x[0::2].copy(), x[1::2].copy()

    def close(self):
        self._f.close()


class StreamRunner:
    """Drives ``step(state, ComplexArray(block)) -> (state, out)`` over a
    source, the state carried in ``self.state``.

    ``device`` (default 'cuda', which raises where CUDA is missing) is
    where the blocks are staged; on the card the step is compiled, and
    ``state`` is then the graph's buffers, valid until the next block (a
    checkpoint, ``utils/checkpoint.py``, copies them). ``stats`` counts
    the samples fed, the blocks processed and the ring's high watermark;
    feeding more than the ring holds raises.
    """

    def __init__(self, step, init_state, block_len, ring_capacity=None,
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "StreamRunner: device 'cuda' requested but CUDA is not "
                "available; pass device='cpu'")
        self.block_len = int(block_len)
        self.device = device
        self._step = compile_step(step) if device.type == "cuda" else step
        self.state = init_state
        self.ring = RingBuffer(ring_capacity or 4 * self.block_len)
        self.stats = {
            "samples_in": 0,
            "blocks_processed": 0,
            "ring_high_watermark": 0,
        }
        self._pinned = self._copied = self._static = None
        if device.type == "cuda":
            self._pinned = torch.empty((2, self.block_len),
                                       dtype=torch.float32, pin_memory=True)

    def feed_planar(self, re, im):
        """Stage planar samples into the transport ring."""
        inter = np.empty(2 * len(re), np.float32)
        inter[0::2] = re
        inter[1::2] = im
        written = self.ring.write(inter)
        if written < len(re):
            raise RuntimeError("ring overflow: consumer too slow")
        self.stats["samples_in"] += written
        self.stats["ring_high_watermark"] = max(
            self.stats["ring_high_watermark"], self.ring.readable)

    def _next_block(self):
        """The next block from the ring as a planar tensor on the device."""
        if self._pinned is None:
            re, im = self.ring.read_planar(self.block_len)
            return ComplexArray(torch.from_numpy(re), torch.from_numpy(im))
        if self._copied is not None:
            self._copied.synchronize()  # the last copy has left the buffer
        planes = self._pinned.numpy()
        self.ring.read_planar(self.block_len, (planes[0], planes[1]))
        if self._static is None:
            # the first block: the graph is captured on it, and its
            # static block takes every later one
            dev = self._pinned.to(self.device, non_blocking=True)
            self._static = self._step.block_buffer(
                self.state, ComplexArray(dev[0], dev[1]))
        else:
            self._static.re.copy_(self._pinned[0], non_blocking=True)
            self._static.im.copy_(self._pinned[1], non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()
        return self._static

    def pump(self):
        """Process every full block buffered; returns the step outputs,
        device tensors not yet fetched."""
        outs = []
        while self.ring.readable >= self.block_len:
            self.state, out = self._step(self.state, self._next_block())
            self.stats["blocks_processed"] += 1
            outs.append(out)
        return outs

    def run_file(self, source):
        """Stream an IqFileSource to its end; returns every output."""
        outs = []
        while True:
            chunk = source.read_planar()
            if chunk is None:
                break
            self.feed_planar(*chunk)
            outs.extend(self.pump())
        return outs
