"""The stream of blocks through the compiled step, as a receiver drives it.

Blocks come from the ring in order, the state carried; each call runs
``state, out = step(state, block)`` and is followed by a completion event
on the stream (in a mix whose audio goes to the host, after the audio's
copy into pinned memory on a second stream, overlapped with the next
block's step). The host runs at most ``max_ahead`` blocks ahead of the
completions. The time of a block on the card is the interval between two
consecutive completion events.

A seeded reservoir keeps ``keep`` of the sampled blocks' outputs,
and the last block's is always kept, for the comparison once the stream
has stopped.
"""

import collections
import ctypes
import dataclasses
import gc
import random
import time

import torch


class _HostEvent:
    """A completion stamp on the host clock, for a stream on the CPU."""

    def __init__(self):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _event(device):
    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return _HostEvent()


@dataclasses.dataclass
class Stretch:
    """Blocks stepped in one run of ``Stream.run``: the count, the host's
    seconds from the first call to the last completion, each block's time
    on the card (ms, completion to completion; the first from the
    stretch's start), and each call's, wait's and audio copy's host
    seconds."""

    blocks: int
    seconds: float
    block_ms: list
    calls: list
    waits: list
    copies: list


class Stream:
    """The compiled step over the ring, from stream block ``position``."""

    def __init__(self, step, state, ring, make_block, traffic, device,
                 seed, keep):
        self.step = step
        self.state = state
        self.blocks = [make_block(*parts) for parts in zip(*ring)]
        self.device = torch.device(device)
        self.ahead = int(traffic["max_ahead"])
        self.position = 0
        self.keep_count = int(keep)
        self.kept = {}          # stream block -> output, sampled
        self.last = None        # (stream block, output) of the last block
        self.sampling = False
        self._rng = random.Random(int(seed) ^ 0x5DB3)
        self._seen = 0
        self.host = None
        if traffic["audio"] == "host":
            self.host = _HostCopies(int(traffic["host_buffers"]),
                                    self.device)
            if self.ahead > self.host.count:
                raise ValueError("max_ahead exceeds host_buffers: the host "
                                 "would reuse a buffer not yet consumed")
        elif traffic["audio"] != "device":
            raise ValueError(f"audio {traffic['audio']!r}: 'device' or "
                             "'host'")
        # completion events, reused in turn: a block's time is read once
        # its event and the one before have completed
        self._events = [_event(self.device) for _ in range(self.ahead + 2)]
        for ev in self._events:
            ev.record()              # its CUDA handle exists once used

    def _keep(self, out):
        self.last = (self.position, out)
        if not self.sampling:
            return
        self._seen += 1
        if len(self.kept) < self.keep_count:
            self.kept[self.position] = out
            return
        j = self._rng.randrange(self._seen)
        if j < self.keep_count:
            del self.kept[sorted(self.kept)[j]]
            self.kept[self.position] = out

    def run(self, stop):
        """Step blocks until ``stop(blocks done, seconds since the first
        call)``; returns a Stretch. The garbage collector is held off
        while the blocks run."""
        ev = self._events
        n_ev = len(ev)
        calls, waits, copies, block_ms = [], [], [], []
        inflight = collections.deque()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        gc_was = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        ev[0].record()
        i = 0
        while True:
            if i >= self.ahead:
                k = i - self.ahead           # the block waited for
                w0 = time.perf_counter()
                ev[(k + 1) % n_ev].synchronize()
                waits.append(time.perf_counter() - w0)
                block_ms.append(ev[k % n_ev].elapsed_time(
                    ev[(k + 1) % n_ev]))
                inflight.popleft()
            if stop(i, time.perf_counter() - t0):
                break
            blk = self.blocks[self.position % len(self.blocks)]
            c0 = time.perf_counter()
            self.state, out = self.step(self.state, blk)
            calls.append(time.perf_counter() - c0)
            done = ev[(i + 1) % n_ev]
            if self.host is not None:
                c0 = time.perf_counter()
                self.host.copy(self.position, out, done)
                copies.append(time.perf_counter() - c0)
            else:
                done.record()
            inflight.append(out)
            self._keep(out)
            self.position += 1
            i += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        if gc_was:
            gc.enable()
        for k in range(max(0, i - self.ahead + 1), i):
            block_ms.append(ev[k % n_ev].elapsed_time(ev[(k + 1) % n_ev]))
        return Stretch(i, seconds, block_ms, calls, waits, copies)


class _LibCuda:
    """libcuda's event record, stream wait and asynchronous copy to the
    host, through ctypes: a few microseconds of the host's time a
    block where torch's ``copy_`` with its stream switch took ~45, which
    made a live cell's pace the harness's own."""

    def __init__(self):
        lib = ctypes.CDLL("libcuda.so.1")
        p, size = ctypes.c_void_p, ctypes.c_size_t
        self.record = lib.cuEventRecord
        self.record.argtypes = [p, p]
        self.wait = lib.cuStreamWaitEvent
        self.wait.argtypes = [p, p, ctypes.c_uint]
        self.copy = lib.cuMemcpyDtoHAsync_v2
        self.copy.argtypes = [p, ctypes.c_uint64, size, p]
        for fn in (self.record, self.wait, self.copy):
            fn.restype = ctypes.c_int

    @staticmethod
    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what} failed: CUDA error {err}")


class _HostCopies:
    """Pinned host buffers the audio is copied into, one a block in turn,
    on a stream of its own after the step's stream reaches the block's
    end (a live receiver's double buffering)."""

    def __init__(self, count, device):
        self.count = count
        self.device = device
        self.buffers = {}
        self.blocks = [None] * count
        self.libcuda = None
        if device.type == "cuda":
            self.libcuda = _LibCuda()
            # the step's stream: the harness never switches streams
            self.step_stream = torch.cuda.current_stream(device).cuda_stream
            self.stream = torch.cuda.Stream(device)
            self.ready = [torch.cuda.Event() for _ in range(count)]
            for ev in self.ready:
                ev.record()          # its CUDA handle exists once used

    def copy(self, position, out, event):
        slot = position % self.count
        buf = self.buffers.get(slot)
        if buf is None:
            buf = self.buffers[slot] = torch.empty(
                out.shape, dtype=out.dtype,
                pin_memory=self.device.type == "cuda")
        self.blocks[slot] = (position, out)
        if self.libcuda is None:
            buf.copy_(out)
            event.record()
            return
        cu, copy_stream = self.libcuda, self.stream.cuda_stream
        ready = self.ready[slot].cuda_event
        cu.check(cu.record(ready, self.step_stream), "cuEventRecord")
        cu.check(cu.wait(copy_stream, ready, 0), "cuStreamWaitEvent")
        cu.check(cu.copy(buf.data_ptr(), out.data_ptr(),
                         out.numel() * out.element_size(), copy_stream),
                 "cuMemcpyDtoHAsync")
        cu.check(cu.record(event.cuda_event, copy_stream), "cuEventRecord")

    def mismatches(self):
        """Elements of the host buffers that differ from the device output
        they were copied from (call once the copies are complete)."""
        bad = 0
        for slot, held in enumerate(self.blocks):
            if held is not None:
                bad += int((self.buffers[slot] != held[1].cpu()).sum())
        return bad
