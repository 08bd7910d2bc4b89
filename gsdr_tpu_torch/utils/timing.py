"""Timing of streaming steps (counterpart of ``gsdr_tpu/utils/timing.py``).

A burst of ``iters`` chained steps, the state threaded from one to the
next, is timed between two CUDA events (on the CPU, the host clock); the
result is the median over ``reps`` bursts, per step. Torch runs eagerly,
so nothing is compiled away and no overhead is subtracted: the time
includes the host's work of issuing each step, which is what a streaming
caller pays.
"""

import statistics
import time

import torch


def device_of(block):
    """The device of a block (a tensor or ComplexArray); the CPU for
    anything without one."""
    dev = getattr(block, "device", None)
    return torch.device(dev) if dev is not None else torch.device("cpu")


def time_step(step, state, block, iters=20, reps=3):
    """Median seconds per ``step(state, block)`` over ``reps`` bursts of
    ``iters`` chained steps, after one warm-up step."""
    if iters < 1 or reps < 1:
        raise ValueError("iters and reps must be >= 1")
    cuda = device_of(block).type == "cuda"
    state, _ = step(state, block)
    per_step = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                state, _ = step(state, block)
            end.record()
            end.synchronize()
            per_step.append(start.elapsed_time(end) * 1e-3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                state, _ = step(state, block)
            per_step.append((time.perf_counter() - t0) / iters)
    return statistics.median(per_step)
