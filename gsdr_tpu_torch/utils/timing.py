"""Timing of streaming steps (counterpart of ``gsdr_tpu/utils/timing.py``).

On the card, as the JAX package times one jitted program of K chained
steps, ``time_step`` captures ``iters`` chained steps as one CUDA graph
(``utils/compile.py``) and times replays of it between two CUDA events;
the result is the median over ``reps`` replays, per step. ``eager=True``
times a burst of ``iters`` eager steps instead, what a caller without
capture pays, the host's work of issuing each step included; on the CPU
the steps always run eagerly, timed by the host clock. No overhead is
subtracted.
"""

import statistics
import time

import torch

from gsdr_tpu_torch.utils.compile import compile_step, device_of

__all__ = ["device_of", "time_step"]


def _events(run):
    """Milliseconds of run() between two CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_step(step, state, block, iters=20, reps=3, eager=False):
    """Median seconds per ``step(state, block)``, the state threaded from
    step to step: over ``reps`` replays of one CUDA graph of ``iters``
    chained steps on the card, or over ``reps`` bursts of ``iters`` eager
    steps (``eager=True``, or a block on the CPU), after one warm-up."""
    if iters < 1 or reps < 1:
        raise ValueError("iters and reps must be >= 1")
    cuda = device_of(block).type == "cuda"
    if cuda and not eager:
        run = compile_step(step, steps=iters)
        block = run.block_buffer(state, block)   # no copy at each replay
        state, _ = run(state, block)
        per_step = []
        for _ in range(reps):
            def replay():
                nonlocal state
                state, _ = run(state, block)

            per_step.append(_events(replay) * 1e-3 / iters)
        return statistics.median(per_step)
    state, _ = step(state, block)
    per_step = []
    for _ in range(reps):
        def burst():
            nonlocal state
            for _ in range(iters):
                state, _ = step(state, block)

        if cuda:
            per_step.append(_events(burst) * 1e-3 / iters)
        else:
            t0 = time.perf_counter()
            burst()
            per_step.append((time.perf_counter() - t0) / iters)
    return statistics.median(per_step)
