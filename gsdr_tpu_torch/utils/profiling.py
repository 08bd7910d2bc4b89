"""Profiling helpers: traces and throughput reports.

Counterpart of ``gsdr_tpu/utils/profiling.py``:

  * ``trace(log_dir)``, a context manager around ``torch.profiler`` that
    writes a Chrome trace (``trace.json``, open it in Perfetto or
    chrome://tracing) of the host and, where there is a card, its kernels;
  * ``throughput_report(step, state, block, ...)``, samples per second of
    a streaming step (``utils/timing.py``) as a dict for regression
    tracking, with the same keys as the JAX package's.
"""

import contextlib
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from gsdr_tpu_torch.utils.timing import device_of, time_step


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block; on exit write ``log_dir/trace.json``. Yields the
    ``torch.profiler.profile`` (``key_averages()`` for sums by kernel)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def throughput_report(step, state, block, samples_per_step, iters=10,
                      label=""):
    """Time a streaming step; returns a dict: label, seconds_per_step,
    samples_per_second, msamples_per_second, backend ('cuda' or 'cpu', the
    block's device), iters and timing_resolved (always True: the time has
    no overhead subtracted that could leave it unresolved)."""
    sec = time_step(step, state, block, iters=iters)
    return {
        "label": label,
        "seconds_per_step": sec,
        "samples_per_second": samples_per_step / sec,
        "msamples_per_second": samples_per_step / sec / 1e6,
        "backend": device_of(block).type,
        "iters": iters,
        "timing_resolved": True,
    }
