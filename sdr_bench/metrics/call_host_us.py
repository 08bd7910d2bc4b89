"""call_host_us: the host's microseconds in one call of the compiled step
(``CompiledStep.__call__``: the block's copy into the graph's buffer, the
replay's launch, the clone of ``out``), the median of the harness's
``perf_counter`` spans around each call of the untraced stretch."""

import statistics


def read(ctx):
    if not ctx.call_seconds:
        return None
    return statistics.median(ctx.call_seconds) * 1e6
