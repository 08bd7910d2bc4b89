"""device_idle_pct: the share of the traced window in which no kernel,
copy or memset ran on the card, from the union of the profiler's device
records."""


def read(ctx):
    if ctx.window_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_us() / ctx.window_us)
