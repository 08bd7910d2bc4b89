"""chain_us: device microseconds a block of the chain kernel, the fused
front and back end (``fm_chain_tile`` of ``csrc/fm_chain.cu``,
``am_chain_tile`` of ``csrc/am_chain.cu``), from the profiler's kernel
records."""

import re

CHAIN = re.compile(r"\b(?:fm|am)_chain_tile\b")


def read(ctx):
    us = ctx.device_us(lambda r: r.cat == "kernel" and CHAIN.search(r.name))
    return us if us > 0 else None
