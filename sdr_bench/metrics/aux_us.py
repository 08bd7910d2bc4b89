"""aux_us: device microseconds a block of every kernel, device-to-device
copy and memset other than the chain kernel: the receiver step's tail
``cat`` and sample counter, the compiled step's copy of the block into the
graph and of the state back, and the clone of ``out``. Copies to or from
the host are not counted."""

import re

CHAIN = re.compile(r"\b(?:fm|am)_chain_tile\b")
HOST_COPY = re.compile(r"DtoH|HtoD|Pinned|Pageable")


def _aux(r):
    if r.cat == "kernel":
        return not CHAIN.search(r.name)
    return not HOST_COPY.search(r.name)


def read(ctx):
    us = ctx.device_us(_aux)
    return us if us > 0 else None
