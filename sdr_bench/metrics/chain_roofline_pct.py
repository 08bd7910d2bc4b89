"""chain_roofline_pct: the least time of a block on the card (the cell's
work over the card's peaks: ``work/``, ``roofline.py``) as a share of the
chain kernel's device time a block (``chain_us``)."""


def read(ctx):
    chain = ctx.value("chain_us")
    if chain is None or ctx.bound_s is None:
        return None
    return 100.0 * ctx.bound_s * 1e6 / chain
