"""The least time of a block on a card, from its work and the card's
published peaks (``peaks.json``): the larger of the bytes over the HBM
rate and the least over the algorithms of the operations over their
units' rates."""

from pathlib import Path

from sdr_bench.registry import load_json

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name):
    """The card's peaks, or None for a card the table does not hold."""
    return load_json(PEAKS).get(device_name)


def bound_s(work, card):
    """(seconds, 'bytes' or 'operations') of ``work`` (as a work
    module's ``counts`` gives it) on ``card`` (``peaks``)."""
    t_bytes = work["bytes"] / card["hbm_bytes_per_s"]
    t_ops = work["fp32_flops"] / card["fp32_flops"]
    for tensor, fp32 in work["tensor"]:
        t_ops = min(t_ops, tensor / card["bf16_flops"]
                    + fp32 / card["fp32_flops"])
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")
