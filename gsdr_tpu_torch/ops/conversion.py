"""Sample-format conversions (counterpart of ``gsdr_tpu/ops/conversion.py``)."""

import torch


def int8_to_norm_float(x):
    """Normalize int8 samples into [-1.0, 1.0], on the device of ``x``.

    out = max(-1, x / 127): -127 and -128 both map to -1.0, 127 to 1.0 and
    0 to 0.0. ``x`` is a tensor or anything ``torch.as_tensor`` takes.
    """
    x = torch.as_tensor(x)
    return torch.clamp_min(x.to(torch.float32) * (1.0 / 127.0), -1.0)
