"""The plain AM envelope receiver: the channel stage, then
2 * clip(|y|, 0, 1) - 1, in float64. It carries no state but the input's
tail, so a block needs no outputs before it."""

import torch

from sdr_bench.reference import channel


def warm_outputs(design):
    return 0


def receive(x, design, s, block_samples):
    """{'audio': (C, M) float64} of the block at stream index ``s``."""
    y = channel.stage(x, design, s, 0, block_samples)
    return {"audio": (2.0 * torch.clamp(y.abs(), 0.0, 1.0) - 1.0)
            .cpu().numpy()}
