"""The plain FM receiver: the channel stage, a quadrature discriminator
and a first-order de-emphasis, in float64.

    d[j] = Fs / (2 pi dev) * arg(y[j] * conj(y[j-1]))
    H(s) = 1 / (1 + s tau), bilinear at the audio rate Fs/D:
    k = tan(1 / (2 tau Fs/D)), b0 = b1 = k/(1+k), a1 = (k-1)/(k+1)
    out[j] = b0 d[j] + z[j-1],  z[j] = b1 d[j] - a1 out[j]

The block starts ``warm_outputs`` outputs early from zero state: the
discriminator's previous sample is then exact and the de-emphasis state
has decayed by |a1|^warm below 1e-12, so the block needs only its input.
The state it ends with is the last rotated channel sample and z.
"""

import math

import numpy as np
import torch

from sdr_bench.reference import channel

_DECAY = 1e-12


def coefficients(design):
    """(gain, b0, a1) of the discriminator and the de-emphasis."""
    fs = float(design["sample_rate"])
    gain = fs / (2.0 * math.pi * float(design["frequency_deviation"]))
    k = math.tan(1.0 / (2.0 * float(design["deemphasis_tau"])
                        * fs / int(design["decimation"])))
    return gain, k / (1.0 + k), (k - 1.0) / (k + 1.0)


def warm_outputs(design):
    a1 = abs(coefficients(design)[2])
    return 2 if a1 == 0.0 else 2 + math.ceil(math.log(_DECAY)
                                             / math.log(a1))


def receive(x, design, s, block_samples):
    """{'audio': (C, M) float64, 'carry': (C,) complex128, 'zi': (C,)} of
    the block at stream index ``s``; ``x`` as ``channel.stage`` takes it
    with ``warm_outputs(design)`` outputs before the block."""
    warm = warm_outputs(design)
    y = channel.stage(x, design, s, warm, block_samples)
    gain, b0, a1 = coefficients(design)
    disc = (gain * torch.angle(y[:, 1:] * torch.conj(y[:, :-1]))).cpu() \
        .numpy()
    out = np.empty_like(disc)
    z = np.zeros(disc.shape[0])
    for j in range(disc.shape[1]):
        out[:, j] = b0 * disc[:, j] + z
        z = b0 * disc[:, j] - a1 * out[:, j]
    return {"audio": out[:, warm - 1:], "carry": y[:, -1].cpu().numpy(),
            "zi": z}
