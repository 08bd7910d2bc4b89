"""The least work of one block of a channelizing receiver (FM or AM),
counted from the cell's shapes alone, whatever implements it.

Bytes: the block and the carried state read once, the audio and the
state written once, and the T taps; no table that a program derives
(tap banks, DFT banks, polyphase or digit tables). Operations per output
of a channel bank, the least over the known algorithms:

  - float32 units: the direct bank, 8*C*T, or on the Fs/K grid (D | K)
    the polyphase fold 4*T plus the cheaper of the dense K-point product
    8*C*K and an FFT, ~5*K*log2(K);
  - at a bf16 grade also on the tensor cores: the grade's passes times
    the bank's product (8*C*T dense, 8*C*K on the grid), with the fold
    and the back end on the float32 units beside them;

plus the back end on the float32 units: 16 operations an output and
channel for FM (rotor, discriminator, de-emphasis), 8 for AM.
"""

import math

PASSES = {"bf16x3": 3, "bf16x2": 2, "f32": 0}
BACK_END = {"fm": 16.0, "am": 8.0}


def counts(cfg, n, grade):
    """{'bytes', 'fp32_flops', 'tensor': [(tensor FLOP, fp32 FLOP), ...]}
    of one block of ``n`` samples."""
    c, t, d = (int(cfg[k]) for k in ("num_channels", "num_taps",
                                      "decimation"))
    k = int(cfg["grid_k"])
    m = n // d
    back = BACK_END[cfg["modulation"]] * c
    fp32 = 8.0 * c * t
    tensor = []
    passes = PASSES[grade]
    if passes:
        tensor.append((passes * 8.0 * c * t * m, back * m))
    if k % d == 0:
        fp32 = min(fp32, 4.0 * t + min(8.0 * c * k, 5.0 * k * math.log2(k)))
        if passes:
            tensor.append((passes * 8.0 * c * k * m, (4.0 * t + back) * m))
    state = 8 * (t - 1) + 4 + (12 * c if cfg["modulation"] == "fm" else 0)
    return {"bytes": 8.0 * n + 2.0 * state + 4.0 * c * m + 4.0 * t,
            "fp32_flops": (fp32 + back) * m, "tensor": tensor}
