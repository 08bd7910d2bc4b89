"""The plain channel stage: mix every channel down, low-pass, decimate.

Channel c's output j is the window of T samples that starts at stream
index g_j = s - (T - 1) + j*D, weighted by the taps and mixed down by the
channel's shift f_c = tuning - f_channel, with the mixer's phase counted
from the block's start index modulo round(Fs), as a streaming receiver
whose sample counter wraps once a second counts it:

    y_c[j] = e^{2 pi i frac(f_c n_j / Fs)} * sum_t h[t] x[g_j + t]
             e^{2 pi i frac(f_c t / Fs)},
    n_j = ((s' mod round(Fs)) - (T - 1)) mod round(Fs) + j'*D,

where s' is the start of the block that output j falls in and j' its
index there. Every phase fraction is exact (rational arithmetic on the
binary values of f_c and Fs); the sums run in float64 (complex128). The
design is worked out here from the taps and the channel list alone.
"""

from fractions import Fraction

import numpy as np
import torch

_TWO_PI = 2.0 * np.pi
_ROWS = 2048      # outputs a matmul, to bound the windows' memory


def phase_ratios(design):
    """(p, q) int64 arrays with f_c / Fs = p_c / q_c, 0 <= p_c < q_c."""
    fs = Fraction(float(design["sample_rate"]))
    p, q = [], []
    for f in design["channel_frequencies"]:
        r = Fraction(float(design["tuning_frequency"]) - float(f)) / fs
        p.append(r.numerator % r.denominator)
        q.append(r.denominator)
    return np.asarray(p, np.int64), np.asarray(q, np.int64)


def _expj_frac(p, q, n):
    """e^{2 pi i frac(p n / q)} for int64 tensors p, q (C, 1) and n."""
    frac = torch.remainder(p * n, q).double() / q.double()
    return torch.polar(torch.ones_like(frac), _TWO_PI * frac)


def stage(x, design, s, warm, block_samples):
    """(C, warm + M) complex128 outputs of the block of ``block_samples``
    samples that starts at stream index ``s``, from ``warm`` outputs
    before it. ``x`` holds the stream's samples [s - (T-1) - warm*D,
    s + block_samples) as a complex128 tensor."""
    taps = torch.as_tensor(np.asarray(design["taps"], np.float64),
                           device=x.device)
    t_len, d = taps.shape[0], int(design["decimation"])
    n = int(block_samples)
    m_total = (x.shape[0] - t_len) // d + 1
    if m_total != warm + n // d:
        raise ValueError(f"{x.shape[0]} samples give {m_total} outputs, "
                         f"want {warm} + {n // d}")
    p_np, q_np = phase_ratios(design)
    p = torch.as_tensor(p_np, device=x.device)[:, None]
    q = torch.as_tensor(q_np, device=x.device)[:, None]
    t = torch.arange(t_len, dtype=torch.int64, device=x.device)[None, :]
    bank = (taps[None, :] * _expj_frac(p, q, t)).T.contiguous()   # (T, C)
    fs = int(round(float(design["sample_rate"])))
    j = torch.arange(-warm, n // d, dtype=torch.int64, device=x.device)
    blk = torch.div(j * d, n, rounding_mode="floor")     # block offset <= 0
    start = torch.remainder(s + blk * n, fs)
    idx = torch.remainder(start - (t_len - 1), fs) + (j - blk * (n // d)) * d
    rotor = _expj_frac(p, q, idx[None, :])                   # (C, M')
    windows = x.as_strided((m_total, t_len), (d, 1))
    out = torch.empty((m_total, bank.shape[1]), dtype=torch.complex128,
                      device=x.device)
    for a in range(0, m_total, _ROWS):
        out[a:a + _ROWS] = windows[a:a + _ROWS] @ bank
    return out.T * rotor
