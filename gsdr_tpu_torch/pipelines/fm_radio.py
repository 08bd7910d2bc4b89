"""Multi-channel FM broadcast receiver (channelizer), the flagship model.

Counterpart of ``gsdr_tpu/pipelines/fm_radio.py``. One wideband planar RF
stream in; C demodulated, de-emphasized audio channels out:
complex-tap-bank mix + FIR + decimate (or, for channels on a uniform
Fs/K grid, the polyphase fold + DFT bank) -> LO rotor -> quadrature
discriminator -> first-order TDF-II de-emphasis, with the streaming state
(n0, rf_tail, disc_carry, deemph_zi) carried from block to block in the
same order, shapes and meaning as the JAX model.
"""

import math

import torch
from torch import nn

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.kernels.chain import GRADES, select_front
from gsdr_tpu_torch.kernels.fm_chain import (
    deemphasis_triple,
    fm_chain,
    fm_chain_reference,
    pfb_fm_chain,
    pfb_fm_chain_reference,
)
from gsdr_tpu_torch.ops.channelize import make_complex_tap_bank
from gsdr_tpu_torch.ops.pfb import _dft_bank_stacked, _poly_taps
from gsdr_tpu_torch.utils.phase import phase_digit_table

_TWO_PI = 6.283185307179586
_IMPLS = ("auto", "torch", "cuda", "pfb", "pfb_torch")


def fm_deemphasis_coeffs(tau_seconds, sample_rate):
    """First-order de-emphasis IIR (b, a) via bilinear transform of
    H(s)=1/(1+s*tau); sample_rate is the post-decimation audio rate.

    Raises when the prewarp argument 1/(2*tau*fs) reaches pi/2: past it
    the mapped pole leaves the unit circle and the filter is unstable.
    The validity condition is tau > 1/(pi * audio_rate)."""
    arg = 1.0 / (2.0 * float(tau_seconds) * float(sample_rate))
    if arg >= math.pi / 2.0:
        raise ValueError(
            f"de-emphasis tau={tau_seconds} is below the bilinear "
            f"validity limit 1/(pi*audio_rate) = "
            f"{1.0 / (math.pi * float(sample_rate)):.3g} s at audio rate "
            f"{sample_rate:.6g} Hz — the mapped pole is unstable. Use a "
            "larger tau or a higher post-decimation audio rate.")
    k = math.tan(arg)
    b0 = k / (1.0 + k)
    a1 = (k - 1.0) / (k + 1.0)
    return (b0, b0), (1.0, a1)


class FmChannelizer(nn.Module):
    """C-channel FM receiver on torch tensors.

    State: (n0 int32 scalar tensor, rf_tail planar (T-1,),
    disc_carry planar (C, 1), deemph_zi float32 (C, 1)).
    ``step(state, rf)`` takes a planar (N,) block with N % decimation == 0
    and returns (state', audio (C, N/decimation) float32).

    ``impl``: 'auto' runs a fused CUDA kernel for a model on the card and
    the plain dense chain for a model on the CPU; on the card it takes the
    PFB front where ``pfb_preferred`` holds and the kernel takes the grid,
    else the dense front. 'torch' forces the plain dense chain; 'cuda'
    forces the dense kernel. 'pfb' runs the PFB front (every shift on an
    Fs/K grid with D | K): the kernel on the card, the plain PFB chain on
    the CPU; 'pfb_torch' forces the plain PFB chain. Every impl keeps the
    same state, so a stream may change impl at any block.
    ``precision``: the kernels' grade, as the JAX model's: 'bf16x3' (the
    default; the bank and the window, or with the PFB front the fold,
    split into bf16 high and low parts, three tensor-core passes),
    'bf16x2' (the signal's high part only, two passes) or 'f32' (FP32
    FMA). The plain chains run float32, as the JAX model's XLA path does.
    ``device`` defaults to 'cuda' and raises where CUDA is missing.
    """

    def __init__(self, sample_rate, tuning_frequency, channel_frequencies,
                 frequency_deviation, decimation, low_pass_taps,
                 deemphasis_tau=75e-6, impl="auto", precision="bf16x3",
                 device="cuda"):
        super().__init__()
        if impl not in _IMPLS:
            raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
        if precision not in GRADES:
            raise ValueError(f"precision must be one of {tuple(GRADES)}, "
                             f"got {precision!r}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "FmChannelizer: device 'cuda' requested but CUDA is not "
                "available; pass device='cpu' to run the plain chain")
        if impl == "cuda" and device.type != "cuda":
            raise ValueError("impl='cuda' runs the CUDA kernel: it needs "
                             "device='cuda'")
        self.sample_rate = float(sample_rate)
        self.tuning_frequency = float(tuning_frequency)
        self.channel_frequencies = tuple(float(f) for f in channel_frequencies)
        self.frequency_deviation = float(frequency_deviation)
        self.decimation = int(decimation)
        self.low_pass_taps = tuple(float(h) for h in low_pass_taps)
        self.deemphasis_tau = float(deemphasis_tau)
        self.impl = impl
        self.precision = precision
        self.device = device

        shifts = [self.tuning_frequency - f for f in self.channel_frequencies]
        self.register_buffer("tap_bank", torch.as_tensor(
            make_complex_tap_bank(self.low_pass_taps, shifts, self.sample_rate),
            device=device))
        self.register_buffer("lo_table", torch.as_tensor(
            phase_digit_table(shifts, self.sample_rate), device=device))
        b, a = fm_deemphasis_coeffs(self.deemphasis_tau, self.audio_rate)
        self.register_buffer("deemph", torch.tensor(
            deemphasis_triple(b, a), dtype=torch.float32, device=device))
        self.pfb_grid = select_front(
            "FmChannelizer", "fm_chain", impl, shifts, self.sample_rate,
            self.decimation, self.num_taps, device, precision)
        self.front = "toeplitz" if self.pfb_grid is None else "pfb"
        if self.pfb_grid is not None:
            k, bins = self.pfb_grid
            self.register_buffer("poly_taps", torch.as_tensor(
                _poly_taps(self.low_pass_taps, k), device=device))
            self.register_buffer("dft_bank", torch.as_tensor(
                _dft_bank_stacked(bins, k), device=device))

    @property
    def num_channels(self):
        return len(self.channel_frequencies)

    @property
    def num_taps(self):
        return len(self.low_pass_taps)

    @property
    def gain(self):
        """Discriminator gain Fs/(2*pi*deviation)."""
        return self.sample_rate / (_TWO_PI * self.frequency_deviation)

    @property
    def audio_rate(self):
        return self.sample_rate / self.decimation

    def init(self, first_sample_index=0):
        c, t = self.num_channels, self.num_taps
        dev = self.tap_bank.device
        fs = int(round(self.sample_rate))
        return (
            torch.tensor(int(first_sample_index) % fs, dtype=torch.int32,
                         device=dev),
            ComplexArray.zeros((t - 1,), device=dev),
            ComplexArray.zeros((c, 1), device=dev),
            torch.zeros((c, 1), dtype=torch.float32, device=dev),
        )

    def step(self, state, rf):
        if not isinstance(rf, ComplexArray):
            rf = ComplexArray.from_complex(rf, device=self.tap_bank.device)
        n0, rf_tail, disc_carry, deemph_zi = state
        n = rf.shape[-1]
        t = self.num_taps
        fs = int(round(self.sample_rate))
        if n % self.decimation != 0:
            raise ValueError("block length must be a multiple of decimation")

        # window j starts at global index n0 - (T-1) + j*D
        buf = ComplexArray(torch.cat([rf_tail.re, rf.re], dim=-1),
                           torch.cat([rf_tail.im, rf.im], dim=-1))
        rot0 = torch.remainder(n0 + (fs - (t - 1) % fs), fs).to(torch.int32)
        back = (self.lo_table, rot0, self.decimation, self.gain, self.deemph,
                disc_carry, deemph_zi)
        # the plain chains run float32 at any grade, as JAX's XLA path
        plain = self.impl in ("torch", "pfb_torch") or not buf.re.is_cuda
        precision = "f32" if plain else self.precision
        if self.front == "pfb":
            chain = pfb_fm_chain_reference if plain else pfb_fm_chain
            audio, new_carry, new_zi = chain(
                buf, self.poly_taps, self.dft_bank, t, *back,
                precision=precision)
        else:
            chain = fm_chain_reference if plain else fm_chain
            audio, new_carry, new_zi = chain(buf, self.tap_bank, *back,
                                             precision=precision)
        new_tail = buf[..., buf.shape[-1] - (t - 1):]
        n0_new = torch.remainder(n0 + n % fs, fs).to(torch.int32)
        return (n0_new, new_tail, new_carry, new_zi), audio

    def forward(self, state, rf):
        return self.step(state, rf)
