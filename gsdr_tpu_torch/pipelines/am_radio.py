"""Multi-channel AM envelope receiver.

Counterpart of ``gsdr_tpu/pipelines/am_radio.py``. One wideband planar RF
stream in; C envelope-detected audio channels in [-1, 1] out:
complex-tap-bank mix + FIR + decimate (or, for channels on a uniform Fs/K
grid, the polyphase fold + DFT bank) -> LO rotor -> 2*clip(|.|, 0, 1) - 1.
The chain has no neighbour-sample dependency, so the streaming state is
just (n0, rf_tail), in the order, shapes and meaning of the JAX model.
"""

import torch
from torch import nn

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.kernels.am_chain import (
    am_chain,
    am_chain_reference,
    pfb_am_chain,
    pfb_am_chain_reference,
)
from gsdr_tpu_torch.kernels.chain import GRADES, select_front
from gsdr_tpu_torch.ops.channelize import make_complex_tap_bank
from gsdr_tpu_torch.ops.pfb import _dft_bank_stacked, _poly_taps
from gsdr_tpu_torch.utils.phase import phase_digit_table

_IMPLS = ("auto", "torch", "cuda", "pfb", "pfb_torch")


class AmReceiver(nn.Module):
    """C-channel AM envelope receiver on torch tensors.

    State: (n0 int32 scalar tensor, rf_tail planar (T-1,)).
    ``step(state, rf)`` takes a planar (N,) block with N % decimation == 0
    and returns (state', audio (C, N/decimation) float32 in [-1, 1]).

    ``impl`` as FmChannelizer's: 'auto' (a fused CUDA kernel on the card,
    PFB front where ``pfb_preferred`` holds and the kernel takes the grid,
    else dense; the plain dense chain on the CPU), 'torch' (plain dense),
    'cuda' (dense kernel, at any T and D: no dense geometry raises),
    'pfb' (PFB kernel on the card, plain PFB chain on the CPU),
    'pfb_torch' (plain PFB chain). ``precision``: the
    kernels' grade, as the JAX model's and FmChannelizer's: 'bf16x3' (the
    default), 'bf16x2' or 'f32', for either front; the plain chains run
    float32, as the JAX model's XLA path does. ``device`` defaults to
    'cuda' and raises where CUDA is missing.
    """

    def __init__(self, sample_rate, tuning_frequency, channel_frequencies,
                 decimation, low_pass_taps, impl="auto", precision="bf16x3",
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
                "AmReceiver: device 'cuda' requested but CUDA is not "
                "available; pass device='cpu' to run the plain chain")
        if impl == "cuda" and device.type != "cuda":
            raise ValueError("impl='cuda' runs the CUDA kernel: it needs "
                             "device='cuda'")
        self.sample_rate = float(sample_rate)
        self.tuning_frequency = float(tuning_frequency)
        self.channel_frequencies = tuple(float(f) for f in channel_frequencies)
        self.decimation = int(decimation)
        self.low_pass_taps = tuple(float(h) for h in low_pass_taps)
        self.impl = impl
        self.precision = precision
        self.device = device

        shifts = [self.tuning_frequency - f for f in self.channel_frequencies]
        self.register_buffer("tap_bank", torch.as_tensor(
            make_complex_tap_bank(self.low_pass_taps, shifts, self.sample_rate),
            device=device))
        self.register_buffer("lo_table", torch.as_tensor(
            phase_digit_table(shifts, self.sample_rate), device=device))
        self.pfb_grid = select_front(
            "AmReceiver", "am_chain", impl, shifts, self.sample_rate,
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
    def audio_rate(self):
        return self.sample_rate / self.decimation

    def init(self, first_sample_index=0):
        dev = self.tap_bank.device
        fs = int(round(self.sample_rate))
        return (
            torch.tensor(int(first_sample_index) % fs, dtype=torch.int32,
                         device=dev),
            ComplexArray.zeros((self.num_taps - 1,), device=dev),
        )

    def step(self, state, rf):
        if not isinstance(rf, ComplexArray):
            rf = ComplexArray.from_complex(rf, device=self.tap_bank.device)
        n0, rf_tail = state
        n = rf.shape[-1]
        t = self.num_taps
        fs = int(round(self.sample_rate))
        if n % self.decimation != 0:
            raise ValueError("block length must be a multiple of decimation")

        # window j starts at global index n0 - (T-1) + j*D
        buf = ComplexArray(torch.cat([rf_tail.re, rf.re], dim=-1),
                           torch.cat([rf_tail.im, rf.im], dim=-1))
        rot0 = torch.remainder(n0 + (fs - (t - 1) % fs), fs).to(torch.int32)
        back = (self.lo_table, rot0, self.decimation)
        # the plain chains run float32 at any grade, as JAX's XLA path
        plain = self.impl in ("torch", "pfb_torch") or not buf.re.is_cuda
        precision = "f32" if plain else self.precision
        if self.front == "pfb":
            chain = pfb_am_chain_reference if plain else pfb_am_chain
            audio = chain(buf, self.poly_taps, self.dft_bank, t, *back,
                          precision=precision)
        else:
            chain = am_chain_reference if plain else am_chain
            audio = chain(buf, self.tap_bank, *back, precision=precision)
        new_tail = buf[..., buf.shape[-1] - (t - 1):]
        n0_new = torch.remainder(n0 + n % fs, fs).to(torch.int32)
        return (n0_new, new_tail), audio

    def forward(self, state, rf):
        return self.step(state, rf)
