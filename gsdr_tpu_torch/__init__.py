"""gsdr_tpu_torch — the PyTorch/CUDA port of gsdr_tpu for NVIDIA Hopper.

Plain tensor code is PyTorch; every Pallas kernel of the JAX package
becomes a kernel written by hand for Hopper (``kernels/csrc``). Public
boundaries carry planar float32 re/im, and every streaming state has the
order, shapes and meaning of its JAX counterpart, so states move between
the packages through numpy. The package never imports JAX or gsdr_tpu.

It holds the flagship FM channelizer, the wideband uniform-grid
receivers (FmChannelizer and AmReceiver with the PFB front) and the ops
they run.
"""

from gsdr_tpu_torch.carray import ComplexArray, expj
from gsdr_tpu_torch.ops import (
    channelize,
    iir,
    iir_block,
    iir_reference,
    make_complex_tap_bank,
    mix_fir_decimate_bank,
    mix_fir_decimate_bank_uniform,
    pfb_preferred,
    pfb_taps_to_polyphase,
    quad_am_demod,
    quad_fm_demod,
    rotate_bank,
    uniform_grid,
)
from gsdr_tpu_torch.pipelines import (
    AmReceiver,
    FmChannelizer,
    fm_deemphasis_coeffs,
)

__all__ = [
    "ComplexArray",
    "expj",
    "channelize",
    "iir",
    "iir_block",
    "iir_reference",
    "make_complex_tap_bank",
    "mix_fir_decimate_bank",
    "mix_fir_decimate_bank_uniform",
    "pfb_preferred",
    "pfb_taps_to_polyphase",
    "quad_am_demod",
    "quad_fm_demod",
    "rotate_bank",
    "uniform_grid",
    "AmReceiver",
    "FmChannelizer",
    "fm_deemphasis_coeffs",
]
