"""gsdr_tpu_torch — the PyTorch/CUDA port of gsdr_tpu for NVIDIA Hopper.

Plain tensor code is PyTorch; every Pallas kernel of the JAX package
becomes a kernel written by hand for Hopper (``kernels/csrc``). Public
boundaries carry planar float32 re/im, and every streaming state has the
order, shapes and meaning of its JAX counterpart, so states move between
the packages through numpy. The package never imports JAX or gsdr_tpu.

This slice holds the flagship FM channelizer and the ops it runs.
"""

from gsdr_tpu_torch.carray import ComplexArray, expj
from gsdr_tpu_torch.ops import (
    channelize,
    iir,
    iir_block,
    iir_reference,
    make_complex_tap_bank,
    mix_fir_decimate_bank,
    quad_am_demod,
    quad_fm_demod,
    rotate_bank,
)
from gsdr_tpu_torch.pipelines import FmChannelizer, fm_deemphasis_coeffs

__all__ = [
    "ComplexArray",
    "expj",
    "channelize",
    "iir",
    "iir_block",
    "iir_reference",
    "make_complex_tap_bank",
    "mix_fir_decimate_bank",
    "quad_am_demod",
    "quad_fm_demod",
    "rotate_bank",
    "FmChannelizer",
    "fm_deemphasis_coeffs",
]
