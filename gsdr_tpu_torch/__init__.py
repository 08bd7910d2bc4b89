"""gsdr_tpu_torch — the PyTorch/CUDA port of gsdr_tpu for NVIDIA Hopper.

Plain tensor code is PyTorch; every Pallas kernel of the JAX package
becomes a kernel written by hand for Hopper (``kernels/csrc``). Public
boundaries carry planar float32 re/im, and every streaming state has the
order, shapes and meaning of its JAX counterpart, so states move between
the packages through numpy. The package never imports JAX or gsdr_tpu.

It holds the flagship FM channelizer, the wideband uniform-grid
receivers (FmChannelizer and AmReceiver with the PFB front), the
channelized digital link (the PFB analysis and synthesis banks, the QPSK
and QPSK256 modems) and the ops they run.
"""

from gsdr_tpu_torch.carray import ComplexArray, as_planar, expj
from gsdr_tpu_torch.ops import (
    channelize,
    iir,
    iir_block,
    iir_reference,
    make_complex_tap_bank,
    mix_fir_decimate_bank,
    mix_fir_decimate_bank_uniform,
    pack_2bit_symbols,
    pfb_channelize,
    pfb_channelize_block,
    pfb_preferred,
    pfb_synthesize,
    pfb_synthesize_block,
    pfb_taps_to_polyphase,
    qpsk256_constellation,
    qpsk256_demodulate,
    qpsk256_demodulate_circular,
    qpsk256_demodulate_rect,
    qpsk256_modulate,
    qpsk256_modulate_circular,
    qpsk256_modulate_rect,
    qpsk_constellation,
    qpsk_demodulate,
    qpsk_modulate,
    qpsk_modulate_symbols,
    quad_am_demod,
    quad_fm_demod,
    rotate_bank,
    uniform_grid,
    unpack_2bit_symbols,
)
from gsdr_tpu_torch.pipelines import (
    AmReceiver,
    FmChannelizer,
    Qpsk256Modem,
    QpskModem,
    fm_deemphasis_coeffs,
)

__all__ = [
    "ComplexArray",
    "as_planar",
    "expj",
    "channelize",
    "iir",
    "iir_block",
    "iir_reference",
    "make_complex_tap_bank",
    "mix_fir_decimate_bank",
    "mix_fir_decimate_bank_uniform",
    "pfb_channelize",
    "pfb_channelize_block",
    "pfb_preferred",
    "pfb_synthesize",
    "pfb_synthesize_block",
    "pfb_taps_to_polyphase",
    "qpsk_constellation",
    "qpsk_modulate",
    "qpsk_modulate_symbols",
    "qpsk_demodulate",
    "pack_2bit_symbols",
    "unpack_2bit_symbols",
    "qpsk256_constellation",
    "qpsk256_modulate",
    "qpsk256_modulate_rect",
    "qpsk256_modulate_circular",
    "qpsk256_demodulate",
    "qpsk256_demodulate_rect",
    "qpsk256_demodulate_circular",
    "quad_am_demod",
    "quad_fm_demod",
    "rotate_bank",
    "uniform_grid",
    "AmReceiver",
    "FmChannelizer",
    "QpskModem",
    "Qpsk256Modem",
    "fm_deemphasis_coeffs",
]
