"""Ops of the port (counterparts of gsdr_tpu.ops)."""

from gsdr_tpu_torch.ops.am import am_demod
from gsdr_tpu_torch.ops.arithmetic import (
    absolute,
    add_const,
    add_to_magnitude,
    magnitude,
    multiply,
)
from gsdr_tpu_torch.ops.channelize import (
    channelize,
    make_complex_tap_bank,
    mix_fir_decimate_bank,
    rotate_bank,
)
from gsdr_tpu_torch.ops.conversion import int8_to_norm_float
from gsdr_tpu_torch.ops.fir import fir, fir_output_length
from gsdr_tpu_torch.ops.fm import fm_demod, fm_demod_gain
from gsdr_tpu_torch.ops.iir import (
    iir,
    iir_block,
    iir_reference,
    iir_sos,
    iir_sos_block,
)
from gsdr_tpu_torch.ops.mixer import freq_shift, lo_signal
from gsdr_tpu_torch.ops.pfb import (
    mix_fir_decimate_bank_uniform,
    pfb_channelize,
    pfb_channelize_block,
    pfb_preferred,
    pfb_synthesize,
    pfb_synthesize_block,
    pfb_taps_to_polyphase,
    uniform_grid,
)
from gsdr_tpu_torch.ops.qpsk import (
    pack_2bit_symbols,
    qpsk_constellation,
    qpsk_demodulate,
    qpsk_demodulate_symbols,
    qpsk_modulate,
    qpsk_modulate_symbols,
    unpack_2bit_symbols,
)
from gsdr_tpu_torch.ops.qpsk256 import (
    qpsk256_constellation,
    qpsk256_demodulate,
    qpsk256_demodulate_circular,
    qpsk256_demodulate_rect,
    qpsk256_modulate,
    qpsk256_modulate_circular,
    qpsk256_modulate_rect,
)
from gsdr_tpu_torch.ops.quad_demod import quad_am_demod, quad_fm_demod
from gsdr_tpu_torch.ops.resample import (
    ResampleStream,
    design_resampler_taps,
    resample,
)
from gsdr_tpu_torch.ops.trig import cosine_c, cosine_f
