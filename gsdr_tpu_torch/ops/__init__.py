"""Ops of the port (counterparts of gsdr_tpu.ops)."""

from gsdr_tpu_torch.ops.channelize import (
    channelize,
    make_complex_tap_bank,
    mix_fir_decimate_bank,
    rotate_bank,
)
from gsdr_tpu_torch.ops.iir import iir, iir_block, iir_reference
from gsdr_tpu_torch.ops.pfb import (
    mix_fir_decimate_bank_uniform,
    pfb_preferred,
    pfb_taps_to_polyphase,
    uniform_grid,
)
from gsdr_tpu_torch.ops.quad_demod import quad_am_demod, quad_fm_demod
