"""Ops of the port's first slice (counterparts of gsdr_tpu.ops)."""

from gsdr_tpu_torch.ops.channelize import (
    channelize,
    make_complex_tap_bank,
    mix_fir_decimate_bank,
    rotate_bank,
)
from gsdr_tpu_torch.ops.iir import iir, iir_block, iir_reference
from gsdr_tpu_torch.ops.quad_demod import quad_am_demod, quad_fm_demod
