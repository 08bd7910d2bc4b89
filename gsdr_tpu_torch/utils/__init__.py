"""Host tables and helpers (counterparts of gsdr_tpu.utils)."""

from gsdr_tpu_torch.utils.phase import (
    digit_fractions,
    phase_digit_table,
    phase_fraction_from_table,
)
