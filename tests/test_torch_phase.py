"""Port parity: exact LO phase tables and the device phase fraction
(gsdr_tpu_torch.utils.phase against gsdr_tpu.utils.phase, JAX on CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsdr_tpu.utils import phase as jphase
from gsdr_tpu_torch.utils import phase as tphase

FREQS = [0.0, 60_000.0, -480_000.0, 123_456.789, -0.5, 999_999.0]


@pytest.mark.parametrize("fs", [1_000_000.0, 1_024_000.0, 48_000.5])
def test_phase_digit_table_array_equal(fs):
    np.testing.assert_array_equal(tphase.phase_digit_table(FREQS, fs),
                                  jphase.phase_digit_table(FREQS, fs))
    for f in FREQS:
        assert tphase.digit_fractions(f, fs) == jphase.digit_fractions(f, fs)


def test_phase_fraction_from_table_matches_jax():
    rng = np.random.default_rng(3)
    table = jphase.phase_digit_table(FREQS, 1_000_000.0)
    n = rng.integers(0, 2**31 - 1, size=(1, 4096), dtype=np.int64).astype(np.int32)
    want = np.asarray(jphase.phase_fraction_from_table(
        jnp.asarray(n), jnp.asarray(table)[:, None, :]))
    got = tphase.phase_fraction_from_table(
        torch.from_numpy(n), torch.from_numpy(table)[:, None, :]).numpy()
    assert got.shape == want.shape == (len(FREQS), 4096)
    # same float32 operation order; the tolerance only absorbs an FMA
    # contraction either compiler may apply (one rounding, < 2^-16 here)
    # and the 1.0 <-> 0.0 wrap such a rounding can flip
    diff = np.abs(got - want)
    assert np.max(np.minimum(diff, 1.0 - diff)) < 2e-5
