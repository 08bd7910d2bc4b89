"""The control on the card: each cell at its own size, a short window,
the program at the configuration's grade comes out correct and at the
grade below (``control.GRADE_BELOW``) not correct. Marked ``cuda``; on
the card: ``python -m pytest -q -m cuda sdr_bench/tests``."""

import pytest

CELLS = ("nfm320.capture", "airband480.capture", "nfm320.live20ms",
         "airband480.live20ms")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from sdr_bench import control, harness, registry

    grade = registry.Cell(cell).config["precision"]
    seed = 2**32 + 11
    sound, _ = harness.run_cell(cell, seed, 1.0, False)
    low, numbers = harness.run_cell(cell, seed, 1.0, False,
                                    grade=control.GRADE_BELOW[grade])
    assert sound["correct"]
    assert not low["correct"], numbers
