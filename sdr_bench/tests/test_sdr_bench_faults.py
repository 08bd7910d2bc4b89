"""A run with the timed path broken underneath comes out not correct:
the harness's whole flow on the CPU (the look for a card skipped) over a
tiny receiver whose entry plants one fault, under the real
configurations' limits. The control, the program at the grade below,
runs only on the card (``test_sdr_bench_control.py``)."""

import pytest

from sdr_bench import harness

FAULTY_ENTRY = '''
from pathlib import Path

import torch

from sdr_bench.registry import load_module

_real = load_module(Path(__file__).with_name("{real}.py"), "real_{real}")
LIBRARY, build, counters, route, block, final_state = (
    _real.LIBRARY, _real.build, _real.counters, _real.route, _real.block,
    _real.final_state)
FAULT = "{fault}"


def step(model):
    inner = _real.step(model)

    def faulty(state, blk):
        new_state, out = inner(state, blk)
        if FAULT == "state_unchanged":
            return state, out
        if FAULT == "half_channels":
            half = out.shape[0] // 2
            out = torch.cat([out[:half], out[:half].mean(0, keepdim=True)
                             .expand(out.shape[0] - half, -1)])
        if FAULT == "answer_altered":
            out = out.clone()
            out[0, out.shape[1] // 2] += 1.0
        return new_state, out

    return faulty
'''

FAULTS = ("state_unchanged", "half_channels", "answer_altered")
REAL = {"tiny_fm": "fm_channelizer", "tiny_am": "am_receiver"}


def _plant(root, config, fault):
    """The tiny configuration's entry, with the fault, under a new name."""
    import json

    bench_dir = root / "sdr_bench"
    name = f"faulty_{fault}_{REAL[config]}"
    (bench_dir / "entries" / f"{name}.py").write_text(
        FAULTY_ENTRY.format(real=REAL[config], fault=fault))
    path = bench_dir / "configs" / f"{config}.json"
    cfg = json.loads(path.read_text())
    cfg["entry"] = name
    path.write_text(json.dumps(cfg))


@pytest.mark.parametrize("config", sorted(REAL))
@pytest.mark.parametrize("mix", ["tiny_capture", "tiny_live"])
def test_sound_run_is_correct(bench_root, config, mix):
    result, _ = harness.run_cell(f"{config}.{mix}", 2**31 + 3, 0.2, False,
                                 root=bench_root, device="cpu")
    assert result["correct"] and result["failed"] == 0


@pytest.mark.parametrize("config", sorted(REAL))
@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(bench_root, config, fault):
    _plant(bench_root, config, fault)
    result, numbers = harness.run_cell(f"{config}.tiny_capture", 2**31 + 5,
                                       0.2, False, root=bench_root,
                                       device="cpu")
    assert not result["correct"], numbers
    assert result["failed"] >= 1
