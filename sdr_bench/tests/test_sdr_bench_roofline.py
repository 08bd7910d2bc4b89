"""The roofline's counts against values worked by hand at the NFM and
airband shapes, and the block lengths of the mixes."""

import json

import pytest

from conftest import BENCH
from sdr_bench import roofline, registry
from sdr_bench.kinds import channel_receiver as kind

H100 = roofline.peaks("NVIDIA H100 80GB HBM3")


def _cfg(name):
    return registry.load_json(BENCH / "configs" / f"{name}.json")


def _work(name, n, grade="bf16x3"):
    cfg = _cfg(name)
    return registry.load_module(BENCH / "work" / f"{cfg['work']}.py",
                                "work_under_test").counts(cfg, n, grade)


# NFM at 983,040 samples: C = 320, T = 2560, D = 160, K = 640, M = 6144
#   bytes: block 8 * 983040 = 7,864,320; state (8 * 2559 + 4 + 12 * 320)
#   = 24,316 in and out; audio 4 * 320 * 6144 = 7,864,320; taps 10,240
#   fp32 an output: 4 * 2560 + 5 * 640 * log2(640) (29,830.2, under
#   8 * 320 * 640 = 1,638,400) + 16 * 320
# airband at 983,040: C = 480, T = 3840, D = 240, K = 960, M = 4096
#   state 8 * 3839 + 4 = 30,716; audio 4 * 480 * 4096 = 7,864,320
@pytest.mark.parametrize("name, n, nbytes, fp32_per_out, m, bound_us", [
    ("nfm_lmr_320", 983040, 15_787_512, 10_240 + 29_830.16990 + 5_120,
     6144, 4.71269),
    ("airband_am_480", 983040, 15_805_432, 15_360 + 47_553.07486 + 3_840,
     4096, 4.71804),
    ("nfm_lmr_320", 160000, 2_618_872, 10_240 + 29_830.16990 + 5_120,
     1000, 0.78175),
])
def test_counts_by_hand(name, n, nbytes, fp32_per_out, m, bound_us):
    work = _work(name, n)
    assert work["bytes"] == nbytes
    assert work["fp32_flops"] == pytest.approx(fp32_per_out * m, rel=1e-6)
    bound, by = roofline.bound_s(work, H100)
    assert by == "bytes"
    assert bound * 1e6 == pytest.approx(bound_us, rel=1e-4)


def test_tensor_passes_follow_the_grade():
    c, k, m = 320, 640, 6144
    for grade, passes in (("bf16x3", 3), ("bf16x2", 2)):
        tensor = _work("nfm_lmr_320", 983040, grade)["tensor"]
        assert min(t for t, _ in tensor) == passes * 8 * c * k * m
    assert _work("nfm_lmr_320", 983040, "f32")["tensor"] == []


def test_a_card_without_peaks_reads_no_roofline():
    assert roofline.peaks("no such card") is None


@pytest.mark.parametrize("config, mix, samples", [
    ("nfm_lmr_320", "capture", 983040), ("airband_am_480", "capture", 983040),
    ("nfm_lmr_320", "live20ms", 160000),
    ("airband_am_480", "live20ms", 160320)])
def test_block_lengths(config, mix, samples):
    traffic = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    assert kind.block_samples(_cfg(config), traffic) == samples
