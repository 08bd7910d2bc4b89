"""Fixtures of the harness's tests: a copy of the benchmark directory with
tiny configurations and mixes beside the real ones, under a temporary
root with its own BENCHMARK.json, so that the CPU can drive a whole run
of the harness (the program's plain chains, the compiled step eager).

Run: ``python -m pytest -q sdr_bench/tests`` (the card tests, marked
``cuda``, skip without a card; on the card:
``python -m pytest -q -m cuda sdr_bench/tests``)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

def real_limits(config):
    """The limits a real configuration states, which the tiny ones hold."""
    return json.loads((BENCH / "configs" / f"{config}.json").read_text())[
        "limits"]


TINY_FM = {
    "name": "tiny_fm", "deployment": "a CPU test's FM receiver",
    "source": "test", "kind": "channel_receiver", "entry": "fm_channelizer",
    "reference": "fm_receiver", "work": "channel_receiver",
    "modulation": "fm", "sample_rate": 64000.0, "grid_k": 16,
    "first_bin": -4, "num_channels": 8, "frequency_deviation": 1000.0,
    "decimation": 4, "num_taps": 64, "cutoff_hz": 1500.0,
    "deemphasis_tau": 7.5e-05, "precision": "bf16x3",
    "block_multiple": 16, "carrier_amplitude": 0.125,
    "audio_error": "relative", "limits": real_limits("nfm_lmr_320"),
    "assumed": {}, "reduced": []}
TINY_AM = dict(
    TINY_FM, name="tiny_am", entry="am_receiver", reference="am_receiver",
    modulation="am", sample_rate=63984.0, carrier_amplitude=0.05,
    audio_error="absolute", limits=real_limits("airband_am_480"))
TINY_CAPTURE = {
    "name": "tiny_capture", "block_samples": 1024,
    "ring_min_bytes": 8 * 1024 * 5, "max_ahead": 2, "audio": "device",
    "span_blocks": 6, "trace_blocks": 4}
TINY_LIVE = dict(TINY_CAPTURE, name="tiny_live", audio="host",
                 host_buffers=2, block_ms=4.0)
del TINY_LIVE["block_samples"]


def write_json(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def cells(configs):
    """The tiny cells: every configuration under both tiny mixes."""
    return [{"name": f"{c}.{t}", "config": c, "traffic": t, "chips": 1,
             "why": "test"} for c in configs
            for t in ("tiny_capture", "tiny_live")]


def make_bench_root(tmp_path):
    """A root holding a copy of the benchmark directory with the tiny
    configurations and mixes, and a BENCHMARK.json of their cells beside
    the real file's metrics."""
    shutil.copytree(BENCH, tmp_path / "sdr_bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg in (TINY_FM, TINY_AM):
        write_json(tmp_path / "sdr_bench" / "configs" / f"{cfg['name']}.json",
                   cfg)
    for mix in (TINY_CAPTURE, TINY_LIVE):
        write_json(tmp_path / "sdr_bench" / "traffic" / f"{mix['name']}.json",
                   mix)
    bench = dict(real)
    bench["configs"] = [{"name": c["name"], "source": "test",
                         "file": f"sdr_bench/configs/{c['name']}.json",
                         "reduced": [], "why": "test"}
                        for c in (TINY_FM, TINY_AM)]
    bench["workloads"] = cells(["tiny_fm", "tiny_am"])
    bench["per_layer"] = [{k: v for k, v in m.items() if k != "workloads"}
                          for m in real["per_layer"]]
    write_json(tmp_path / "BENCHMARK.json", bench)
    return tmp_path


@pytest.fixture
def bench_root(tmp_path):
    return make_bench_root(tmp_path)
