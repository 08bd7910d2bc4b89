"""A configuration, a traffic mix, a per-layer metric and a kind of system
(its entry, plain reference and comparison) are added as new files and
BENCHMARK.json entries, with no code edited; the command's refusals; the
capture's seeding."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, TINY_CAPTURE, TINY_FM, write_json
from sdr_bench import harness
from sdr_bench.kinds import channel_receiver as kind

DUMMY_METRIC = '''
"""dummy_blocks: the blocks the traced window stepped."""


def read(ctx):
    return float(ctx.blocks)
'''


def test_new_config_traffic_and_metric_by_name(bench_root):
    bench_dir = bench_root / "sdr_bench"
    write_json(bench_dir / "configs" / "dummy_fm.json",
               dict(TINY_FM, name="dummy_fm", num_channels=4, first_bin=-2))
    write_json(bench_dir / "traffic" / "dummy_mix.json",
               dict(TINY_CAPTURE, name="dummy_mix", block_samples=512,
                    trace_blocks=5))
    (bench_dir / "metrics" / "dummy_blocks.py").write_text(DUMMY_METRIC)
    bench = json.loads((bench_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy_fm", "source": "test",
                             "file": "sdr_bench/configs/dummy_fm.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy_fm.dummy_mix",
                               "config": "dummy_fm", "traffic": "dummy_mix",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "dummy_blocks", "unit": "blocks", "better": "higher",
        "source": "device_trace", "layer": "device", "moves": "input_msps",
        "workloads": ["dummy_fm.dummy_mix"]})
    write_json(bench_root / "BENCHMARK.json", bench)

    traced, _ = harness.run_cell("dummy_fm.dummy_mix", 5, 0.2, True,
                                 root=bench_root, device="cpu")
    assert traced["correct"]
    assert traced["metrics"]["dummy_blocks"]["value"] == 5.0
    assert "call_host_us" in traced["metrics"]
    assert list(traced)[-1] == "check"
    plain, _ = harness.run_cell("dummy_fm.dummy_mix", 5, 0.2, False,
                                root=bench_root, device="cpu")
    assert set(plain["metrics"]) == {"input_msps", "block_ms_p95",
                                     "setup_s"}
    other, _ = harness.run_cell("tiny_fm.tiny_capture", 5, 0.2, True,
                                root=bench_root, device="cpu")
    assert "dummy_blocks" not in other["metrics"]


GAIN_KIND = '''
"""A kind of system that is no receiver: a block scaled by a gain."""

import torch


def design(cfg):
    return {"gain": float(cfg["gain"])}


def block_samples(cfg, traffic):
    return int(traffic["block_samples"])


def make_ring(cfg, traffic, n, seed, device):
    g = torch.Generator(device=device).manual_seed(int(seed))
    return (torch.randn(4, n, generator=g, device=device),)


def compare(cfg, design, reference, ring, n, outputs, final, total):
    errs = [float((out - reference.scale(ring[0][b % 4], design)).abs()
                  .max()) for b, out in outputs.items()]
    return {"max_err": max(errs), "steps_off": abs(final - total)}, sum(
        e > cfg["limits"]["max_err"] for e in errs)
'''
GAIN_REFERENCE = '''
def scale(x, design):
    return x * design["gain"]
'''
GAIN_ENTRY = '''
LIBRARY = None


class Gain:
    def __init__(self, gain):
        self.gain = gain

    def init(self):
        return 0

    def step(self, state, x):
        return state + 1, x * self.gain


def build(cfg, design, device, precision):
    return Gain(design["gain"])


def counters():
    return {}


def route(model):
    return "plain"


def step(model):
    return model.step


def block(x):
    return x


def final_state(state):
    return state
'''


def test_new_kind_by_name(bench_root):
    """A system of another kind: its own kind, entry and reference files,
    and a configuration that names them; nothing else is edited."""
    bench_dir = bench_root / "sdr_bench"
    (bench_dir / "kinds" / "gain.py").write_text(GAIN_KIND)
    (bench_dir / "reference" / "gain.py").write_text(GAIN_REFERENCE)
    (bench_dir / "entries" / "gain.py").write_text(GAIN_ENTRY)
    write_json(bench_dir / "configs" / "gain2.json", {
        "name": "gain2", "kind": "gain", "entry": "gain",
        "reference": "gain", "work": "channel_receiver", "gain": 2.0,
        "precision": "f32", "limits": {"max_err": 0.0, "steps_off": 0}})
    bench = json.loads((bench_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gain2", "source": "test",
                             "file": "sdr_bench/configs/gain2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "gain2.tiny_capture",
                               "config": "gain2", "traffic": "tiny_capture",
                               "chips": 1, "why": "test"})
    write_json(bench_root / "BENCHMARK.json", bench)
    result, numbers = harness.run_cell("gain2.tiny_capture", 2**31 + 7, 0.2,
                                       False, root=bench_root, device="cpu")
    assert result["correct"], numbers
    assert set(result["check"]) == {"max_err", "steps_off"}
    assert set(result["metrics"]) == {"input_msps", "block_ms_p95",
                                      "setup_s"}


def test_capture_is_the_seeds():
    one = kind.make_ring(TINY_FM, TINY_CAPTURE, 1024, 2**31 + 99, "cpu")
    again = kind.make_ring(TINY_FM, TINY_CAPTURE, 1024, 2**31 + 99, "cpu")
    other = kind.make_ring(TINY_FM, TINY_CAPTURE, 1024, 2**31 + 100, "cpu")
    assert np.array_equal(one[0].numpy(), again[0].numpy())
    assert not np.array_equal(one[0].numpy(), other[0].numpy())
    assert one[0].shape == other[0].shape
    # each tone makes whole cycles over the ring: the replay has no seam
    ring_len = one[0].numel()
    draws = kind.channel_draws(TINY_FM, 2**31 + 99, ring_len)
    cycles = draws["tone_hz"] * ring_len / TINY_FM["sample_rate"]
    assert np.allclose(cycles, np.round(cycles))


def _run_py(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "sdr_bench/run.py", "--workload", "nfm320.capture",
         "--seed", str(2**32 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    proc = _run_py(ROOT)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "sdr_bench", tmp_path / "sdr_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""


@pytest.mark.parametrize("name", ["jax", "gsdr_tpu", "jaxlib.xla"])
def test_a_loaded_jax_module_is_found(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, object())
    assert name.split(".")[0] in harness.forbidden_modules()


def test_the_port_is_not_the_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "gsdr_tpu_torch.fake", object())
    assert "gsdr_tpu" not in harness.forbidden_modules()


def test_a_trace_with_records_twice_or_none_fails():
    from sdr_bench import trace

    window = (0.0, 100.0)
    once = [trace.Record("k", "kernel", 10.0 * i, 9.0, 7) for i in range(10)]
    other = [trace.Record("DtoH", "gpu_memcpy", 10.0 * i, 9.0, 8)
             for i in range(10)]
    trace.check_records(once + other, window)
    with pytest.raises(RuntimeError):
        trace.check_records(once + once, window)
    with pytest.raises(RuntimeError):
        trace.check_records([], window)
