"""Find a cell's pieces by name: the benchmark file, the configuration,
the traffic mix and the modules of kinds, entries, metrics, work and
plain receivers, each under the benchmark's directory.

Modules are loaded from their files, not imported by package name, so a
benchmark directory that holds more files than this one (a later cell's,
or a test's copy) finds them without any edit here.
"""

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH_FILE = "BENCHMARK.json"


def load_json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names.

    ``root`` is the directory that holds ``BENCHMARK.json``; the
    benchmark's own directory is its first ``paths`` entry."""

    def __init__(self, name, root=ROOT):
        self.root = Path(root)
        self.bench = load_json(self.root / BENCH_FILE)
        self.dir = self.root / self.bench["paths"][0]
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {BENCH_FILE}; "
                           f"cells: {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(self.root / self.config_entry["file"])
        self.traffic_name = self.workload["traffic"]
        self.traffic = load_json(self.dir / "traffic"
                                 / f"{self.traffic_name}.json")
        self.chips = int(self.workload["chips"])

    def module(self, kind, name):
        """The module ``<kind>/<name>.py`` of the benchmark's directory."""
        return load_module(self.dir / kind / f"{name}.py",
                           re.sub(r"\W", "_", f"sdr_bench_{kind}_{name}"))

    @property
    def kind(self):
        return self.module("kinds", self.config["kind"])

    @property
    def entry(self):
        return self.module("entries", self.config["entry"])

    @property
    def reference(self):
        return self.module("reference", self.config["reference"])

    @property
    def work(self):
        return self.module("work", self.config["work"])

    def end_to_end(self):
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"] if self._has(m)]

    def per_layer(self):
        """The per-layer metrics this cell reports."""
        return [m for m in self.bench["per_layer"] if self._has(m)]

    def _has(self, metric):
        return self.name in metric.get("workloads", [self.name])


_modules = {}


def load_module(path, name):
    """Load a Python file as a module, once a path."""
    path = Path(path).resolve()
    if path not in _modules:
        if not path.is_file():
            raise FileNotFoundError(f"no module file {path}")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]
