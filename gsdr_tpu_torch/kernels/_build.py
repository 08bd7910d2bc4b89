"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface, under ``build/gsdr_tpu_torch/`` at the repository
root. The file name carries a hash of the sources, so an edited kernel is
rebuilt and an unchanged one is loaded as it is. ``build_all`` starts one
nvcc for every source at once. A failed build raises with nvcc's stderr.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gsdr_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_loaded = {}


def nvcc_path():
    """nvcc on PATH, else the CUDA toolkit's default location."""
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _digest(name):
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name):
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def nvcc_command(name, out_path):
    """The nvcc command line that builds ``csrc/<name>.cu`` into out_path."""
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{CSRC}",
            "-o", str(out_path), str(CSRC / f"{name}.cu")]


def sources():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names=None):
    """Compile every source not yet built, one nvcc each, all at once.

    Returns {name: ptxas report} for the sources compiled by this call.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names or sources():
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), tmp, out)
    reports = {}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{stderr}{stdout}")
            continue
        os.replace(tmp, out)
        reports[name] = stderr
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def load_library(name):
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        build_all([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
