"""The port stands alone: no JAX, no gsdr_tpu, no silent CPU fallback,
and an sm_90a build command."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gsdr_tpu_torch.kernels import _build
from gsdr_tpu_torch.pipelines import FmChannelizer

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "gsdr_tpu_torch"
CFG = dict(sample_rate=1e6, tuning_frequency=0.0,
           channel_frequencies=(100e3, 200e3), frequency_deviation=75e3,
           decimation=4, low_pass_taps=(0.25, 0.25, 0.25, 0.25))


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, gsdr_tpu_torch, gsdr_tpu_torch.utils.convert, "
            "gsdr_tpu_torch.kernels._build; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gsdr_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT) for p in
                                        list(PORT.rglob("*.py"))
                                        + [ROOT / "chip_smoke.py"]),
                         ids=str)
def test_no_jax_or_gsdr_tpu_import(path):
    assert not _imported_roots(ROOT / path) & {"jax", "jaxlib", "gsdr_tpu"}


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FmChannelizer(**CFG)


def test_impl_checks():
    with pytest.raises(ValueError, match="impl='cuda'"):
        FmChannelizer(**CFG, impl="cuda", device="cpu")
    # the PFB impls are the port's names; the JAX name 'pfb_pallas' maps
    # to 'pfb' in utils/convert.py and is no impl of the model
    for impl in ("pfb", "pfb_torch"):
        assert FmChannelizer(**CFG, impl=impl, device="cpu").front == "pfb"
    with pytest.raises(ValueError, match="impl must be"):
        FmChannelizer(**CFG, impl="pfb_pallas", device="cpu")
    # the JAX package's grades construct, bf16x3 by default as in JAX
    assert FmChannelizer(**CFG, device="cpu").precision == "bf16x3"
    for grade in ("bf16x3", "bf16x2", "f32"):
        assert FmChannelizer(**CFG, precision=grade,
                             device="cpu").precision == grade
    with pytest.raises(ValueError, match="precision must be"):
        FmChannelizer(**CFG, precision="bf16", device="cpu")
    with pytest.raises(ValueError):
        FmChannelizer(**CFG, impl="xla", device="cpu")


def test_nvcc_command_targets_sm_90a():
    out = _build.library_path("fm_chain")
    cmd = _build.nvcc_command("fm_chain", out)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-std=c++17", "-O3", "-shared", "-fPIC"} <= set(cmd)
    assert cmd[-1].endswith("csrc/fm_chain.cu") and Path(cmd[-1]).exists()
    assert out.parent == ROOT / "build" / "gsdr_tpu_torch"
    assert _build.sources() == ["am_chain", "channelize", "fm_chain", "iir",
                                "qpsk256"]
    # every source's digest covers the shared fronts
    assert (_build.CSRC / "fronts.cuh").exists()


def test_public_names_cover_the_jax_package():
    """Every name of gsdr_tpu.__all__ and gsdr_tpu.runtime.__all__ is in the
    port's counterpart. A subprocess reads the JAX names from the source
    text and imports only the port, so no JAX is imported here or there."""
    code = r"""
import ast, sys
from pathlib import Path

def names(path):
    tree = ast.parse(Path(path).read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    raise SystemExit(f"no __all__ in {path}")

import gsdr_tpu_torch, gsdr_tpu_torch.runtime
missing = []
for src, mod in (("gsdr_tpu/__init__.py", gsdr_tpu_torch),
                 ("gsdr_tpu/runtime/__init__.py", gsdr_tpu_torch.runtime)):
    want = names(src)
    assert len(want) > 8, want
    missing += [n for n in want
                if n not in mod.__all__ or not hasattr(mod, n)]
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "gsdr_tpu")]
print(missing, bad)
sys.exit(1 if missing or bad else 0)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_deployment_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """cosine_c, StreamRunner and fm_rx run on the card unless asked for
    the CPU: without CUDA their default device raises."""
    from gsdr_tpu_torch.ops.trig import cosine_c, cosine_f
    from gsdr_tpu_torch.runtime import StreamRunner
    from gsdr_tpu_torch.tools import fm_rx

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cosine_c(0.0, 1.0, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cosine_f(0.0, 1.0, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamRunner(lambda s, x: (s, x), None, 64)
    iq = tmp_path / "x.iq"
    iq.write_bytes(bytes(64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fm_rx.main([str(iq), "-o", str(tmp_path / "a.f32"), "--fs", "1e6",
                    "--channels", "1e5"])
    assert not (tmp_path / "a.f32").exists()
