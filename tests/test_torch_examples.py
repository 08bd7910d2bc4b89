"""The port's examples run end to end on the CPU (``main(['--cpu'])``
returns 0): the FM broadcast receiver with its checkpoint, the 32-channel
wideband receiver, the wideband duplex loopback and the QPSK links."""

import importlib

import pytest

EXAMPLES = ["fm_broadcast_rx", "wideband_rx", "wideband_duplex", "qpsk_link",
            "qpsk_transmux"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_cpu(name, capsys):
    mod = importlib.import_module(f"gsdr_tpu_torch.examples.{name}")
    assert mod.main(["--cpu"]) == 0, capsys.readouterr().out


def test_wideband_rx_pfb_on_cpu():
    """--pfb runs the plain PFB chain on the CPU."""
    from gsdr_tpu_torch.examples import wideband_rx

    assert wideband_rx.main(["--cpu", "--pfb"]) == 0


def test_qpsk_link_matches_jax_example(capsys):
    """The same seeded draws give the JAX example's BER and SER lines."""
    import runpy
    import sys
    from pathlib import Path

    from gsdr_tpu_torch.examples import qpsk_link

    assert qpsk_link.main(["--cpu"]) == 0
    ours = [ln for ln in capsys.readouterr().out.splitlines()
            if "SNR" in ln]
    root = Path(__file__).resolve().parents[1]
    argv = sys.argv
    sys.argv = [str(root / "examples" / "qpsk_link.py"), "--cpu"]
    try:
        runpy.run_path(str(root / "examples" / "qpsk_link.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv
    theirs = [ln for ln in capsys.readouterr().out.splitlines()
              if "SNR" in ln]
    assert ours == theirs and len(ours) == 7
