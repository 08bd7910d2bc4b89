"""Entry: gsdr_tpu_torch's ``AmReceiver``, stepped through
``utils.compile.compile_step`` (one CUDA graph a block shape); see
``fm_channelizer.py`` for what an entry provides."""

import torch

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.pipelines.am_radio import AmReceiver
from gsdr_tpu_torch.utils.compile import compile_step

LIBRARY = "am_chain"


def build(cfg, design, device, precision):
    return AmReceiver(
        sample_rate=design["sample_rate"],
        tuning_frequency=design["tuning_frequency"],
        channel_frequencies=design["channel_frequencies"],
        decimation=design["decimation"],
        low_pass_taps=tuple(float(h) for h in design["taps"]),
        impl="auto", precision=precision, device=device)


def counters():
    from gsdr_tpu_torch.kernels.am_chain import am_chain, pfb_am_chain

    return {"am_chain": am_chain, "pfb_am_chain": pfb_am_chain}


def route(model):
    grid = model.pfb_grid[0] if model.pfb_grid is not None else None
    return f"front {model.front} K {grid} grade {model.precision}"


def step(model):
    return compile_step(model.step)


def block(re, im):
    return ComplexArray(re, im)


def final_state(state):
    """The state as numpy: n0 and the input's tail."""
    n0, tail = state
    return {"n0": int(n0), "tail": torch.complex(tail.re, tail.im).cpu()
            .numpy()}
