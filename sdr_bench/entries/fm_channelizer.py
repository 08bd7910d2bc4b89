"""Entry: gsdr_tpu_torch's ``FmChannelizer``, stepped through
``utils.compile.compile_step`` (one CUDA graph a block shape).

An entry builds the receiver from the configuration and the design, on
the port's own route (``impl="auto"``), names the one nvcc source it
needs, the launch counters of its route,
and reads the program's state back for the comparison."""

import torch

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.pipelines.fm_radio import FmChannelizer
from gsdr_tpu_torch.utils.compile import compile_step

LIBRARY = "fm_chain"


def build(cfg, design, device, precision):
    return FmChannelizer(
        sample_rate=design["sample_rate"],
        tuning_frequency=design["tuning_frequency"],
        channel_frequencies=design["channel_frequencies"],
        frequency_deviation=design["frequency_deviation"],
        decimation=design["decimation"],
        low_pass_taps=tuple(float(h) for h in design["taps"]),
        deemphasis_tau=design["deemphasis_tau"], impl="auto",
        precision=precision, device=device)


def counters():
    from gsdr_tpu_torch.kernels.fm_chain import fm_chain, pfb_fm_chain

    return {"fm_chain": fm_chain, "pfb_fm_chain": pfb_fm_chain}


def route(model):
    grid = model.pfb_grid[0] if model.pfb_grid is not None else None
    return f"front {model.front} K {grid} grade {model.precision}"


def step(model):
    return compile_step(model.step)


def block(re, im):
    return ComplexArray(re, im)


def final_state(state):
    """The state as numpy: n0, the input's tail, the discriminator's
    carried sample and the de-emphasis state."""
    n0, tail, carry, zi = state
    return {"n0": int(n0), "tail": torch.complex(tail.re, tail.im).cpu()
            .numpy(), "carry": torch.complex(carry.re, carry.im)[:, 0].cpu()
            .numpy(), "zi": zi[:, 0].cpu().numpy()}
