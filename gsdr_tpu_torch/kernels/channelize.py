"""Standalone channelizer: the Hopper kernel, its wrapper and its plain
version.

Counterpart of ``gsdr_tpu/kernels/channelize_pallas.py``
(``mix_fir_decimate_bank_pallas``): a planar 1-D x (N,) through a
(2C, 2, T) complex tap bank, decimated by D, to the un-rotated planar
(C, M), M = (N - T)//D + 1. ``channelize_kernel`` launches
``csrc/channelize.cu`` for CUDA tensors, raising where a block of the
kernel does not fit the card's shared memory, and takes the plain version,
``channelize_reference`` (the strided ``F.conv1d`` in full float32), only
for tensors on the CPU. The TPU kernel's default bf16x3 grade has no
counterpart: the kernel runs float32 FMAs.
"""

import ctypes
import functools

import torch

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.kernels.chain import (
    ChainKernel,
    check_operands,
    cuda_error,
    front_supported,
    load_chain_library,
)
from gsdr_tpu_torch.ops.channelize import mix_fir_decimate_bank


def channelize_reference(x, tap_bank, decimation):
    """The plain version: ``mix_fir_decimate_bank(impl='torch')``."""
    return mix_fir_decimate_bank(x, tap_bank, decimation, impl="torch")


@functools.lru_cache(maxsize=None)
def _library():
    """The built channelize library, its launch signature declared."""
    lib = load_chain_library("channelize")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.channelize_launch.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.channelize_launch.restype = i
    return lib


def _launch(x, tap_bank, decimation):
    dev = x.re.device
    if x.re.ndim != 1:
        raise ValueError(f"channelize: the kernel takes a 1-D x, got shape "
                         f"{tuple(x.re.shape)}")
    n = x.re.shape[0]
    if tap_bank.ndim != 3 or tap_bank.shape[1] != 2 or tap_bank.shape[0] % 2:
        raise ValueError(f"channelize: tap_bank shape {tuple(tap_bank.shape)}"
                         f", need (2C, 2, T)")
    c2, _, t = tap_bank.shape
    check_operands("channelize", {"x.re": (x.re, (n,)), "x.im": (x.im, (n,)),
                                  "tap_bank": (tap_bank, (c2, 2, t))}, dev)
    d = int(decimation)
    if d < 1 or n < t:
        raise ValueError(f"channelize: N={n} < T={t} or D={d} < 1")
    if not front_supported("channelize", dev, t, d):
        raise ValueError(f"channelize: a block for T={t}, D={d} does not fit "
                         f"the card's shared memory")
    m = (n - t) // d + 1
    c = c2 // 2
    y_re = torch.empty((c, m), dtype=torch.float32, device=dev)
    y_im = torch.empty((c, m), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _library().channelize_launch(
            x.re.data_ptr(), x.im.data_ptr(), tap_bank.data_ptr(),
            y_re.data_ptr(), y_im.data_ptr(), n, c, t, d, m, stream)
    cuda_error("channelize", "channelize kernel launch", err)
    return ComplexArray(y_re, y_im)


channelize_kernel = ChainKernel("channelize", channelize_reference, _launch)
