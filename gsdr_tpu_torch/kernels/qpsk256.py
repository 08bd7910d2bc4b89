"""QPSK256 nearest-neighbour demodulator: the Hopper kernel, its wrapper
and its plain version.

Counterpart of ``gsdr_tpu/kernels/qpsk256_pallas.py``
(``qpsk256_demodulate_pallas``). For planar samples x (..., N) and a
256-point planar table it returns the int32 index (..., N) of the nearest
point, argmin_i |c_i|^2 - 2 (c_i.re x.re + c_i.im x.im), the lowest index
winning ties. ``qpsk256_kernel`` launches ``csrc/qpsk256.cu`` for CUDA
tensors and takes the plain version, ``qpsk256_reference`` (the score
matrix as one full-float32 matmul, then ``torch.argmin``), only for
tensors on the CPU. Both take |c|^2 as the float32 re*re + im*im of the
same table planes (the kernel with its roundings pinned), bit for bit.
"""

import ctypes
import functools

import torch

from gsdr_tpu_torch.kernels.chain import (
    ChainKernel,
    check_operands,
    cuda_error,
    load_chain_library,
)
from gsdr_tpu_torch.utils.precision import full_f32

NUM_POINTS = 256


def score_table(constellation):
    """(ct (2, 256), c2 (256,)): the planar table stacked, and |c|^2 as the
    float32 re*re + im*im."""
    re, im = constellation.re, constellation.im
    return torch.stack([re, im]), re * re + im * im


def qpsk256_reference(x, constellation):
    """The plain version: scores c2 - 2 (x @ ct) for all 256 points in one
    matmul, then the first minimum; int32 indices shaped like x."""
    ct, c2 = score_table(constellation)
    xf = torch.stack([x.re.reshape(-1), x.im.reshape(-1)], dim=-1)   # (N, 2)
    with full_f32():
        cross = torch.matmul(xf, ct)                                 # (N, 256)
    best = torch.argmin(c2[None, :] - 2.0 * cross, dim=-1)
    return best.to(torch.int32).reshape(x.re.shape)


@functools.lru_cache(maxsize=None)
def _library():
    """The built qpsk256 library, its launch signature declared."""
    lib = load_chain_library("qpsk256")
    p = ctypes.c_void_p
    lib.qpsk256_launch.argtypes = [p] * 5 + [ctypes.c_long, p]
    lib.qpsk256_launch.restype = ctypes.c_int
    return lib


def _launch(x, constellation):
    dev = x.re.device
    shape = tuple(x.re.shape)
    check_operands("qpsk256", {
        "x.re": (x.re, shape), "x.im": (x.im, shape),
        "constellation.re": (constellation.re, (NUM_POINTS,)),
        "constellation.im": (constellation.im, (NUM_POINTS,))}, dev)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    n = out.numel()
    if n == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _library().qpsk256_launch(
            x.re.data_ptr(), x.im.data_ptr(), constellation.re.data_ptr(),
            constellation.im.data_ptr(), out.data_ptr(), n, stream)
    cuda_error("qpsk256", "qpsk256 kernel launch", err)
    return out


qpsk256_kernel = ChainKernel("qpsk256", qpsk256_reference, _launch)
