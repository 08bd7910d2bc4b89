"""Standalone channelizer: the Hopper kernel, its wrapper and its plain
version.

Counterpart of ``gsdr_tpu/kernels/channelize_pallas.py``
(``mix_fir_decimate_bank_pallas``): a planar 1-D x (N,) through a
(2C, 2, T) complex tap bank, decimated by D, to the un-rotated planar
(C, M), M = (N - T)//D + 1. ``channelize_kernel`` launches
``csrc/channelize.cu`` for CUDA tensors at any T and D, its taps staged in
chunks where the whole bank does not fit a block (``chain.dense_chunk``),
and takes the plain version, ``channelize_reference``, only for tensors
on the CPU. Both take the
TPU kernel's grades (``precision``): 'bf16x3', the kernel's default as it
is ``mix_fir_decimate_bank_pallas``'s, and 'bf16x2' run on the tensor
cores, 'f32' on the FP32 FMAs; the plain version emulates the grade
(``chain.graded_bank_front``: strided ``F.conv1d`` passes in full
float32) and defaults to 'f32' (``chain.ChainKernel`` says why).
"""

import ctypes
import functools

import torch

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.kernels.chain import (
    ChainKernel,
    check_operands,
    cuda_error,
    dense_chunk,
    dense_f32_tables,
    dense_mma_tables,
    grade_code,
    graded_bank_front,
    load_chain_library,
)


def channelize_reference(x, tap_bank, decimation, precision="f32"):
    """The plain version at a grade; at 'f32' it is
    ``mix_fir_decimate_bank(impl='torch')``."""
    return graded_bank_front(x, tap_bank, decimation, precision)


@functools.lru_cache(maxsize=None)
def _library():
    """The built channelize library, its launch signature declared."""
    lib = load_chain_library("channelize")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.channelize_launch.argtypes = [p] * 6 + [i] * 7 + [p]
    lib.channelize_launch.restype = i
    return lib


def _launch(x, tap_bank, decimation, precision="bf16x3", chunk=None):
    dev = x.re.device
    grade = grade_code("channelize", precision)
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
    c = c2 // 2
    m = (n - t) // d + 1
    tc = dense_chunk("channelize", dev, t, d, precision, num_channels=c,
                     num_outputs=m) if chunk is None else int(chunk)
    y_re = torch.empty((c, m), dtype=torch.float32, device=dev)
    y_im = torch.empty((c, m), dtype=torch.float32, device=dev)
    table = dense_mma_tables(tap_bank) if grade \
        else dense_f32_tables(tap_bank)
    ftab, btab = (None, table.data_ptr()) if grade \
        else (table.data_ptr(), None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _library().channelize_launch(
            x.re.data_ptr(), x.im.data_ptr(), ftab, btab,
            y_re.data_ptr(), y_im.data_ptr(), n, c, t, tc, d, m, grade,
            stream)
    cuda_error("channelize", "channelize kernel launch", err)
    return ComplexArray(y_re, y_im)


channelize_kernel = ChainKernel("channelize", channelize_reference, _launch)
