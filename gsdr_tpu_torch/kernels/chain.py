"""What the port's kernel wrappers share (the fused chains ``fm_chain`` and
``am_chain``, the standalone ``channelize``, ``qpsk256`` and ``iir``).

  - ``ChainKernel``, the wrapper of one kernel entry point: it launches the
    kernel for CUDA tensors, counts the launches, and takes the plain
    version only for tensors on the CPU;
  - the operand checks made before a launch;
  - the check, also made before a launch, that a block of a front fits the
    card's shared memory. The libraries that launch a front answer it
    themselves (``<library>_fits`` in ``csrc/``), from the same geometry
    they launch with, so no copy of the geometry lives here;
  - ``select_front``, the receivers' choice between the dense and the PFB
    front, made once at construction.
"""

import ctypes
import functools

import torch

from gsdr_tpu_torch.kernels._build import load_library
from gsdr_tpu_torch.ops.pfb import pfb_preferred, uniform_grid


class ChainKernel:
    """Wrapper of one kernel entry point. ``launch(buf, *args)`` runs the
    kernel; ``plain(buf, *args)`` is its plain version, taken when the
    input ``buf`` (planar, or a real tensor) lies on the CPU. ``launches``
    counts kernel launches and nothing else."""

    def __init__(self, name, plain, launch):
        self.name = name
        self.plain = plain
        self.launch = launch
        self.launches = 0

    def __call__(self, buf, *args):
        dev = buf.device
        if dev.type == "cpu":
            return self.plain(buf, *args)
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: tensors on {dev}, need cuda or cpu")
        out = self.launch(buf, *args)
        self.launches += 1
        return out


def check_operands(fn, operands, dev):
    """Raise unless every (tensor, shape) in ``operands`` is a contiguous
    float32 tensor of that shape on ``dev``."""
    for name, (x, shape) in operands.items():
        if (x.device != dev or x.dtype != torch.float32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"{fn}: {name} must be a contiguous float32 tensor of "
                f"shape {shape} on {dev}; got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}, "
                f"contiguous={x.is_contiguous()}")


@functools.lru_cache(maxsize=None)
def load_chain_library(library):
    """The built library ``csrc/<library>.cu``, with the C signatures the
    libraries share declared: ``<library>_error_string`` and, in those that
    launch a front, ``<library>_fits``."""
    lib = load_library(library)
    if hasattr(lib, library + "_fits"):
        fits = getattr(lib, library + "_fits")
        fits.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        fits.restype = ctypes.c_int
    errs = getattr(lib, library + "_error_string")
    errs.argtypes = [ctypes.c_int]
    errs.restype = ctypes.c_char_p
    return lib


def cuda_error(library, what, err):
    """Raise a RuntimeError for a nonzero CUDA error code of ``library``."""
    if err != 0:
        lib = load_chain_library(library)
        msg = getattr(lib, library + "_error_string")(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def _block_fits(library, device_index, pfb, num_taps, k, q, decimation):
    lib = load_chain_library(library)
    fits = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = getattr(lib, library + "_fits")(
            int(pfb), num_taps, k, q, decimation, ctypes.byref(fits))
    cuda_error(library, f"{library}_fits", err)
    return bool(fits.value)


def front_supported(library, device, num_taps, decimation, k=None):
    """True when ``library``'s kernel can run this front on ``device``: the
    dense front (``k`` None), or the PFB front on the Fs/k grid. The PFB
    front needs D | k. On the card a block of the kernel must also fit the
    shared memory, its static size plus the dynamic size of this geometry
    against the device's opt-in limit; the plain chains on the CPU take any
    geometry."""
    t, d = int(num_taps), int(decimation)
    q = 0
    if k is not None:
        k = int(k)
        if k % d != 0:
            return False
        q = -(-t // k)
    device = torch.device(device)
    if device.type != "cuda":
        return True
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _block_fits(library, index, k is not None, t, k or 0, q, d)


def check_pfb_tables(fn, library, poly_taps, dft_bank, num_taps, decimation):
    """(C, K, Q) of PFB-front tables on the card, or raise on a geometry
    the kernel does not take."""
    q, k = poly_taps.shape
    c2, k2 = dft_bank.shape
    d = int(decimation)
    if k2 != 2 * k or c2 % 2 or d < 1 or k % d or q * k < int(num_taps) \
            or q != -(-int(num_taps) // k):
        raise ValueError(
            f"{fn}: poly_taps {tuple(poly_taps.shape)}, dft_bank "
            f"{tuple(dft_bank.shape)}, T={num_taps}, D={d}: need "
            f"(ceil(T/K), K) and (2C, 2K) with D | K")
    if not front_supported(library, poly_taps.device, num_taps, d, k):
        raise ValueError(
            f"{fn}: a block for K={k}, D={d}, Q={q} does not fit the "
            f"card's shared memory")
    return c2 // 2, k, q


def select_front(model, library, impl, shifts, sample_rate, decimation,
                 num_taps, device):
    """The (K, bins) grid a receiver runs its PFB front on, or None for
    the dense front; shared by FmChannelizer and AmReceiver, whose kernels
    live in ``library``.

    'pfb' and 'pfb_torch' need every shift on an Fs/K grid with D | K
    (raise otherwise), and 'pfb' on the card needs the PFB kernel to take
    the grid. 'auto' on the card takes the PFB front where ``pfb_preferred``
    returns a grid and the kernel takes it, and keeps the dense front
    otherwise; 'auto' on the CPU runs the dense plain chain, as the JAX
    models do off the TPU. A dense kernel on the card must take the
    geometry too. The choice is made once, here, before any launch.
    """
    d, t = int(decimation), int(num_taps)
    on_card = device.type == "cuda"
    if impl in ("pfb", "pfb_torch"):
        grid = uniform_grid(shifts, sample_rate, multiple_of=d)
        if grid is None:
            raise ValueError(
                f"{model}: impl={impl!r} needs every channel shift on an "
                f"Fs/K grid with D | K (Fs={sample_rate}, D={d})")
        if impl == "pfb" and not front_supported(library, device, t, d,
                                                 grid[0]):
            raise ValueError(
                f"{model}: the PFB kernel does not take K={grid[0]}, D={d}, "
                f"T={t}; use impl='pfb_torch' or the dense front")
        return grid
    if impl == "auto" and on_card:
        grid = pfb_preferred(shifts, sample_rate, d, t)
        if grid is not None and front_supported(library, device, t, d,
                                                grid[0]):
            return grid
    if impl in ("auto", "cuda") and not front_supported(library, device, t, d):
        raise ValueError(
            f"{model}: a block of the dense kernel for T={t}, D={d} does not "
            f"fit the card's shared memory; use impl='pfb' on a uniform "
            f"grid or impl='torch'")
    return None
