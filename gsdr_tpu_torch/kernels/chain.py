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
  - the grades of the dense front (``GRADES``): 'f32' on the FP32 FMAs,
    'bf16x3' and 'bf16x2' on the tensor cores, as the JAX package's
    kernels define them; the bf16 split of the taps and the window
    (``split_bf16``), the tensor-core front's tap table
    (``dense_mma_tables``) and the plain version of the front at each
    grade (``graded_bank_front``);
  - ``select_front``, the receivers' choice between the dense and the PFB
    front, made once at construction.
"""

import ctypes
import functools

import torch
from torch.utils.weak import WeakIdKeyDictionary

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.kernels._build import load_library
from gsdr_tpu_torch.ops.channelize import mix_fir_decimate_bank
from gsdr_tpu_torch.ops.pfb import pfb_preferred, uniform_grid

# The dense front's grades and their codes in the C interface: the number
# of tensor-core passes, 0 for the FP32-FMA front.
GRADES = {"f32": 0, "bf16x2": 2, "bf16x3": 3}


class ChainKernel:
    """Wrapper of one kernel entry point. ``launch(buf, *args, **kw)`` runs
    the kernel; ``plain(buf, *args, **kw)`` is its plain version, taken
    when the input ``buf`` (planar, or a real tensor) lies on the CPU.
    Each takes the defaults of its own signature: the dense wrappers
    (``fm_chain``, ``channelize_kernel``) launch at 'bf16x3', the JAX
    kernels' default grade, and their plain versions run 'f32', as the
    models do on the CPU (the JAX package's XLA path); a caller who wants
    the same grade on both passes ``precision``. ``launches`` counts kernel
    launches and nothing else."""

    def __init__(self, name, plain, launch):
        self.name = name
        self.plain = plain
        self.launch = launch
        self.launches = 0

    def __call__(self, buf, *args, **kwargs):
        dev = buf.device
        if dev.type == "cpu":
            return self.plain(buf, *args, **kwargs)
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: tensors on {dev}, need cuda or cpu")
        out = self.launch(buf, *args, **kwargs)
        self.launches += 1
        return out


def grade_code(fn, precision):
    """The C interface's code of a dense-front grade; raise for another."""
    if precision not in GRADES:
        raise ValueError(f"{fn}: precision must be one of {tuple(GRADES)}, "
                         f"got {precision!r}")
    return GRADES[precision]


def split_bf16(x):
    """(hi, lo) bfloat16 parts of a float32 tensor, both rounded to nearest
    even: hi = bf16(x), lo = bf16(x - hi). The JAX package's split of the
    taps (``_split_g``) and of the window (``_window_dot``)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def graded_bank_front(x, tap_bank, decimation, precision="f32"):
    """The plain version of the dense front at a grade: planar (N,) x
    through the (2C, 2, T) bank to the un-rotated planar (C, M).

    'f32' is ``mix_fir_decimate_bank(impl='torch')``. 'bf16x3' splits the
    taps and the window as the kernels do (``split_bf16``) and sums three
    full-float32 convolutions of the bf16-valued planes, gh*xh + gl*xh +
    gh*xl, in the JAX package's order; 'bf16x2' the first two. Every
    product of two bf16 values is exact in float32, so this equals the
    grade up to summation order."""
    grade_code("graded_bank_front", precision)
    if precision == "f32":
        return mix_fir_decimate_bank(x, tap_bank, decimation, impl="torch")
    gh, gl = (p.float() for p in split_bf16(tap_bank))
    (xh_re, xl_re), (xh_im, xl_im) = split_bf16(x.re), split_bf16(x.im)
    xh = ComplexArray(xh_re.float(), xh_im.float())
    passes = [(xh, gh), (xh, gl)]
    if precision == "bf16x3":
        passes.append((ComplexArray(xl_re.float(), xl_im.float()), gh))
    y = None
    for xs, g in passes:
        p = mix_fir_decimate_bank(xs, g, decimation, impl="torch")
        y = p if y is None else ComplexArray(y.re + p.re, y.im + p.im)
    return y


_MMA_TABLES = WeakIdKeyDictionary()


def dense_mma_tables(tap_bank):
    """The tensor-core front's B operand for a (2C, 2, T) complex tap bank
    (``make_complex_tap_bank``), on its device: int32 (2, KB, NT, 16, 2),
    KB = ceil(T/8), NT = ceil(C/4), part 0 the bf16 high and part 1 the
    low parts (``split_bf16``). Entry [part][kb][nt][4*cl + q][i] is the
    (gr, -gi) pair of channel 4*nt + cl at tap 8*kb + q + 4*i, the bank's
    even row 2c, plane 0 in the low 16 bits; zero past T and C. Both bf16
    grades read it: each takes the taps high and low.

    Built once per bank tensor and kept while the tensor lives (a model's
    buffer, ``pfb_channelize``'s cached bank); rebuilt after the tensor is
    written in place. Callers must not write to it."""
    hit = _MMA_TABLES.get(tap_bank)
    if hit is not None and hit[0] == tap_bank._version:
        return hit[1]
    c2, _, t = tap_bank.shape
    kb, nt = -(-t // 8), -(-c2 // 8)
    w = torch.zeros((4 * nt, 8 * kb, 2), dtype=torch.float32,
                    device=tap_bank.device)
    w[:c2 // 2, :t] = tap_bank[0::2].transpose(1, 2)
    parts = []
    for part in split_bf16(w):
        words = part.contiguous().view(torch.int32).reshape(nt, 4, kb, 2, 4)
        parts.append(words.permute(2, 0, 1, 4, 3).reshape(kb, nt, 16, 2))
    table = torch.stack(parts).contiguous()
    _MMA_TABLES[tap_bank] = (tap_bank._version, table)
    return table


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
    launch a front, ``<library>_fits(pfb, grade, C, T, K, Q, D, *fits)``."""
    lib = load_library(library)
    if hasattr(lib, library + "_fits"):
        fits = getattr(lib, library + "_fits")
        fits.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
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
def _block_fits(library, device_index, pfb, grade, channels, num_taps, k, q,
                decimation):
    lib = load_chain_library(library)
    fits = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = getattr(lib, library + "_fits")(
            int(pfb), grade, channels, num_taps, k, q, decimation,
            ctypes.byref(fits))
    cuda_error(library, f"{library}_fits", err)
    return bool(fits.value)


def front_supported(library, device, num_taps, decimation, k=None,
                    precision="f32", num_channels=None):
    """True when ``library``'s kernel can run this front on ``device``: the
    dense front (``k`` None) at the grade ``precision``, or the PFB front
    on the Fs/k grid (f32 at any grade). The PFB front needs D | k. On the
    card a block of the kernel must also fit the shared memory, its static
    size plus the dynamic size of this geometry and grade against the
    device's opt-in limit; the plain chains on the CPU take any geometry.
    ``num_channels`` is the bank's C, on which the channelizer's block
    depends at the bf16 grades (None: any C, the widest block). A library
    without the grade raises."""
    grade = grade_code(library, precision)
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
    return _block_fits(library, index, k is not None, grade,
                       int(num_channels or 0), t, k or 0, q, d)


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
                 num_taps, device, precision="f32"):
    """The (K, bins) grid a receiver runs its PFB front on, or None for
    the dense front; shared by FmChannelizer and AmReceiver, whose kernels
    live in ``library``.

    'pfb' and 'pfb_torch' need every shift on an Fs/K grid with D | K
    (raise otherwise), and 'pfb' on the card needs the PFB kernel to take
    the grid. 'auto' on the card takes the PFB front where ``pfb_preferred``
    returns a grid and the kernel takes it, and keeps the dense front
    otherwise; 'auto' on the CPU runs the dense plain chain, as the JAX
    models do off the TPU. A dense kernel on the card must take the
    geometry at the model's grade ``precision`` too. The choice is made
    once, here, before any launch.
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
    if impl in ("auto", "cuda") and not front_supported(
            library, device, t, d, precision=precision):
        raise ValueError(
            f"{model}: a block of the dense kernel for T={t}, D={d} at "
            f"precision={precision!r} does not fit the card's shared memory; "
            f"use impl='pfb' on a uniform grid or impl='torch'")
    return None
