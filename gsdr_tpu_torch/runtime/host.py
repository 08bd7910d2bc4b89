"""ctypes bindings of the native host runtime (``native/src/gsdr_host.h``).

Counterpart of ``gsdr_tpu/runtime/host.py``, with its own bindings of the
same C ABI and the same C++: ``kernels/_build.py`` compiles
``native/src/gsdr_host.cc`` with g++ into the port's build directory on
first use. The library runs the per-block host loops of a deployed
receiver (sample transport, overlap-save framing, int8/int16 staging,
2-bit packing) at sample rate without Python loops.

Each class and function also has a numpy version, the plain version that
the tests hold the C++ against. The runtime does not switch to it by
itself: where the library cannot be built or loaded, every entry point
raises, unless the caller passes ``native=False``.
"""

import ctypes
import functools

import numpy as np

from gsdr_tpu_torch.kernels import _build

_EAGAIN = 2  # GSDR_HOST_EAGAIN


def _declare(lib):
    c = ctypes
    fp = c.POINTER(c.c_float)
    i8p, i16p, u8p = (c.POINTER(c.c_int8), c.POINTER(c.c_int16),
                      c.POINTER(c.c_uint8))
    sigs = {
        "gsdr_ring_create": (c.c_void_p, [c.c_size_t]),
        "gsdr_ring_destroy": (None, [c.c_void_p]),
        "gsdr_ring_capacity": (c.c_size_t, [c.c_void_p]),
        "gsdr_ring_readable": (c.c_size_t, [c.c_void_p]),
        "gsdr_ring_writable": (c.c_size_t, [c.c_void_p]),
        "gsdr_ring_write": (c.c_size_t, [c.c_void_p, fp, c.c_size_t]),
        "gsdr_ring_read_planar": (c.c_size_t,
                                  [c.c_void_p, fp, fp, c.c_size_t]),
        "gsdr_framer_create": (c.c_void_p, [c.c_size_t, c.c_size_t]),
        "gsdr_framer_destroy": (None, [c.c_void_p]),
        "gsdr_framer_next": (c.c_int, [c.c_void_p, c.c_void_p, fp, fp,
                                       c.POINTER(c.c_uint64)]),
        "gsdr_int8_iq_to_planar_f32": (None, [i8p, c.c_size_t, fp, fp]),
        "gsdr_int16_iq_to_planar_f32": (None, [i16p, c.c_size_t, fp, fp]),
        "gsdr_f32_iq_to_planar": (None, [fp, c.c_size_t, fp, fp]),
        "gsdr_planar_to_f32_iq": (None, [fp, fp, c.c_size_t, fp]),
        "gsdr_unpack_2bit": (None, [u8p, c.c_size_t, u8p]),
        "gsdr_pack_2bit": (None, [u8p, c.c_size_t, u8p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(_build.build_host_library()))
    _declare(lib)
    return lib


class HostLib:
    """Access point of the raw ctypes library."""

    @staticmethod
    def get():
        """The library, built on first use; raises when it cannot be."""
        return _library()


def native_available():
    """True when the library builds and loads."""
    try:
        _library()
    except (OSError, RuntimeError):
        return False
    return True


def _lib(native):
    return _library() if native else None


def _ptr(arr, ctype=ctypes.c_float):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _pow2(n):
    return 1 << max(0, int(n) - 1).bit_length()


class RingBuffer:
    """Single-producer single-consumer ring of complex float32 samples; the
    capacity is rounded up to a power of two."""

    def __init__(self, capacity_samples, native=True):
        self._h = None
        self._lib = _lib(native)
        if self._lib is not None:
            self._h = self._lib.gsdr_ring_create(int(capacity_samples))
            if not self._h:
                raise MemoryError("gsdr_ring_create failed")
        else:
            self._capacity = _pow2(capacity_samples)
            self._buf = np.zeros(0, np.complex64)

    @property
    def native(self):
        return self._lib is not None

    @property
    def capacity(self):
        if self.native:
            return self._lib.gsdr_ring_capacity(self._h)
        return self._capacity

    @property
    def readable(self):
        if self.native:
            return self._lib.gsdr_ring_readable(self._h)
        return len(self._buf)

    def write(self, interleaved_f32):
        """Push interleaved (re, im, re, im, ...) float32; returns the
        samples accepted (fewer than given when the ring is full)."""
        x = np.ascontiguousarray(interleaved_f32, np.float32)
        n = len(x) // 2
        if self.native:
            return self._lib.gsdr_ring_write(self._h, _ptr(x), n)
        take = min(n, self._capacity - len(self._buf))
        self._buf = np.concatenate([self._buf,
                                    x[:2 * take].view(np.complex64)])
        return take

    def read_planar(self, n, out=None):
        """Pop up to n samples -> (re, im) float32. ``out``, a pair of
        contiguous float32 arrays of at least n samples, receives them in
        place of new arrays; views of the samples read are returned."""
        if out is None:
            out = (np.empty(n, np.float32), np.empty(n, np.float32))
        re, im = out
        if self.native:
            got = self._lib.gsdr_ring_read_planar(self._h, _ptr(re),
                                                  _ptr(im), n)
        else:
            got = min(n, len(self._buf))
            z, self._buf = self._buf[:got], self._buf[got:]
            re[:got], im[:got] = z.real, z.imag
        return re[:got], im[:got]

    def close(self):
        if self._h:
            self._lib.gsdr_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class Framer:
    """Overlap-save framer: (history + block_len)-sample planar blocks from
    a RingBuffer, the history tail carried. A native framer reads a native
    ring."""

    def __init__(self, block_len, history, native=True):
        self.block_len = int(block_len)
        self.history = int(history)
        self._h = None
        self._lib = _lib(native)
        if self._lib is not None:
            self._h = self._lib.gsdr_framer_create(self.block_len,
                                                   self.history)
            if not self._h:
                raise MemoryError("gsdr_framer_create failed")
        else:
            self._tail = (np.zeros(self.history, np.float32),
                          np.zeros(self.history, np.float32))
            self._next_idx = 0

    def next(self, ring):
        """(re, im, first_sample_index) of the next block, or None while
        the ring holds fewer than block_len new samples."""
        total = self.history + self.block_len
        re = np.empty(total, np.float32)
        im = np.empty(total, np.float32)
        if self._h:
            if not ring.native:
                raise ValueError("a native Framer reads a native RingBuffer")
            idx = ctypes.c_uint64()
            rc = self._lib.gsdr_framer_next(self._h, ring._h, _ptr(re),
                                            _ptr(im), ctypes.byref(idx))
            if rc == _EAGAIN:
                return None
            if rc != 0:
                raise RuntimeError(f"gsdr_framer_next failed ({rc})")
            return re, im, idx.value
        if ring.readable < self.block_len:
            return None
        ring.read_planar(self.block_len, (re[self.history:],
                                          im[self.history:]))
        re[:self.history], im[:self.history] = self._tail
        idx = self._next_idx
        self._next_idx += self.block_len
        self._tail = (re[total - self.history:].copy(),
                      im[total - self.history:].copy())
        return re, im, idx

    def close(self):
        if self._h:
            self._lib.gsdr_framer_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def _iq_to_planar(data, dtype, ctype, scale, fn, native):
    """``scale`` maps a float32 sample to its normalized value, the same
    float32 operation as the C++'s."""
    x = np.ascontiguousarray(data, dtype)
    n = len(x) // 2
    lib = _lib(native)
    if lib is None:
        v = np.maximum(np.float32(-1.0), scale(x.astype(np.float32)))
        return v[0:2 * n:2].copy(), v[1:2 * n:2].copy()
    re = np.empty(n, np.float32)
    im = np.empty(n, np.float32)
    getattr(lib, fn)(_ptr(x, ctype), n, _ptr(re), _ptr(im))
    return re, im


def int8_iq_to_planar(data, native=True):
    """int8 interleaved IQ -> (re, im) float32 planes, max(-1, x/127)."""
    return _iq_to_planar(data, np.int8, ctypes.c_int8,
                         lambda v: v / np.float32(127.0),
                         "gsdr_int8_iq_to_planar_f32", native)


def int16_iq_to_planar(data, native=True):
    """int16 interleaved IQ -> (re, im) float32 planes, max(-1, x/32767)."""
    return _iq_to_planar(data, np.int16, ctypes.c_int16,
                         lambda v: v * np.float32(1.0 / 32767.0),
                         "gsdr_int16_iq_to_planar_f32", native)


def unpack_2bit(packed, num_symbols, native=True):
    """Packed bytes -> symbol values 0..3, four a byte, LSB first."""
    b = np.ascontiguousarray(packed, np.uint8)
    lib = _lib(native)
    if lib is None:
        idx = np.arange(num_symbols)
        return ((b[idx >> 2] >> ((idx & 3) * 2)) & 0x3).astype(np.uint8)
    out = np.empty(num_symbols, np.uint8)
    lib.gsdr_unpack_2bit(_ptr(b, ctypes.c_uint8), num_symbols,
                         _ptr(out, ctypes.c_uint8))
    return out


def pack_2bit(symbols, native=True):
    """Symbol values 0..3 -> packed bytes, the last byte's unused fields
    zero."""
    s = np.ascontiguousarray(symbols, np.uint8)
    n = len(s)
    lib = _lib(native)
    if lib is None:
        sp = np.concatenate([s & 0x3, np.zeros((-n) % 4, np.uint8)])
        grp = sp.reshape(-1, 4)
        return (grp[:, 0] | (grp[:, 1] << 2) | (grp[:, 2] << 4)
                | (grp[:, 3] << 6)).astype(np.uint8)
    out = np.empty((n + 3) // 4, np.uint8)
    lib.gsdr_pack_2bit(_ptr(s, ctypes.c_uint8), n,
                       _ptr(out, ctypes.c_uint8))
    return out
