"""Fused FM receive chain: the Hopper kernel, its wrapper and its plain
version.

Counterpart of ``gsdr_tpu/kernels/fm_chain_pallas.py`` (``fm_chain_pallas``
with the dense front). One call runs, over a tail-prepended planar RF
buffer of Nb samples, the complex-tap-bank mix + FIR + decimate, the LO
rotor, the quadrature discriminator with its carried previous sample and
the TDF-II de-emphasis with its carried state, and returns
(audio (C, M), carry_f', carry_z') with M = (Nb - T)//D + 1 -- the state
leaves of ``FmChannelizer``, exported at the last output.

``fm_chain`` launches ``csrc/fm_chain.cu`` for CUDA tensors and takes the
plain version, ``fm_chain_reference``, only for tensors on the CPU.
"""

import ctypes

import torch

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.kernels._build import load_library
from gsdr_tpu_torch.ops.channelize import mix_fir_decimate_bank, rotate_bank
from gsdr_tpu_torch.ops.iir import iir_block
from gsdr_tpu_torch.ops.quad_demod import quad_fm_demod

_DEEMPH_BLOCK_LEN = 256


def fm_chain_reference(buf, tap_bank, lo_table, n0_rot, decimation, gain,
                       deemph, carry_f, carry_z):
    """The unfused chain, op by op, in full float32.

    Args:
      buf: planar (Nb,) RF including the (T-1)-sample history.
      tap_bank: (2C, 2, T) float32 (make_complex_tap_bank).
      lo_table: (C, 4) float32 digit-fraction table (phase_digit_table).
      n0_rot: int32 scalar tensor, global raw-sample index of window 0 mod Fs.
      decimation, gain: chain constants.
      deemph: (3,) float32 tensor (b0, cc, a) of the TDF-II de-emphasis
        z[j] = cc*d[j] + a*z[j-1], out[j] = b0*d[j] + z[j-1].
      carry_f: planar (C, 1) previous rotated sample.
      carry_z: (C, 1) de-emphasis state.
    """
    y = mix_fir_decimate_bank(buf, tap_bank, decimation)
    filt = rotate_bank(y, lo_table, n0_rot, decimation)
    disc_in = ComplexArray(torch.cat([carry_f.re, filt.re], dim=-1),
                           torch.cat([carry_f.im, filt.im], dim=-1))
    demod = quad_fm_demod(disc_in, gain)
    # contiguous, so that the state can feed the kernel on the next step
    new_carry = ComplexArray(disc_in.re[..., -1:].contiguous(),
                             disc_in.im[..., -1:].contiguous())
    b0, cc, a = deemph[0], deemph[1], deemph[2]
    b = torch.stack([b0, cc - a * b0])
    a_vec = torch.stack([torch.ones_like(a), -a])
    audio, new_zi = iir_block(b, a_vec, demod, zi=carry_z,
                              block_len=_DEEMPH_BLOCK_LEN)
    return audio, new_carry, new_zi


class FmChainKernel:
    """Wrapper of the CUDA kernel; ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def __call__(self, buf, tap_bank, lo_table, n0_rot, decimation, gain,
                 deemph, carry_f, carry_z):
        if buf.re.device.type == "cpu":
            return fm_chain_reference(buf, tap_bank, lo_table, n0_rot,
                                      decimation, gain, deemph, carry_f,
                                      carry_z)
        dev = buf.re.device
        if dev.type != "cuda":
            raise ValueError(f"fm_chain: tensors on {dev}, need cuda or cpu")
        c2, two, t = tap_bank.shape
        c = c2 // 2
        nb = buf.re.shape[-1]
        d = int(decimation)
        floats = {"buf.re": (buf.re, (nb,)), "buf.im": (buf.im, (nb,)),
                  "tap_bank": (tap_bank, (2 * c, 2, t)),
                  "lo_table": (lo_table, (c, 4)), "deemph": (deemph, (3,)),
                  "carry_f.re": (carry_f.re, (c, 1)),
                  "carry_f.im": (carry_f.im, (c, 1)),
                  "carry_z": (carry_z, (c, 1))}
        for name, (x, shape) in floats.items():
            if (x.device != dev or x.dtype != torch.float32
                    or tuple(x.shape) != shape or not x.is_contiguous()):
                raise ValueError(
                    f"fm_chain: {name} must be a contiguous float32 tensor of "
                    f"shape {shape} on {dev}; got {x.dtype} "
                    f"{tuple(x.shape)} on {x.device}, "
                    f"contiguous={x.is_contiguous()}")
        if two != 2 or c2 % 2:
            raise ValueError(f"fm_chain: tap_bank shape {tuple(tap_bank.shape)}")
        if (n0_rot.device != dev or n0_rot.dtype != torch.int32
                or n0_rot.numel() != 1):
            raise ValueError("fm_chain: n0_rot must be one int32 on buf's device")
        if d < 1 or nb < t:
            raise ValueError(f"fm_chain: Nb={nb} < T={t} or D={d} < 1")

        lib = self._library()
        m = (nb - t) // d + 1
        tile_out = lib.fm_chain_tile_outputs()
        ntiles = -(-m // tile_out)
        audio = torch.empty((c, m), dtype=torch.float32, device=dev)
        f_re = torch.empty((c, 1), dtype=torch.float32, device=dev)
        f_im = torch.empty((c, 1), dtype=torch.float32, device=dev)
        z_out = torch.empty((c, 1), dtype=torch.float32, device=dev)
        scratch = torch.empty((2, c, ntiles), dtype=torch.float32, device=dev)
        n0 = n0_rot.reshape(1).contiguous()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.fm_chain_launch(
                buf.re.data_ptr(), buf.im.data_ptr(), tap_bank.data_ptr(),
                lo_table.data_ptr(), n0.data_ptr(), deemph.data_ptr(),
                carry_f.re.data_ptr(), carry_f.im.data_ptr(),
                carry_z.data_ptr(), audio.data_ptr(), f_re.data_ptr(),
                f_im.data_ptr(), z_out.data_ptr(), scratch[0].data_ptr(),
                scratch[1].data_ptr(), nb, c, t, d, m, ntiles, float(gain),
                stream)
        if err != 0:
            raise RuntimeError(
                f"fm_chain kernel launch failed: CUDA error {err} "
                f"({lib.fm_chain_error_string(err).decode()})")
        self.launches += 1
        return audio, ComplexArray(f_re, f_im), z_out

    def _library(self):
        """The built library, its C signatures declared (first use)."""
        if self._lib is None:
            lib = load_library("fm_chain")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.fm_chain_launch.argtypes = [p] * 15 + [i] * 6 + [ctypes.c_float, p]
            lib.fm_chain_launch.restype = i
            lib.fm_chain_tile_outputs.argtypes = []
            lib.fm_chain_tile_outputs.restype = i
            lib.fm_chain_error_string.argtypes = [i]
            lib.fm_chain_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


fm_chain = FmChainKernel()
