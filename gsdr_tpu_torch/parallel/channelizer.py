"""Sharded receive steps: FIR and the FM and AM receivers over a mesh.

Counterpart of ``gsdr_tpu/parallel/channelizer.py``, in PyTorch's SPMD
idiom: every rank calls the step with ITS shard, and gets its shard back.

  * ``rf`` is the rank's contiguous (N/t,) time block;
  * per-channel state (``disc_carry``, ``deemph_zi``) is the rank's
    (C/c, 1) rows, replicated state (``n0``, ``rf_tail``) the same on
    every rank;
  * audio comes back as the rank's (C/c, N/(t D)) tile.

The state keeps ``FmChannelizer``'s (``AmReceiver``'s) order and shapes,
so a stream moves between the single-card step and the sharded step:
gathering the tiles and rows gives the single-card state
(``local_state`` takes a rank's share of one).

Channels shard with no communication: each rank keeps its rows of the tap
bank, LO table and DFT bank. The sample axis shards with halo exchanges
(``halo.py``). Oscillator phase needs none: a shard's outputs are rotated
at the global sample indices the single-card step rotates them at (the
window start n0 - (T-1) + s N/t, not reduced mod Fs inside the block),
so the float32 digit-table phase of every output is the single-card
step's. The rank's coordinate is a Python int, so JAX's masks become
branches.

Two decompositions, chosen by the model's ``impl``:

  * fused ('auto', 'cuda', 'pfb'; JAX's impl='pallas'): one call of the
    fused chain per shard on its halo'd block, B1/B2 for FM and B3 for AM
    on the card (their plain versions, at f32, on the CPU, as the models
    run them there), at the model's front and grade. FM needs a
    (T-1+D)-sample left halo: T-1 for the windows, D more so that each
    shard computes its left neighbour's last filtered, rotated sample
    (the discriminator's carry) from one T-sample window, with JAX's
    float32 XLA front. Shards past the first run the de-emphasis from
    zero state, and one all_gather of every shard's (final z, final
    carry) restores it exactly (the first-order case of ``iir.py``):
    audio += z_start a^j. The same gather hands every rank the last
    shard's carry, and the halo's gather the last shard's RF tail: two
    collectives a step, O(halo + C), independent of N. AM is memoryless:
    one (T-1) halo and one chain call.
  * unfused ('torch', 'pfb_torch'; JAX's XLA path): the front and rotor
    on a (T-1) halo, a 1-sample discriminator halo, ``sharded_iir`` for
    the de-emphasis and masked sums for the carried tails, in plain
    float32.

A sharded step on CUDA tensors never runs a kernel's plain version. Both
kernels' fronts take every geometry the JAX package's plans take (the
PFB front's bank, taps and window staged in chunks where they outgrow a
block), so the fused decomposition raises only for a shard length that D
(and, on the PFB front, K) does not divide, or one shorter than its halo.

The step objects are what ``utils.compile.compile_step`` captures over
NCCL, the port's ``jax.jit(make_sharded_fm_step(...))``: a step reads no
device value on the host, its restore powers are built on its first call
(the capture's warm-up), and ``mesh.sent`` counts a replay as an eager
call. ``compile_step`` refuses a step whose mesh runs over gloo.
"""

import numpy as np
import torch

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.kernels.am_chain import am_chain, pfb_am_chain
from gsdr_tpu_torch.kernels.chain import graded_bank_front, graded_uniform_front
from gsdr_tpu_torch.kernels.fm_chain import (
    deemphasis_triple,
    fm_chain,
    pfb_fm_chain,
)
from gsdr_tpu_torch.ops.channelize import mix_fir_decimate_bank, rotate_bank
from gsdr_tpu_torch.ops.fir import fir
from gsdr_tpu_torch.ops.quad_demod import quad_am_demod, quad_fm_demod
from gsdr_tpu_torch.parallel.halo import (
    _cat,
    all_gather,
    gather_edges,
    last_shard_tail,
    left_halo,
)
from gsdr_tpu_torch.parallel.iir import sharded_iir
from gsdr_tpu_torch.pipelines.fm_radio import fm_deemphasis_coeffs

_DEEMPH_BLOCK_LEN = 256


def sharded_fir(x, taps, mesh, decimation=1, tail=None):
    """FIR + decimation of the rank's (C/c, N/t) tile of x sharded over
    ('channel', 'time').

    Streaming convention: output j reads the window ending at j*D, history
    prepended, so each shard takes a (T-1)-sample left halo; shard 0 takes
    ``tail`` (the rank's rows of the carried history, (C/c, T-1)) or
    zeros. Returns the rank's (C/c, N/(t D)) tile.
    """
    nt = len(taps.re) if isinstance(taps, ComplexArray) else len(taps)
    if x.shape[-1] % int(decimation):
        raise ValueError(f"a shard's {x.shape[-1]} samples do not divide "
                         f"by the decimation {decimation}")
    return fir(left_halo(x, mesh, nt - 1, fill=tail), taps, decimation)


class _ShardedStep:
    """What the FM and AM steps share: this rank's rows of the model's
    tables, the decomposition, and the shard geometry's checks."""

    def __init__(self, model, mesh, what):
        c_sh, t_sh = mesh.shape["channel"], mesh.shape["time"]
        c = model.num_channels
        if c % c_sh:
            raise ValueError(f"{what}: {c} channels do not split over "
                             f"{c_sh} channel shards")
        if model.tap_bank.device != mesh.device:
            raise ValueError(f"{what}: the model lives on "
                             f"{model.tap_bank.device}, the mesh on "
                             f"{mesh.device}")
        self.model, self.mesh = model, mesh
        c_l = c // c_sh
        ci = mesh.coords["channel"]
        self.s, self.t = mesh.coords["time"], t_sh
        self.rows = slice(ci * c_l, (ci + 1) * c_l)
        self.num_taps, self.decimation = model.num_taps, model.decimation
        self.fs = int(round(model.sample_rate))
        # the rank's rows, as tensors of their own: the tensor-core tables
        # (kernels/chain.py) are cached per tensor
        self.tap_bank = model.tap_bank[2 * ci * c_l:2 * (ci + 1) * c_l].clone()
        self.lo_table = model.lo_table[self.rows].clone()
        self.pfb = model.front == "pfb"
        if self.pfb:
            self.k = model.pfb_grid[0]
            im = slice(c + ci * c_l, c + (ci + 1) * c_l)
            self.dft_bank = torch.cat([model.dft_bank[self.rows],
                                       model.dft_bank[im]])
            self.front = (model.poly_taps, self.dft_bank, self.num_taps)
        else:
            self.front = (self.tap_bank,)
        self.fused = model.impl not in ("torch", "pfb_torch")
        self.halo = self.num_taps - 1
        self.what = what

    def local_state(self, state):
        """This rank's share of a single-card state: per-channel leaves
        cut to its rows, the rest as they are."""
        n0, tail, *rows = state
        return (n0, tail, *(r[self.rows] for r in rows))

    def init(self, first_sample_index=0):
        return self.local_state(self.model.init(first_sample_index))

    def _check(self, n_l):
        """Raise where this rank's block cannot run the decomposition."""
        t, d, halo = self.num_taps, self.decimation, self.halo
        geometry = (f"{self.what}: a shard of {n_l} samples (T={t}, D={d}, "
                    f"mesh {self.mesh.shape})")
        if n_l % d:
            raise ValueError(f"{geometry} does not divide by D")
        if n_l < halo:
            raise ValueError(f"{geometry} is shorter than its {halo}-sample "
                             "halo")
        if self.fused and self.pfb and n_l % self.k:
            raise ValueError(f"{geometry}: the PFB front needs shards of a "
                             f"multiple of K={self.k} samples")

    def _rot0(self, n0, n_l):
        """Global index of this shard's first window start, mod Fs for the
        block's start only: the single-card step's indices."""
        fs, t = self.fs, self.num_taps
        return (torch.remainder(n0 + (fs - (t - 1) % fs), fs)
                + self.s * n_l).to(torch.int32)

    def _precision(self, x):
        """The kernels' grade on the card; their plain versions run f32 on
        the CPU, as the models do there."""
        return self.model.precision if x.re.is_cuda else "f32"

    def _plain_front(self, buf):
        """The front in plain float32 (the unfused decomposition)."""
        if self.pfb:
            return graded_uniform_front(buf, *self.front, self.decimation)
        return graded_bank_front(buf, self.tap_bank, self.decimation)

    def _advance(self, n0, n_l):
        fs = self.fs
        return torch.remainder(n0 + (n_l * self.t) % fs, fs).to(torch.int32)


class ShardedFmStep(_ShardedStep):
    """``FmChannelizer.step`` over a ('channel', 'time') mesh, for this
    rank: ``step(state, rf)`` -> (state', audio tile). ``init()`` is this
    rank's share of ``model.init()``."""

    def __init__(self, model, mesh):
        super().__init__(model, mesh, "sharded FmChannelizer")
        b, a = fm_deemphasis_coeffs(model.deemphasis_tau, model.audio_rate)
        self.iir_coeffs = (b, a)
        # the kernel's pole, float32 as in model.deemph
        self.pole = float(np.float32(deemphasis_triple(b, a)[2]))
        self._powers = {}
        if self.fused:  # D more: the left neighbour's last window
            self.halo += self.decimation

    def _restore(self, m_l):
        """(pow, ajs) of the de-emphasis restore for shards of m_l outputs:
        pow[j] = a^(m_l j), j = 0..t, and ajs[j] = a^j, j < m_l, from
        float64 powers (a^(m_l j) underflows to 0 for long shards: the
        pole's memory has died out)."""
        if m_l not in self._powers:
            a = np.float64(self.pole)
            pw = np.power(a, m_l * np.arange(self.t + 1, dtype=np.float64))
            ajs = np.power(a, np.arange(m_l, dtype=np.float64))
            self._powers[m_l] = (
                [float(np.float32(p)) for p in pw],
                torch.as_tensor(ajs, dtype=torch.float32,
                                device=self.mesh.device))
        return self._powers[m_l]

    def __call__(self, state, rf):
        n_l = rf.shape[-1]
        self._check(n_l)
        if self.fused:
            return self._fused(state, rf, n_l)
        return self._unfused(state, rf, n_l)

    def _fused(self, state, rf, n_l):
        n0, tail, carry, zi = state
        m = self.model
        t_cnt, d, s, t = self.num_taps, self.decimation, self.s, self.t
        edges = gather_edges(rf, self.mesh, t_cnt - 1 + d)
        rot0 = self._rot0(n0, n_l)
        if s == 0:
            buf = _cat(tail, rf)
            carry_f, z0 = carry, zi
        else:
            h = edges[s - 1]
            buf = _cat(h[d:], rf)
            # the left neighbour's last output, as JAX computes it: one
            # window through the float32 front, rotated at its index
            y = mix_fir_decimate_bank(h[:t_cnt], self.tap_bank, d)
            carry_f = rotate_bank(y, self.lo_table, rot0 - d, d)
            z0 = torch.zeros_like(zi)
        chain = pfb_fm_chain if self.pfb else fm_chain
        audio, fcar, zcar = chain(
            buf, *self.front, self.lo_table, rot0, d, m.gain, m.deemph,
            carry_f, z0, precision=self._precision(rf))
        new_tail = edges[t - 1][d:]
        if t > 1:
            # one gather: every shard's final z (the restore) and carry
            # (the last shard's is the stream's)
            st = all_gather(torch.cat([zcar, fcar.re, fcar.im], -1),
                            self.mesh)
            pw, ajs = self._restore(n_l // d)
            if s > 0:
                z_start = sum(pw[s - 1 - k] * st[k][:, :1] for k in range(s))
                audio = audio + z_start * ajs
            zcar = sum(pw[t - 1 - k] * st[k][:, :1]
                       for k in range(t)).contiguous()
            fcar = ComplexArray(st[-1][:, 1:2].contiguous(),
                                st[-1][:, 2:3].contiguous())
        return (self._advance(n0, n_l), new_tail, fcar, zcar), audio

    def _unfused(self, state, rf, n_l):
        n0, tail, carry, zi = state
        m, d = self.model, self.decimation
        buf = left_halo(rf, self.mesh, self.num_taps - 1, fill=tail)
        filt = rotate_bank(self._plain_front(buf), self.lo_table,
                           self._rot0(n0, n_l), d)
        demod = quad_fm_demod(left_halo(filt, self.mesh, 1, fill=carry),
                              m.gain)
        new_carry = last_shard_tail(filt, self.mesh, 1)
        audio, zf = sharded_iir(*self.iir_coeffs, demod, zi, self.mesh,
                                block_len=_DEEMPH_BLOCK_LEN)
        new_tail = last_shard_tail(rf, self.mesh, self.num_taps - 1)
        return (self._advance(n0, n_l), new_tail, new_carry, zf), audio


class ShardedAmStep(_ShardedStep):
    """``AmReceiver.step`` over a ('channel', 'time') mesh, for this rank.
    The chain is memoryless past its window, and the envelope cancels the
    rotor: the fused form is one halo and one chain call a shard."""

    def __init__(self, model, mesh):
        super().__init__(model, mesh, "sharded AmReceiver")

    def __call__(self, state, rf):
        n0, tail = state
        n_l = rf.shape[-1]
        self._check(n_l)
        t_cnt, d = self.num_taps, self.decimation
        rot0 = self._rot0(n0, n_l)
        if self.fused:
            edges = gather_edges(rf, self.mesh, t_cnt - 1)
            buf = _cat(tail if self.s == 0 else edges[self.s - 1], rf)
            chain = pfb_am_chain if self.pfb else am_chain
            audio = chain(buf, *self.front, self.lo_table, rot0, d,
                          precision=self._precision(rf))
            new_tail = edges[-1]
        else:
            buf = left_halo(rf, self.mesh, t_cnt - 1, fill=tail)
            audio = quad_am_demod(rotate_bank(self._plain_front(buf),
                                              self.lo_table, rot0, d))
            new_tail = last_shard_tail(rf, self.mesh, t_cnt - 1)
        return (self._advance(n0, n_l), new_tail), audio


def make_sharded_fm_step(model, mesh):
    """``FmChannelizer.step`` over a ('channel', 'time') mesh: every rank
    calls ``step(state, rf)`` with its time block and its share of the
    state (``step.init()``, ``step.local_state(single_card_state)``) and
    gets its (C/c, N/(t D)) audio tile and its share of the next state."""
    return ShardedFmStep(model, mesh)


def make_sharded_am_step(model, mesh):
    """``AmReceiver.step`` over a ('channel', 'time') mesh, for this rank
    (as ``make_sharded_fm_step``; the state is (n0, rf_tail))."""
    return ShardedAmStep(model, mesh)
