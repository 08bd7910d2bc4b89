"""The port's distributed layer (gsdr_tpu_torch.parallel) against the JAX
package's (gsdr_tpu.parallel) and the single-chip steps.

One group of four gloo ranks on the CPU (``torch_shard_ranks.py``, which
imports only the port) runs every case below, each rank with its own
shard, on meshes (2, 2), (1, 4) and (4, 1). This process runs the same
numpy inputs through JAX's sharded functions on four of the eight virtual
CPU devices (``conftest.py``) and through JAX's single-chip functions, at
impl='xla' (no interpret-mode Pallas), gathers the ranks' tiles and
compares. The tolerances are JAX's own (``test_parallel.py``), each for
the comparison whose structure it copies: against JAX's XLA path, its
XLA-path tolerance (FM rtol 2e-3 / atol 2e-4, AM 1e-3 / 2e-4, FIR 1e-4 /
1e-5); the fused decomposition (impl 'auto' or 'pfb': the kernels' plain
versions at f32 on the CPU) against the port's own single-card step, its
fused tolerance, 2e-4 / 2e-5 and carries 5e-5. (The port's single-card
chain itself sits up to 2.2e-5 from JAX's XLA chain at an output of these
FM streams, max|audio| 2.1, just over the fused atol.) FM audio also gets
the digit-table phase's allowance at every shard boundary
(``_boundary_allowance``), and every comparison skips the zero-primed
first step's warm-up.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map as shard_map_fn
except ImportError:
    from jax.experimental.shard_map import shard_map as shard_map_fn

import torch_shard_ranks
from gsdr_tpu import fir
from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.ops.iir import iir_block
from gsdr_tpu.ops.qpsk256 import CIRCULAR, RECTANGULAR
from gsdr_tpu.parallel import (
    left_halo,
    make_mesh,
    make_sharded_am_step,
    make_sharded_fm_step,
    make_sharded_qpsk256_modem,
    make_sharded_qpsk_modem,
    right_halo,
    sharded_fir,
    sharded_iir,
)
from gsdr_tpu.pipelines import AmReceiver, FmChannelizer
from gsdr_tpu.pipelines import Qpsk256Modem, QpskModem
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.utils.convert import (
    am_receiver_from_fields,
    fm_channelizer_from_fields,
    state_to_numpy,
)

FS = 1_000_000.0
PFB_FS, PFB_K = 1_024_000.0, 16
BLOCK = 8192          # FM and AM samples a step (2048 outputs at D = 4)
SKIP = 256            # zero-primed warm-up outputs of the first step
MESHES = ((2, 2), (1, 4), (4, 1))
UNFUSED = dict(rtol=2e-3, atol=2e-4)
FUSED = dict(rtol=2e-4, atol=2e-5)
FUSED_CARRY = 5e-5
# The float32 digit-table phase is exact to PHASE_BOUND cycles; where a
# shard's first index is written otherwise than the single-chip step's
# (JAX reduces it mod Fs), one discriminator output can move by
# gain*2*pi*2*PHASE_BOUND, and the de-emphasis passes that on as its
# impulse response (tests/test_torch_fm_radio.py).
PHASE_BOUND = 6e-5


def _lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def _fm_fields(impl, num_taps=32, nch=4):
    return dataclasses.asdict(FmChannelizer(
        sample_rate=FS, tuning_frequency=0.0,
        channel_frequencies=tuple(100_000.0 + 37_000.0 * i
                                  for i in range(nch)),
        frequency_deviation=75_000.0, decimation=4,
        low_pass_taps=_lowpass(num_taps, 0.04), impl=impl))


def _pfb_fm_fields(impl):
    return dataclasses.asdict(FmChannelizer(
        sample_rate=PFB_FS, tuning_frequency=0.0,
        channel_frequencies=tuple(-PFB_FS / 2 + (PFB_FS / PFB_K) * i
                                  for i in range(8)),
        frequency_deviation=75_000.0, decimation=4,
        low_pass_taps=_lowpass(64, 0.4 / PFB_K), impl=impl))


def _am_fields(impl):
    return dataclasses.asdict(AmReceiver(
        sample_rate=FS, tuning_frequency=0.0,
        channel_frequencies=(50_000.0, -120_000.0), decimation=4,
        low_pass_taps=_lowpass(33, 0.05), impl=impl))


def _pfb_am_fields(impl):
    return dataclasses.asdict(AmReceiver(
        sample_rate=PFB_FS, tuning_frequency=0.0,
        channel_frequencies=tuple(-PFB_FS / 2 + (PFB_FS / PFB_K) * i
                                  for i in range(8)),
        decimation=8, low_pass_taps=_lowpass(64, 0.4 / PFB_K), impl=impl))


def _fm_rf(freqs, n, fs):
    """Real FM carriers: white noise would put samples on the atan2
    branch cut, where two correct implementations differ by 2*pi*gain."""
    t = np.arange(n) / fs
    sig = np.zeros(n, np.complex128)
    for k, f in enumerate(freqs):
        msg = np.sin(2 * np.pi * 800.0 * (k + 1) * t)
        sig += (0.9 / len(freqs)) * np.exp(
            1j * (2 * np.pi * f * t + 0.4 * msg))
    return sig.astype(np.complex64)


def _put(inputs, name, z):
    inputs[name + ".re"] = np.ascontiguousarray(z.real, np.float32)
    inputs[name + ".im"] = np.ascontiguousarray(z.imag, np.float32)


def _stable_filter(rng, order):
    b = tuple((rng.standard_normal(order + 1) * 0.3).tolist())
    a = tuple(np.poly(rng.uniform(-0.6, 0.6, order)).tolist())
    return b, a


def _cases():
    """(cases, numpy inputs), all made from one seed."""
    rng = np.random.default_rng(7)
    inputs = {}
    cases = []

    def noise(shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    # halos on (1, 4): real and planar, with and without fill
    inputs["ramp"] = np.arange(64, dtype=np.float32).reshape(1, 64)
    inputs["fill2"] = np.array([[-1.0, -2.0]], np.float32)
    inputs["fill3"] = np.array([[-7.0, -8.0, -9.0]], np.float32)
    _put(inputs, "zx", noise((1, 64)))
    _put(inputs, "zfill", noise((1, 2)))
    for kind, halo, fill in (("left_halo", 2, None), ("left_halo", 2, "fill2"),
                             ("right_halo", 3, None),
                             ("right_halo", 3, "fill3")):
        cases.append(dict(key=f"{kind}{halo}_{fill}", kind=kind,
                          mesh=[1, 4], x="ramp", halo=halo, fill=fill,
                          planar=False))
    cases.append(dict(key="left_halo_planar", kind="left_halo", mesh=[1, 4],
                      x="zx", halo=2, fill="zfill", planar=True))

    # FIR on (2, 2): D = 1 and 4, with a carried tail, and D = 4 without
    taps = list(_lowpass(33, 0.1))
    _put(inputs, "fir_x", noise((4, 4096)))
    _put(inputs, "fir_tail", noise((4, 32)))
    for d, tail in ((1, "fir_tail"), (4, "fir_tail"), (4, None)):
        cases.append(dict(key=f"fir_d{d}_{tail}", kind="fir", mesh=[2, 2],
                          x="fir_x", taps=taps, decimation=d, tail=tail))

    # IIR on (1, 4): orders 1, 2, 4 with zi, batched and 1-D
    for order in (1, 2, 4):
        b, a = _stable_filter(rng, order)
        for layout, shape in (("batched", (3, 2048)), ("1d", (2048,))):
            name = f"iir{order}_{layout}"
            inputs[name] = rng.standard_normal(shape).astype(np.float32)
            inputs[name + "_zi"] = (0.1 * rng.standard_normal(
                shape[:-1] + (order,))).astype(np.float32)
            cases.append(dict(key=name, kind="iir", mesh=[1, 4], x=name,
                              zi=name + "_zi", b=b, a=a))

    # FM: both decompositions on every mesh, two steps; T = 65; the PFB
    # step continued by the dense step; comm audit
    fm = _fm_fields("xla")
    _put(inputs, "rf_fm", _fm_rf(fm["channel_frequencies"], 2 * BLOCK, FS))
    for c, t in MESHES:
        for impl in ("auto", "xla"):
            cases.append(dict(key=f"fm{c}{t}_{impl}", kind="fm", mesh=[c, t],
                              rf="rf_fm", block=BLOCK,
                              segments=[[_fm_fields(impl), 2]]))
    cases.append(dict(key="fm_t65", kind="fm", mesh=[2, 2], rf="rf_fm",
                      block=BLOCK, segments=[[_fm_fields("auto", 65), 2]]))
    pfb = _pfb_fm_fields("pfb")
    _put(inputs, "rf_pfb", _fm_rf(pfb["channel_frequencies"], 3 * BLOCK,
                                  PFB_FS))
    cases.append(dict(key="fm_pfb_then_dense", kind="fm", mesh=[2, 2],
                      rf="rf_pfb", block=BLOCK,
                      segments=[[pfb, 2], [_pfb_fm_fields("auto"), 1]]))

    # AM on (2, 2): the dense front fused and unfused, the PFB front
    _put(inputs, "rf_am", noise(2 * BLOCK))
    for impl in ("auto", "xla"):
        cases.append(dict(key=f"am_{impl}", kind="am", mesh=[2, 2],
                          rf="rf_am", block=BLOCK,
                          segments=[[_am_fields(impl), 2]]))
    cases.append(dict(key="am_pfb", kind="am", mesh=[2, 2], rf="rf_am",
                      block=BLOCK, segments=[[_pfb_am_fields("pfb"), 2]]))

    # the sharded FM (fused, dense), AM (fused, PFB) and IIR steps
    # through compile_step on (2, 2) against their eager steps
    b, a = _stable_filter(rng, 2)
    inputs["iir_step_x"] = rng.standard_normal(2 * BLOCK).astype(np.float32)
    _put(inputs, "rf_pfb_am", noise(2 * BLOCK))
    cases.append(dict(key="compiled", kind="compiled", mesh=[2, 2],
                      fm=_fm_fields("auto"), am=_pfb_am_fields("pfb"),
                      b=b, a=a, rf_fm="rf_fm", rf_am="rf_pfb_am",
                      x="iir_step_x", block=BLOCK, steps=2))

    # modems on (2, 2)
    inputs["sym256"] = rng.integers(0, 256, (8, 512)).astype(np.int32)
    inputs["sym4"] = rng.integers(0, 4, (4, 1024)).astype(np.int32)
    for name, ctype in (("rect", RECTANGULAR), ("circ", CIRCULAR)):
        cases.append(dict(key=f"qpsk256_{name}", kind="qpsk256",
                          mesh=[2, 2], symbols="sym256",
                          fields=dataclasses.asdict(Qpsk256Modem(
                              constellation_type=ctype))))
    cases.append(dict(key="qpsk", kind="qpsk", mesh=[2, 2], symbols="sym4",
                      fields=dataclasses.asdict(QpskModem(amplitude=2.0))))
    return cases, inputs


CASES, INPUTS = _cases()
BY_KEY = {c["key"]: c for c in CASES}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_shard_ranks.spawn(tmp_path_factory.mktemp("ranks"), CASES,
                                   INPUTS)


def _mesh_key(case):
    return json.dumps(case["mesh"])


def _gather(ranks, case, key, planar=False):
    """The ranks' tiles of ``key`` put together as JAX lays out a
    P('channel', 'time') array (rows over channel shards, columns over
    time shards)."""
    if planar:
        re = _gather(ranks, case, key + ".re")
        return re + 1j * _gather(ranks, case, key + ".im")
    c, t = case["mesh"]
    tiles = {tuple(r[f"coords:{_mesh_key(case)}"]): r[key] for r in ranks}
    rows = [np.concatenate([tiles[(ci, s)] for s in range(t)], axis=-1)
            for ci in range(c)]
    return np.concatenate(rows, axis=0) if c > 1 else rows[0]


def _jmesh(case):
    c, t = case["mesh"]
    return make_mesh(channel=c, time=t, devices=jax.devices()[:c * t])


def _jca(inputs, name):
    return JCA(jnp.asarray(inputs[name + ".re"]),
               jnp.asarray(inputs[name + ".im"]))


def _np(x):
    return x.to_numpy() if isinstance(x, JCA) else np.asarray(x)


def _shmap(fn, case, in_specs, out_specs):
    return shard_map_fn(fn, mesh=_jmesh(case), in_specs=in_specs,
                        out_specs=out_specs, check_vma=False)


# ---------------------------------------------------------------------------
# halos, FIR, IIR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", [c["key"] for c in CASES
                                 if c["kind"].endswith("halo")])
def test_halo_matches_jax(ranks, key):
    case = BY_KEY[key]
    fn = left_halo if case["kind"] == "left_halo" else right_halo
    if case["planar"]:
        x, fill = _jca(INPUTS, case["x"]), _jca(INPUTS, case["fill"])
    else:
        x = jnp.asarray(INPUTS[case["x"]])
        fill = None if case["fill"] is None else jnp.asarray(
            INPUTS[case["fill"]])
    sh, rows = P("channel", "time"), P("channel", None)
    if fill is None:
        want = _shmap(lambda v: fn(v, "time", case["halo"]), case,
                      (sh,), sh)(x)
    else:
        want = _shmap(lambda v, f: fn(v, "time", case["halo"], fill=f),
                      case, (sh, rows), sh)(x, fill)
    got = _gather(ranks, case, key, planar=case["planar"])
    np.testing.assert_array_equal(got, _np(want))


@pytest.mark.parametrize("key", [c["key"] for c in CASES
                                 if c["kind"] == "fir"])
def test_sharded_fir_matches_jax(ranks, key):
    case = BY_KEY[key]
    x = _jca(INPUTS, case["x"])
    tail = None if case["tail"] is None else _jca(INPUTS, case["tail"])
    taps, d = np.asarray(case["taps"], np.float32), case["decimation"]
    sharded = sharded_fir(x, taps, _jmesh(case), decimation=d, tail=tail)
    pad = tail if tail is not None else JCA.zeros((4, len(taps) - 1))
    single = fir(JCA(jnp.concatenate([pad.re, x.re], -1),
                     jnp.concatenate([pad.im, x.im], -1)),
                 jnp.asarray(taps), d)
    got = _gather(ranks, case, key, planar=True)
    for want in (sharded, single):
        np.testing.assert_allclose(got, _np(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("key", [c["key"] for c in CASES
                                 if c["kind"] == "iir"])
def test_sharded_iir_matches_jax(ranks, key):
    case = BY_KEY[key]
    b, a = tuple(case["b"]), tuple(case["a"])
    x, zi = jnp.asarray(INPUTS[case["x"]]), jnp.asarray(INPUTS[case["zi"]])
    t = case["mesh"][1]
    time_spec = P(None, "time") if x.ndim == 2 else P("time")
    rep = P(None, None) if x.ndim == 2 else P(None)
    y_sh, zf_sh = jax.jit(_shmap(
        lambda xl, z: sharded_iir(b, a, xl, z, "time", t), case,
        (time_spec, rep), (time_spec, rep)))(x, zi)
    y_1, zf_1 = iir_block(jnp.asarray(b, jnp.float32),
                          jnp.asarray(a, jnp.float32), x, zi=zi, impl="xla")
    got_y = _gather(ranks, case, key + ":y")
    zfs = [r[key + ":zf"] for r in ranks]
    for z in zfs[1:]:   # the final state is replicated
        np.testing.assert_array_equal(z, zfs[0])
    for want_y, want_zf in ((y_sh, zf_sh), (y_1, zf_1)):
        np.testing.assert_allclose(got_y, _np(want_y), **UNFUSED)
        np.testing.assert_allclose(zfs[0], _np(want_zf), **UNFUSED)


# ---------------------------------------------------------------------------
# FM and AM steps
# ---------------------------------------------------------------------------

def _model(case, fields):
    cls = FmChannelizer if case["kind"] == "fm" else AmReceiver
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in fields.items()})


def _jax_stream(key, sharded):
    """JAX's audio per step and final state for a case's segments."""
    case = BY_KEY[key]
    segments = case["segments"]
    if sharded:  # one reference for both of the port's decompositions
        segments = [[dict(f, impl="xla"), n] for f, n in segments]
    return _jax_segments(case["kind"], json.dumps(case["mesh"]), case["rf"],
                         case["block"], json.dumps(segments), sharded)


@functools.lru_cache(maxsize=None)
def _jax_segments(kind, mesh, rf, n, segments, sharded):
    """The single-chip steps or, with ``sharded``, JAX's sharded steps on
    the same mesh at impl='xla' (so both of the port's decompositions
    share one reference), each jitted."""
    case = dict(kind=kind, mesh=json.loads(mesh))
    re, im = INPUTS[rf + ".re"], INPUTS[rf + ".im"]
    b, state, outs = 0, None, []
    for fields, steps in json.loads(segments):
        model = _model(case, fields)
        if sharded:
            model = dataclasses.replace(model, impl="xla")
            step = (make_sharded_fm_step if kind == "fm"
                    else make_sharded_am_step)(model, _jmesh(case))
        else:
            step = model.step
        step = jax.jit(step)
        state = model.init() if state is None else state
        for _ in range(steps):
            blk = slice(b * n, (b + 1) * n)
            state, y = step(state, JCA(jnp.asarray(re[blk]),
                                       jnp.asarray(im[blk])))
            outs.append(np.asarray(y))
            b += 1
    return outs, state


@functools.lru_cache(maxsize=None)
def _port_stream(key):
    """The port's single-card steps over a case's segments, on the CPU:
    audio per step and the final state as numpy (planar leaves as
    complex), the layout of JAX's."""
    case = BY_KEY[key]
    build = (fm_channelizer_from_fields if case["kind"] == "fm"
             else am_receiver_from_fields)
    re, im = INPUTS[case["rf"] + ".re"], INPUTS[case["rf"] + ".im"]
    n, b, state, outs = case["block"], 0, None, []
    for fields, steps in case["segments"]:
        model = build(fields, device="cpu")
        state = model.init() if state is None else state
        for _ in range(steps):
            blk = slice(b * n, (b + 1) * n)
            state, y = model.step(state, TCA(torch.from_numpy(re[blk]),
                                             torch.from_numpy(im[blk])))
            outs.append(y.numpy())
            b += 1
    leaves = [v[0] + 1j * v[1] if isinstance(v, tuple) else v
              for v in state_to_numpy(state)]
    return outs, leaves


def _reference(key, ref):
    """(audio per step, final state) of a reference: 'port_single',
    'jax_single' or 'jax_sharded'."""
    if ref == "port_single":
        return _port_stream(key)
    return _jax_stream(key, ref == "jax_sharded")


def _boundary_allowance(case, fields, m):
    """Per output of a step: the most the digit-table phase can move the
    audio at the shard boundaries (PHASE_BOUND), summed over them."""
    model = _model(case, fields)
    (b0, b1), (_, a1) = model._deemph()
    b0, cc, a = abs(b0), abs(b1 - a1 * b0), abs(a1)
    h = np.concatenate([[b0], cc * a ** np.arange(m - 1)])
    t = case["mesh"][1]
    m_l = m // t
    allow = np.zeros(m)
    for s in range(1, t):
        allow[s * m_l:] += h[:m - s * m_l]
    return model.gain * 2 * np.pi * 2 * PHASE_BOUND * allow


def _state(ranks, case, i, planar=False, per_channel=False):
    """State leaf i: per-channel rows gathered over the channel shards
    (the same on every time shard), else the same on every rank."""
    key = f"{case['key']}:state{i}"

    def leaf(r):
        if planar:
            return r[key + ".re"] + 1j * r[key + ".im"]
        return r[key]

    if not per_channel:
        for r in ranks[1:]:
            np.testing.assert_array_equal(leaf(r), leaf(ranks[0]))
        return leaf(ranks[0])
    by = {}
    for r in ranks:
        ci = int(r[f"coords:{_mesh_key(case)}"][0])
        if ci in by:
            np.testing.assert_array_equal(leaf(r), by[ci])
        by[ci] = leaf(r)
    return np.concatenate([by[ci] for ci in sorted(by)], axis=0)


def _tolerance(case, fused, ref):
    """JAX's tolerance for the comparison: its fused one between the
    fused decomposition and the port's own single-card step, its XLA-path
    one otherwise (FM, or AM's looser rtol)."""
    if fused and ref == "port_single":
        return FUSED
    return UNFUSED if case["kind"] == "fm" else dict(rtol=1e-3, atol=2e-4)


def _check_audio(ranks, case, outs, tol_of_step):
    """Every step's gathered audio within its tolerance of JAX's, after
    the first step's warm-up; FM with the shard boundaries' allowance."""
    b = 0
    for fields, steps in case["segments"]:
        for _ in range(steps):
            got = _gather(ranks, case, f"{case['key']}:audio{b}")
            want, tol = outs[b], tol_of_step(b)
            assert got.shape == want.shape
            skip = SKIP if b == 0 else 0
            bound = tol["atol"] + tol["rtol"] * np.abs(want)
            if case["kind"] == "fm":
                bound = bound + _boundary_allowance(case, fields,
                                                    want.shape[-1])
            err = np.abs(got - want)[:, skip:]
            bad = err > bound[:, skip:]
            assert not bad.any(), (f"{case['key']} step {b}: "
                                   f"{int(bad.sum())} outputs off, worst "
                                   f"{float(err.max()):.3g}")
            b += 1


def _check_state(ranks, case, jstate, tol, fused):
    """n0 equal; the RF tail within 1e-6 (it is moved, not computed); the
    FM carries within 5e-5 (fused, against the port) or the atol, the
    de-emphasis states within the tolerance."""
    assert int(_state(ranks, case, 0)) == int(jstate[0])
    np.testing.assert_allclose(_state(ranks, case, 1, planar=True),
                               _np(jstate[1]), atol=1e-6)
    if case["kind"] == "fm":
        catol = FUSED_CARRY if fused else tol["atol"]
        np.testing.assert_allclose(
            _state(ranks, case, 2, planar=True, per_channel=True),
            _np(jstate[2]), atol=catol)
        np.testing.assert_allclose(
            _state(ranks, case, 3, per_channel=True), _np(jstate[3]),
            rtol=tol["rtol"], atol=catol)


def _check_stream(ranks, key, fused, ref):
    case = BY_KEY[key]
    outs, state = _reference(key, ref)
    tol = _tolerance(case, fused, ref)
    _check_audio(ranks, case, outs, lambda b: tol)
    _check_state(ranks, case, state, tol, fused and ref == "port_single")


REFS = ["port_single", "jax_single", "jax_sharded"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("ref", REFS)
def test_fm_step_matches_jax(ranks, mesh, impl, ref):
    """Both decompositions (impl 'auto': fused, the kernels' plain versions
    on the CPU; 'xla' -> the port's 'torch': unfused) over two steps,
    audio and every state leaf."""
    key = f"fm{mesh[0]}{mesh[1]}_{impl}"
    _check_stream(ranks, key, fused=impl == "auto", ref=ref)


@pytest.mark.parametrize("ref", REFS[:2])
def test_fm_odd_taps_matches_jax(ranks, ref):
    """T = 65 at D = 4 (T % D != 0) on the fused decomposition."""
    _check_stream(ranks, "fm_t65", fused=True, ref=ref)


@pytest.mark.parametrize("ref", REFS[:2])
def test_fm_pfb_then_dense_matches_jax(ranks, ref):
    """The PFB front (K = 16) for two steps, then the dense front
    continuing the same sharded stream, against the single-card 'pfb' and
    'auto' steps continuing theirs (JAX's on the CPU: its XLA PFB front,
    then its XLA chain)."""
    _check_stream(ranks, "fm_pfb_then_dense", fused=True, ref=ref)


@pytest.mark.parametrize("key,fused,ref", [
    (key, fused, ref) for key, fused in (("am_auto", True), ("am_xla", False),
                                         ("am_pfb", True))
    # JAX's sharded 'pfb' step is its fused kernel: not run here
    for ref in (REFS if key != "am_pfb" else REFS[:2])])
def test_am_step_matches_jax(ranks, key, fused, ref):
    """AM on the dense front (fused and unfused) and the PFB front."""
    _check_stream(ranks, key, fused=fused, ref=ref)


# ---------------------------------------------------------------------------
# modems
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["qpsk256_rect", "qpsk256_circ", "qpsk"])
def test_sharded_modem_loopback_matches_jax(ranks, key):
    case = BY_KEY[key]
    syms = INPUTS[case["symbols"]]
    if case["kind"] == "qpsk256":
        modem = Qpsk256Modem(**case["fields"])
        tx, rx = make_sharded_qpsk256_modem(modem, _jmesh(case))
    else:
        modem = QpskModem(**case["fields"])
        tx, rx = make_sharded_qpsk_modem(modem, _jmesh(case))
    want_tx = tx(jnp.asarray(syms))
    got_tx = _gather(ranks, case, key + ":tx", planar=True)
    np.testing.assert_array_equal(got_tx, want_tx.to_numpy())
    got_rx = _gather(ranks, case, key + ":rx")
    assert got_rx.dtype == np.int32
    np.testing.assert_array_equal(got_rx, syms)
    np.testing.assert_array_equal(got_rx, np.asarray(rx(want_tx)))


def test_compiled_sharded_steps_are_the_eager_steps(ranks):
    """compile_step over make_sharded_fm_step (fused, dense front),
    make_sharded_am_step (fused, PFB front) and make_sharded_iir_step on a
    (2, 2) gloo mesh of CPU blocks: on the CPU the compiled step runs the
    step itself, so every output, state leaf and count of elements handed
    to collectives equals the eager run's, on every rank (and a step over
    gloo is not refused on CPU blocks)."""
    for r in ranks:
        keys = [k for k in r if k.startswith("compiled:")
                and ":eager:" in k]
        assert len(keys) >= 3 * 3
        for k in keys:
            got, want = r[k.replace(":eager:", ":compiled:")], r[k]
            assert got.dtype == want.dtype and np.array_equal(got, want), k
        for name in ("fm", "am", "iir"):
            assert r[f"compiled:{name}:eager:sent"].sum() > 0


# ---------------------------------------------------------------------------
# in this process: the trivial mesh and the layout's errors
# ---------------------------------------------------------------------------

def _port_fm(impl, **kw):
    fields = dict(_fm_fields(impl), **kw)
    return fm_channelizer_from_fields(fields, device="cpu")


def test_trivial_mesh_step_is_the_single_card_step():
    """A 1x1 mesh with no process group runs no collective: the fused
    step is FmChannelizer.step bit for bit, the unfused one within float32
    rounding (its de-emphasis coefficients come from the host in float64)
    and AM's fused step is AmReceiver.step bit for bit."""
    from gsdr_tpu_torch.parallel import (
        make_mesh as t_make_mesh,
        make_sharded_am_step as t_am_step,
        make_sharded_fm_step as t_fm_step,
    )

    mesh = t_make_mesh(device="cpu")
    assert mesh.shape == {"channel": 1, "time": 1} and mesh.backend is None
    re, im = INPUTS["rf_fm.re"], INPUTS["rf_fm.im"]
    for impl in ("auto", "xla"):
        model = _port_fm(impl)
        step = t_fm_step(model, mesh)
        st_s, st_1 = step.init(), model.init()
        for b in range(2):
            rf = TCA(torch.from_numpy(re[b * BLOCK:(b + 1) * BLOCK]),
                     torch.from_numpy(im[b * BLOCK:(b + 1) * BLOCK]))
            st_s, y_s = step(st_s, rf)
            st_1, y_1 = model.step(st_1, rf)
            if impl == "auto":
                assert torch.equal(y_s, y_1)
                assert torch.equal(st_s[3], st_1[3])
                assert torch.equal(st_s[2].re, st_1[2].re)
            else:
                torch.testing.assert_close(y_s, y_1, rtol=1e-5, atol=1e-6)
            assert int(st_s[0]) == int(st_1[0])
            assert torch.equal(st_s[1].re, st_1[1].re)
    assert mesh.sent == {"all_gather": 0, "all_reduce": 0}
    am = am_receiver_from_fields(_am_fields("auto"), device="cpu")
    step = t_am_step(am, mesh)
    rf = TCA(torch.from_numpy(INPUTS["rf_am.re"][:BLOCK]),
             torch.from_numpy(INPUTS["rf_am.im"][:BLOCK]))
    assert torch.equal(step(step.init(), rf)[1], am.step(am.init(), rf)[1])


def test_shard_geometry_errors_raise():
    """The fused decomposition refuses a shard shorter than its
    (T-1+D)-sample halo, one that D does not divide, and for the PFB front
    one that K does not divide; a layout that does not fit the world, or
    channels that do not split, raise too."""
    from gsdr_tpu_torch.parallel import (
        make_mesh as t_make_mesh,
        make_sharded_fm_step as t_fm_step,
    )
    from gsdr_tpu_torch.parallel.mesh import Mesh

    mesh = t_make_mesh(device="cpu")
    step = t_fm_step(_port_fm("auto"), mesh)          # T = 32, D = 4

    def block(n):
        return TCA(torch.zeros(n), torch.zeros(n))

    with pytest.raises(ValueError, match="shorter than its 35-sample halo"):
        step(step.init(), block(32))
    with pytest.raises(ValueError, match="does not divide by D"):
        step(step.init(), block(4098))
    step(step.init(), block(36))                       # the halo fits
    pfb = fm_channelizer_from_fields(_pfb_fm_fields("pfb"), device="cpu")
    step = t_fm_step(pfb, mesh)
    with pytest.raises(ValueError, match="multiple of K=16"):
        step(step.init(), block(4104))
    with pytest.raises(ValueError, match="initialized process group"):
        t_make_mesh(2, 2, device="cpu")
    halves = Mesh(2, 1, 0, {"channel": None, "time": None},
                  torch.device("cpu"), None)
    with pytest.raises(ValueError, match="do not split over 2"):
        t_fm_step(_port_fm("auto", channel_frequencies=[1e5, 2e5, 3e5]),
                  halves)
