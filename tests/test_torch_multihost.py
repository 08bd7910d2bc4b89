"""The port's process-group bring-up, its host-aligned mesh and its
communication volume, on the CPU.

Four gloo ranks rendezvous at env:// as torchrun's would, two to a "host"
(LOCAL_WORLD_SIZE=2), and run ``torch_shard_ranks.py`` (the port alone):
``make_pod_mesh``'s host-major layout at channel_per_host 1 and 2, two
sharded FM steps on each against JAX's single-chip step and the port's,
a 256-stream QPSK256 loopback whose streams cross the host boundary, and
the elements the sharded FM step hands to collectives at two block
lengths, which must not grow with N (the counterpart of
``benchmarks/scaling.py``'s communication audit). The NCCL bring-up's own
error for more local ranks than cards runs in this process, with the
card count patched.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_ranks
from gsdr_tpu.carray import ComplexArray as JCA
from gsdr_tpu.ops.qpsk256 import CIRCULAR
from gsdr_tpu.pipelines import FmChannelizer, Qpsk256Modem
from gsdr_tpu_torch.carray import ComplexArray as TCA
from gsdr_tpu_torch.parallel import initialize
from gsdr_tpu_torch.utils.convert import fm_channelizer_from_fields

FS = 1_000_000.0
BLOCK = 4096
SKIP = 256
NUM_TAPS, DECIMATION, CHANNELS = 33, 4, 16
AUDIT_BLOCKS = (4096, 16384)
UNFUSED = dict(rtol=2e-3, atol=2e-4)   # against JAX's XLA chain
FUSED = dict(rtol=2e-4, atol=2e-5)     # against the port's own step


def _lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def _fm_model(impl="auto"):
    return FmChannelizer(
        sample_rate=FS, tuning_frequency=0.0,
        channel_frequencies=tuple(-480_000.0 + 60_000.0 * i
                                  for i in range(CHANNELS)),
        frequency_deviation=75_000.0, decimation=DECIMATION,
        low_pass_taps=_lowpass(NUM_TAPS, 0.03), impl=impl)


def _fm_rf(freqs, n):
    t = np.arange(n) / FS
    sig = np.zeros(n, np.complex128)
    for k, f in enumerate(freqs):
        msg = np.sin(2 * np.pi * (700.0 + 370.0 * k) * t + 0.3 * k)
        sig += (0.5 / len(freqs)) * np.exp(
            1j * (2 * np.pi * f * t + 0.35 * msg))
    return sig.astype(np.complex64)


def _cases():
    rng = np.random.default_rng(11)
    model = _fm_model()
    fields = dataclasses.asdict(model)
    rf = _fm_rf(model.channel_frequencies, 2 * BLOCK)
    inputs = {"rf.re": rf.real.copy(), "rf.im": rf.imag.copy(),
              "sym": rng.integers(0, 256, (256, 512)).astype(np.int32)}
    cases = []
    for cph in (1, 2):
        cases.append(dict(key=f"fm_pod{cph}", kind="fm", mesh=["pod", cph],
                          rf="rf", block=BLOCK, segments=[[fields, 2]]))
    cases.append(dict(key="qpsk256", kind="qpsk256", mesh=["pod", 2],
                      symbols="sym", fields=dataclasses.asdict(
                          Qpsk256Modem(constellation_type=CIRCULAR))))
    for mesh in (["pod", 1], [1, 4]):
        for impl in ("auto", "xla"):
            cases.append(dict(key=f"audit_{impl}_{mesh[0]}{mesh[1]}",
                              kind="audit", mesh=mesh, blocks=AUDIT_BLOCKS,
                              fields=dataclasses.asdict(_fm_model(impl))))
    return cases, inputs


CASES, INPUTS = _cases()
BY_KEY = {c["key"]: c for c in CASES}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_shard_ranks.spawn(tmp_path_factory.mktemp("pod"), CASES,
                                   INPUTS, world=4, local_world=2)


def _coords(ranks, mesh):
    return [tuple(int(v) for v in r[f"coords:{json.dumps(mesh)}"])
            for r in ranks]


@pytest.mark.parametrize("cph,shape", [(1, (2, 2)), (2, (4, 1))])
def test_pod_mesh_is_host_major(ranks, cph, shape):
    """Rank r = host * 2 + local rank sits at divmod(r, time): every
    channel row lies on one host, so the time axis never crosses one."""
    coords = _coords(ranks, ["pod", cph])
    c, t = shape
    assert coords == [divmod(r, t) for r in range(4)]
    for r, (ci, _) in enumerate(coords):
        assert ci // (c // 2) == r // 2     # the row's host is the rank's


def _gather(ranks, mesh, key):
    c, t = 0, 0
    tiles = {}
    for r, (ci, s) in zip(ranks, _coords(ranks, mesh)):
        tiles[(ci, s)] = r[key]
        c, t = max(c, ci + 1), max(t, s + 1)
    return np.concatenate([np.concatenate([tiles[(ci, s)] for s in range(t)],
                                          axis=-1) for ci in range(c)])


def _single_steps():
    """(JAX's audio per step, the port's) over the two blocks."""
    jm = _fm_model()
    tm = fm_channelizer_from_fields(dataclasses.asdict(jm), device="cpu")
    js, ts, jout, tout = jm.init(), tm.init(), [], []
    step = jax.jit(jm.step)
    for b in range(2):
        re = INPUTS["rf.re"][b * BLOCK:(b + 1) * BLOCK]
        im = INPUTS["rf.im"][b * BLOCK:(b + 1) * BLOCK]
        js, y = step(js, JCA(jnp.asarray(re), jnp.asarray(im)))
        jout.append(np.asarray(y))
        ts, y = tm.step(ts, TCA(torch.from_numpy(re), torch.from_numpy(im)))
        tout.append(y.numpy())
    return jout, tout


@pytest.mark.parametrize("cph", [1, 2])
def test_pod_mesh_fm_steps_match_single_chip(ranks, cph):
    """Two fused sharded FM steps across the two hosts against JAX's
    single-chip step (its XLA-path tolerance) and the port's own (the
    fused tolerance), after the first step's warm-up."""
    jout, tout = _single_steps()
    for b in range(2):
        got = _gather(ranks, ["pod", cph], f"fm_pod{cph}:audio{b}")
        skip = SKIP if b == 0 else 0
        np.testing.assert_allclose(got[:, skip:], jout[b][:, skip:],
                                   **UNFUSED)
        np.testing.assert_allclose(got[:, skip:], tout[b][:, skip:],
                                   **FUSED)


def test_qpsk256_loopback_across_hosts(ranks):
    """256 CIRCULAR streams over (4, 1): each host holds 128, and the
    table lookup and nearest-neighbour decisions come back exact."""
    got = _gather(ranks, ["pod", 2], "qpsk256:rx")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, INPUTS["sym"])


@pytest.mark.parametrize("key", [c["key"] for c in CASES
                                 if c["kind"] == "audit"])
def test_collective_volume_does_not_grow_with_n(ranks, key):
    """Elements a rank hands to collectives in one sharded FM step, at
    4096 and 16384 samples a block: the same, and O(halo + C). Fused: the
    (T-1+D)-sample planar edge and (C_l, 3) final states, all gathered;
    unfused: the (T-1) edge, the discriminator's one-sample edge and the
    IIR states gathered, the tails summed."""
    case = BY_KEY[key]
    mesh = case["mesh"]
    t = 2 if mesh[0] == "pod" else mesh[1]
    c_l = CHANNELS // (2 if mesh[0] == "pod" else mesh[0])
    if "auto" in key:
        want = [2 * (NUM_TAPS - 1 + DECIMATION) + 3 * c_l, 0]
    else:
        want = [2 * (NUM_TAPS - 1) + 2 * c_l + c_l,
                2 * c_l + 2 * (NUM_TAPS - 1)]
    for r in ranks:
        sent = [r[f"{key}:{n}"].tolist() for n in AUDIT_BLOCKS]
        assert sent[0] == sent[1] == want, (t, sent)


def test_nccl_refuses_more_local_ranks_than_cards(monkeypatch):
    """backend='nccl' raises its own error before any rendezvous when the
    host runs more local ranks than it has cards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: pytest.fail(
        "set_device reached"))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="2 local ranks .* on 1 card"):
        initialize("127.0.0.1:1", num_processes=2, process_id=1)
    assert not torch.distributed.is_initialized()


def test_initialize_names_its_transport(monkeypatch):
    """No transport is chosen silently: another backend name raises; NCCL
    without CUDA raises; an address needs the world's size and rank."""
    with pytest.raises(ValueError, match="backend must be"):
        initialize("127.0.0.1:1", 1, 0, backend="mpi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        initialize("127.0.0.1:1", 1, 0)
    with pytest.raises(ValueError, match="num_processes and process_id"):
        initialize("127.0.0.1:1", backend="gloo")
    assert not torch.distributed.is_initialized()
