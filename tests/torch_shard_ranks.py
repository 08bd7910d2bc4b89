"""Rank program of the distributed port's CPU tests.

``test_torch_parallel.py`` and ``test_torch_multihost.py`` spawn it as
gloo ranks on the CPU, ``test_torch_cuda.py`` as ranks on the card (NCCL
on a world of one, gloo for ranks that share it). Each rank imports only
the port (no JAX), reads the cases (``cases.json``) and their numpy
inputs (``inputs.npz``) from a work directory, runs every case over its
mesh with its own shard, and writes its tiles, states and kernel launches
to ``rank<r>.npz`` there. Run as

    python tests/torch_shard_ranks.py WORKDIR RANK WORLD [--port PORT]
        [--backend gloo|nccl] [--device cpu|cuda]

With a port the group rendezvouses at tcp://127.0.0.1:PORT; without it at
env://, from the variables torchrun sets (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE).

``spawn`` starts WORLD ranks of it, waits for them with a time limit and
returns their results.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from gsdr_tpu_torch.carray import ComplexArray
from gsdr_tpu_torch.kernels.am_chain import am_chain, pfb_am_chain
from gsdr_tpu_torch.kernels.fm_chain import fm_chain, pfb_fm_chain
from gsdr_tpu_torch.kernels.iir import iir_kernel
from gsdr_tpu_torch.kernels.qpsk256 import qpsk256_kernel
from gsdr_tpu_torch.parallel import (
    initialize,
    left_halo,
    make_mesh,
    make_pod_mesh,
    make_sharded_am_step,
    make_sharded_fm_step,
    make_sharded_iir_step,
    make_sharded_qpsk256_modem,
    make_sharded_qpsk_modem,
    right_halo,
    sharded_fir,
    sharded_iir,
)
from gsdr_tpu_torch.utils.convert import (
    am_receiver_from_fields,
    fm_channelizer_from_fields,
    qpsk256_modem_from_fields,
    qpsk_modem_from_fields,
    state_to_numpy,
)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
KERNELS = {"fm_chain": fm_chain, "pfb_fm_chain": pfb_fm_chain,
           "am_chain": am_chain, "pfb_am_chain": pfb_am_chain,
           "qpsk256": qpsk256_kernel, "iir": iir_kernel}


def _tile(a, mesh):
    """This rank's tile of a global (R, N) array: rows over 'channel'
    (all rows when R does not split), columns over 'time'; a 1-D array
    splits over 'time' alone."""
    c, t = mesh.shape["channel"], mesh.shape["time"]
    ci, s = mesh.coords["channel"], mesh.coords["time"]
    n_l = a.shape[-1] // t
    cols = a[..., s * n_l:(s + 1) * n_l]
    if a.ndim == 1 or a.shape[0] % c:
        return np.ascontiguousarray(cols)
    r_l = a.shape[0] // c
    return np.ascontiguousarray(cols[ci * r_l:(ci + 1) * r_l])


def _rows(a, mesh):
    """This rank's rows of a per-channel array (R, ...)."""
    c, ci = mesh.shape["channel"], mesh.coords["channel"]
    r_l = a.shape[0] // c
    return np.ascontiguousarray(a[ci * r_l:(ci + 1) * r_l])


def _planar(inputs, name, pick=lambda a: a):
    return ComplexArray(torch.from_numpy(pick(inputs[name + ".re"])),
                        torch.from_numpy(pick(inputs[name + ".im"])))


def _put(out, key, x):
    if isinstance(x, ComplexArray):
        out[key + ".re"] = x.re.cpu().numpy()
        out[key + ".im"] = x.im.cpu().numpy()
    elif isinstance(x, torch.Tensor):
        out[key] = x.cpu().numpy()
    else:
        out[key] = np.asarray(x)


def _halo(case, mesh, inputs, out, device):
    fn = left_halo if case["kind"] == "left_halo" else right_halo
    if case["planar"]:
        x = _planar(inputs, case["x"], lambda a: _tile(a, mesh))
        fill = None if case["fill"] is None else _planar(
            inputs, case["fill"], lambda a: _rows(a, mesh))
    else:
        x = torch.from_numpy(_tile(inputs[case["x"]], mesh))
        fill = None if case["fill"] is None else torch.from_numpy(
            _rows(inputs[case["fill"]], mesh))
    _put(out, case["key"], fn(x, mesh, case["halo"], fill=fill))


def _fir(case, mesh, inputs, out, device):
    x = _planar(inputs, case["x"], lambda a: _tile(a, mesh))
    tail = None if case["tail"] is None else _planar(
        inputs, case["tail"], lambda a: _rows(a, mesh))
    _put(out, case["key"], sharded_fir(x, case["taps"], mesh,
                                       case["decimation"], tail=tail))


def _iir(case, mesh, inputs, out, device):
    x = torch.from_numpy(_tile(inputs[case["x"]], mesh))
    zi = torch.from_numpy(inputs[case["zi"]])
    y, zf = sharded_iir(case["b"], case["a"], x, zi, mesh)
    _put(out, case["key"] + ":y", y)
    _put(out, case["key"] + ":zf", zf)


def _stream(case, mesh, inputs, out, device):
    """Segments of (model fields, steps) over one sharded stream; the
    state carries from segment to segment."""
    build, make = ((fm_channelizer_from_fields, make_sharded_fm_step)
                   if case["kind"] == "fm" else
                   (am_receiver_from_fields, make_sharded_am_step))
    re, im = inputs[case["rf"] + ".re"], inputs[case["rf"] + ".im"]
    n, t, s = case["block"], mesh.shape["time"], mesh.coords["time"]
    n_l, b = n // t, 0
    state = None
    for fields, steps in case["segments"]:
        step = make(build(fields, device=device), mesh)
        state = step.init() if state is None else state
        for _ in range(steps):
            blk = slice(b * n + s * n_l, b * n + (s + 1) * n_l)
            state, audio = step(state, ComplexArray(
                torch.from_numpy(re[blk]).to(device),
                torch.from_numpy(im[blk]).to(device)))
            _put(out, f"{case['key']}:audio{b}", audio)
            b += 1
    for i, leaf in enumerate(state_to_numpy(state)):
        if isinstance(leaf, tuple):
            out[f"{case['key']}:state{i}.re"], \
                out[f"{case['key']}:state{i}.im"] = leaf
        else:
            out[f"{case['key']}:state{i}"] = leaf


def _modem(case, mesh, inputs, out, device):
    build, make = ((qpsk256_modem_from_fields, make_sharded_qpsk256_modem)
                   if case["kind"] == "qpsk256" else
                   (qpsk_modem_from_fields, make_sharded_qpsk_modem))
    tx, rx = make(build(case["fields"], device=device), mesh)
    samples = tx(torch.from_numpy(_tile(inputs[case["symbols"]], mesh)))
    _put(out, case["key"] + ":tx", samples)
    _put(out, case["key"] + ":rx", rx(samples))


def _audit(case, mesh, inputs, out, device):
    """Elements handed to collectives by one sharded FM step, after a
    first step, at each block length."""
    model = fm_channelizer_from_fields(case["fields"], device=device)
    step = make_sharded_fm_step(model, mesh)
    n_l = None
    for n in case["blocks"]:
        n_l = n // mesh.shape["time"]
        rf = ComplexArray(torch.ones(n_l, device=device),
                          torch.zeros(n_l, device=device))
        state, _ = step(step.init(), rf)
        before = dict(mesh.sent)
        step(state, rf)
        out[f"{case['key']}:{n}"] = np.array(
            [mesh.sent[k] - before[k] for k in ("all_gather", "all_reduce")])


def _compiled(case, mesh, inputs, out, device):
    """The sharded FM and AM steps of the case's fields and a
    make_sharded_iir_step, each eager and through compile_step over the
    same blocks from the same state: every output, the final state and
    the elements handed to collectives, of each run."""
    from gsdr_tpu_torch.utils.compile import compile_step

    fm = make_sharded_fm_step(
        fm_channelizer_from_fields(case["fm"], device=device), mesh)
    am = make_sharded_am_step(
        am_receiver_from_fields(case["am"], device=device), mesh)
    iir = make_sharded_iir_step(case["b"], case["a"], mesh)
    t, s = mesh.shape["time"], mesh.coords["time"]
    for name, step, state0, rf in (
            ("fm", fm, fm.init(), case["rf_fm"]),
            ("am", am, am.init(), case["rf_am"]),
            ("iir", iir, iir.init(), case["x"])):
        n_l = case["block"] // t
        blocks = []
        for b in range(case["steps"]):
            cols = slice(b * case["block"] + s * n_l,
                         b * case["block"] + (s + 1) * n_l)
            blocks.append(torch.from_numpy(inputs[rf][cols]).to(device)
                          if name == "iir" else ComplexArray(
                              torch.from_numpy(inputs[rf + ".re"][cols])
                              .to(device),
                              torch.from_numpy(inputs[rf + ".im"][cols])
                              .to(device)))
        for how, run in (("eager", step), ("compiled", compile_step(step))):
            before = dict(mesh.sent)
            state = state0
            for b, blk in enumerate(blocks):
                state, y = run(state, blk)
                _put(out, f"{case['key']}:{name}:{how}:out{b}", y)
            leaves = state if isinstance(state, tuple) else (state,)
            for i, leaf in enumerate(leaves):
                _put(out, f"{case['key']}:{name}:{how}:state{i}", leaf)
            out[f"{case['key']}:{name}:{how}:sent"] = np.array(
                [mesh.sent[k] - before[k] for k in ("all_gather",
                                                     "all_reduce")])


RUN = {"left_halo": _halo, "right_halo": _halo, "fir": _fir, "iir": _iir,
       "fm": _stream, "am": _stream, "qpsk256": _modem, "qpsk": _modem,
       "audit": _audit, "compiled": _compiled}


def _mesh(spec, device):
    if spec[0] == "pod":
        return make_pod_mesh(channel_per_host=spec[1], device=device)
    return make_mesh(spec[0], spec[1], device=device)


def main(workdir, rank, world, port=None, backend="gloo", device="cpu"):
    workdir = Path(workdir)
    cases = json.loads((workdir / "cases.json").read_text())
    inputs = dict(np.load(workdir / "inputs.npz"))
    if port is None:
        initialize(backend=backend)
    else:
        initialize(f"127.0.0.1:{port}", world, rank, backend=backend)
    out = {}
    try:
        meshes = {}
        for case in cases:  # every rank builds every mesh, in case order
            key = json.dumps(case["mesh"])
            if key not in meshes:
                meshes[key] = _mesh(case["mesh"], device)
                out[f"coords:{key}"] = np.array(
                    [meshes[key].coords["channel"],
                     meshes[key].coords["time"]])
            for k in KERNELS.values():
                k.launches = 0
            RUN[case["kind"]](case, meshes[key], inputs, out, device)
            if device == "cuda":
                torch.cuda.synchronize()
            out[case["key"] + ":launches"] = np.array(
                [k.launches for k in KERNELS.values()])
    finally:
        dist.destroy_process_group()
    np.savez(workdir / f"rank{rank}.npz", **out)


def spawn(workdir, cases, inputs, world=4, local_world=None,
          backend="gloo", device="cpu"):
    """Write the cases and inputs, run ``world`` ranks of this program
    (gloo on the CPU by default), and return each rank's results (a list
    of dicts; ``<case>:launches`` counts each kernel of ``KERNELS`` in
    that case).

    With ``local_world`` the ranks rendezvous at env:// as torchrun's
    would, ``local_world`` to a "host" (LOCAL_RANK, LOCAL_WORLD_SIZE);
    otherwise at a tcp:// address. The rendezvous port comes from a free
    socket; a rank that fails or outlives the time limit fails the call,
    and every rank is stopped."""
    workdir = Path(workdir)
    (workdir / "cases.json").write_text(json.dumps(cases))
    np.savez(workdir / "inputs.npz", **inputs)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        cmd = [sys.executable, __file__, str(workdir), str(r), str(world),
               "--backend", backend, "--device", device]
        renv = dict(env)
        if local_world is None:
            cmd += ["--port", str(port)]
        else:
            renv.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                        WORLD_SIZE=str(world), RANK=str(r),
                        LOCAL_RANK=str(r % local_world),
                        LOCAL_WORLD_SIZE=str(local_world))
        procs.append(subprocess.Popen(cmd, env=renv, cwd=ROOT,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, log) for r, (p, log)
              in enumerate(zip(procs, logs)) if p.returncode != 0]
    if failed:
        raise RuntimeError("ranks failed:\n" + "\n".join(
            f"rank {r} exit {rc}:\n{log}" for r, rc, log in failed))
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(world)]


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("workdir")
    parser.add_argument("rank", type=int)
    parser.add_argument("world", type=int)
    parser.add_argument("--port", type=int)
    parser.add_argument("--backend", default="gloo")
    parser.add_argument("--device", default="cpu")
    a = parser.parse_args()
    main(a.workdir, a.rank, a.world, a.port, a.backend, a.device)
