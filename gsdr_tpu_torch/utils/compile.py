"""The compiled step, the port's counterpart of ``jax.jit`` for streaming
steps.

``compile_step(step)`` returns a callable with the contract of
``step(state, block) -> (state, out)``. On a CUDA block it captures the
step once per signature as one ``torch.cuda.CUDAGraph`` and replays it; on
a CPU block it runs the step as it is, the port's plain path.

  - **Signature**, jit's trace cache: the state's tree structure
    (``utils/tree.py``), each leaf's shape, dtype, stride and device (a
    Python scalar leaf by its value), the block's alike, and the float32
    settings a route reads (TF32 for matmuls and cuDNN). A new signature,
    a new block length say, captures a new graph. What the step reads from
    its closure (a model's fields, its route chosen at construction, its
    ``'auto'`` choices) is frozen at the capture, as under jit's trace.
  - **Capture.** The step first runs once eagerly on a side stream, so
    that every table and scratch a kernel wrapper builds on first use is
    built outside the capture; then the capture, on that stream, into
    static buffers of the state and the block. The graph ends by copying
    the new state into the state's buffers.
  - **Replay.** Each call copies the block into its buffer, and the state
    into its buffers unless it is the state the last replay returned (its
    leaves are those buffers), then replays the graph. A call with the
    state the last call returned and a block of the same spec takes that
    graph without forming the signature.
  - **Ownership.** ``out`` is the caller's own, a copy of the graph's
    output, as a ``jax.jit`` result is. The returned state is the graph's
    buffers: valid until the next call of the compiled step.
  - **No fallback.** On a CUDA block a step that cannot be captured (a
    host sync such as ``.item()``, an operation a graph cannot hold)
    raises with the capture's error; it never runs eagerly in its place.
    A step whose mesh (``step.mesh``, as the sharded steps of
    ``parallel/`` have) runs over gloo raises before its warm-up: gloo's
    collectives are host calls that no graph holds. Over NCCL the
    collectives are captured.
  - **Tracing** (``utils/profiling.py``). With tracing on, a call
    records its spans (``compiled.call``; on the card its children
    ``compiled.lookup``, with ``compiled.capture`` inside it for a new
    graph, ``compiled.copy_in``, ``compiled.replay``, ``compiled.clone``)
    and counts its captures. The spans wrap the code that runs untraced;
    with tracing off each site costs one check. The device-counter level
    is part of the signature's settings.
  - **Host-side counts.** What a step counts on the host while it runs
    (``mesh.sent``, through ``tally``) is counted once a call: not in the
    warm-up, and for the capture at every replay, so that it reads the
    same whether the step runs eager or compiled. The kernels' launch
    counters count the warm-up's and the capture's launches and no
    replay.

``compile_step(step, steps=k)`` captures k chained steps on the same block
as one graph (the counterpart of ``gsdr_tpu/utils/timing.py``'s
``k_steps``): it returns the state after k steps and the k-th output.
The replays of one compiled step, and the eager calls whose kernels share
its scratch (B5), run on one stream at a time.
"""

import contextlib
import contextvars

import torch

from gsdr_tpu_torch.kernels.chain import graph_refs
from gsdr_tpu_torch.utils import profiling
from gsdr_tpu_torch.utils.tree import tree_flatten, tree_unflatten

_SCALARS = (bool, int, float, complex, str)
_tallies = contextvars.ContextVar("graph_tallies", default=None)


def tally(counter, key, n):
    """Add ``n`` to ``counter[key]``, a count the host keeps of the work a
    step enqueues: at once in an eager call; inside ``compile_step``'s
    warm-up not at all, and inside its capture at every replay of the
    graph (see the module's docstring)."""
    log = _tallies.get()
    if log is None:
        counter[key] += n
    else:
        log.append((counter, key, n))


@contextlib.contextmanager
def _tallying(log):
    token = _tallies.set(log)
    try:
        yield
    finally:
        _tallies.reset(token)


def check_capturable(step, block):
    """Raise where a CUDA graph cannot hold ``step`` on ``block``: a CUDA
    block whose step's mesh (its ``mesh``, or its object's for a bound
    method) runs its collectives over gloo."""
    mesh = getattr(step, "mesh", None)
    if mesh is None:
        mesh = getattr(getattr(step, "__self__", None), "mesh", None)
    if mesh is not None and getattr(mesh, "backend", None) == "gloo" \
            and device_of(block).type == "cuda":
        raise RuntimeError(
            "compile_step: the step's mesh runs its collectives over gloo, "
            "which a CUDA graph cannot capture; compile a step over an "
            "NCCL mesh (one card a rank), or call the gloo step eagerly")


def device_of(block):
    """The device of a block (a tensor or ComplexArray); the CPU for
    anything without one."""
    dev = getattr(block, "device", None)
    return torch.device(dev) if dev is not None else torch.device("cpu")


def _spec(leaf):
    """A leaf's part of the signature."""
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), leaf.dtype, leaf.device, leaf.stride())
    if isinstance(leaf, _SCALARS):
        return (type(leaf), leaf)
    raise TypeError(f"compile_step: a leaf of type {type(leaf).__name__}; "
                    "states and blocks hold tensors and Python scalars")


def _settings():
    """The global settings that a route reads at the capture: float32's,
    and whether the kernels count (tracing at ``profiling.COUNTERS``)."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision(),
            profiling.level >= profiling.COUNTERS)


def signature(state, block):
    """(key, state leaves, block leaves): the key of the graph that
    ``compile_step`` replays for (state, block), jit's cache key (see the
    module's docstring)."""
    s_leaves, s_def = tree_flatten(state)
    b_leaves, b_def = tree_flatten(block)
    key = (s_def, tuple(map(_spec, s_leaves)), b_def,
           tuple(map(_spec, b_leaves)), _settings())
    return key, (s_leaves, s_def), (b_leaves, b_def)


def _static(leaf):
    """A buffer of the leaf's spec holding its value (a scalar as it is)."""
    if isinstance(leaf, torch.Tensor):
        buf = torch.empty_like(leaf)
        buf.copy_(leaf)
        return buf
    return leaf


def _copy_in(bufs, leaves):
    for buf, leaf in zip(bufs, leaves):
        if isinstance(buf, torch.Tensor) and leaf is not buf:
            buf.copy_(leaf)


class _Graph:
    """One captured signature: its graph, static buffers and outputs."""

    def __init__(self, run, warm, state, block, stream):
        s_leaves, self.state_def = state
        b_leaves, self.block_def = block
        self.state_in = [_static(x) for x in s_leaves]
        self.block_in = [_static(x) for x in b_leaves]
        self.refs = []      # what the captured launches need kept alive
        self.graph = torch.cuda.CUDAGraph()
        st = tree_unflatten(self.state_def, self.state_in)
        blk = tree_unflatten(self.block_def, self.block_in)
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
        self.tallies = []   # the host-side counts of one replay
        with torch.cuda.stream(stream), _tallying([]):
            warm(st, blk)
        try:
            with graph_refs(self.refs), _tallying(self.tallies), \
                    torch.cuda.graph(self.graph, stream=stream):
                new_state, out = run(st, blk)
                self._loop_back(new_state)
        except Exception as exc:
            first = exc.__context__ or exc
            raise RuntimeError(
                "compile_step: the step cannot be captured in a CUDA graph "
                f"({type(first).__name__}: {first}); a compiled step holds "
                "no host sync and no operation a graph cannot replay") \
                from exc
        cur.wait_stream(stream)
        self.out, self.out_def = tree_flatten(out)
        # what a call compares to take this graph without the signature
        self.state_tree = st
        self.block_tree = blk
        self.block_specs = tuple(map(_spec, self.block_in))
        self.settings = _settings()

    def takes(self, state, block):
        """The flattened block when (state, block) has this graph's
        signature and state is the tree this graph returns, else None."""
        if state is not self.state_tree or _settings() != self.settings:
            return None
        if block is self.block_tree:
            return self.block_in
        leaves, treedef = tree_flatten(block)
        if treedef != self.block_def or \
                tuple(map(_spec, leaves)) != self.block_specs:
            return None
        return leaves

    def _loop_back(self, new_state):
        """Copy the step's new state into the state's buffers (captured)."""
        leaves, treedef = tree_flatten(new_state)

        def shape(x):
            if isinstance(x, torch.Tensor):
                return (tuple(x.shape), x.dtype, x.device)
            return _spec(x)

        if treedef != self.state_def or \
                list(map(shape, leaves)) != list(map(shape, self.state_in)):
            raise ValueError(
                "compile_step: the step returns a state of another "
                "structure, shape or dtype (or another Python value) than "
                "it takes")
        inputs = {t.untyped_storage().data_ptr()
                  for t in self.state_in + self.block_in
                  if isinstance(t, torch.Tensor)}
        srcs = []
        for buf, x in zip(self.state_in, leaves):
            if isinstance(x, torch.Tensor) and x is not buf and \
                    x.untyped_storage().data_ptr() in inputs:
                x = x.clone()    # a view of an input: read before any write
            srcs.append(x)
        _copy_in(self.state_in, srcs)

    def replay(self, s_leaves, b_leaves, rec=None):
        """Copy the leaves in, replay, clone ``out``; with the tracing
        session's recorder ``rec``, each part in its span."""
        if rec is not None:
            i = rec.open("compiled.copy_in")
        _copy_in(self.state_in, s_leaves)
        _copy_in(self.block_in, b_leaves)
        if rec is not None:
            rec.close(i)
            i = rec.open("compiled.replay")
        self.graph.replay()
        if rec is not None:
            rec.close(i)
        for counter, key, n in self.tallies:
            counter[key] += n
        if rec is not None:
            i = rec.open("compiled.clone")
        out = [x.clone() if isinstance(x, torch.Tensor) else x
               for x in self.out]
        if rec is not None:
            rec.close(i)
        return self.state_tree, tree_unflatten(self.out_def, out)


class CompiledStep:
    """``step`` compiled: see the module's docstring. ``graphs`` is the
    number of signatures captured."""

    def __init__(self, step, steps=1):
        if int(steps) < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        self.step = step
        self.steps = int(steps)
        self._graphs = {}
        self._streams = {}
        self._last = None

    @property
    def graphs(self):
        return len(self._graphs)

    def _run(self, state, block):
        out = None
        for _ in range(self.steps):
            state, out = self.step(state, block)
        return state, out

    def _graph(self, state, block):
        """The graph of (state, block)'s signature, captured if new (in a
        ``compiled.capture`` span, counted, where tracing is on), with the
        flattened state and block."""
        check_capturable(self.step, block)
        key, flat_state, flat_block = signature(state, block)
        g = self._graphs.get(key)
        if g is None:
            rec = profiling.recorder() if profiling.level else None
            if rec is not None:
                rec.counts["compiled.capture"] += 1
                i = rec.open("compiled.capture")
            dev = device_of(block)
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            stream = self._streams.get(dev)
            if stream is None:
                stream = self._streams[dev] = torch.cuda.Stream(dev)
            g = self._graphs[key] = _Graph(self._run, self.step, flat_state,
                                           flat_block, stream)
            if rec is not None:
                rec.close(i)
        return g, flat_state[0], flat_block[0]

    def __call__(self, state, block):
        rec = profiling.recorder() if profiling.level else None
        if rec is not None:
            call = rec.open("compiled.call", call=True)
        try:
            if device_of(block).type != "cuda":
                return self._run(state, block)
            if rec is not None:
                i = rec.open("compiled.lookup")
            g = self._last
            b_leaves = None if g is None else g.takes(state, block)
            if b_leaves is None:
                g, s_leaves, b_leaves = self._graph(state, block)
                self._last = g
            else:                    # the state the last call returned
                s_leaves = ()
            if rec is not None:
                rec.close(i)
            return g.replay(s_leaves, b_leaves, rec)
        finally:
            if rec is not None:
                rec.close(call)

    def block_buffer(self, state, block):
        """The static block of (state, block)'s graph, captured if new: a
        caller that writes the next block there (a host-to-device copy)
        saves the replay its copy of the block."""
        return self._graph(state, block)[0].block_tree


def compile_step(step, steps=1):
    """``step(state, block) -> (state, out)`` compiled into CUDA graphs on
    the card (see the module's docstring); ``steps`` chained steps a
    graph."""
    return CompiledStep(step, steps)
