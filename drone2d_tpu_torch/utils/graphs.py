"""CUDA graphs of the port's hot loops: the card's counterpart of the JAX
package's compiled programs (`jax.jit` over a `lax.scan`).

A body is a function of no arguments that reads tensors it holds and
returns tensors: the same eager PyTorch calls, and fused-kernel launches,
that the eager path makes.  The tensors a body reads are static buffers,
whose storage never changes: the caller copies each call's inputs into
them (`copy_`).  On the card, `capture(graphs)` runs each body once to warm
up (autograd, Adam and the allocator set things up lazily), puts back the
tensors the warm-up changed in place, and records each body into a
`torch.cuda.CUDAGraph`, all sharing one private memory pool.  Calling a
`Graph` then replays its kernels with one host launch and returns what the
body returned at capture: static too, so the next replay overwrites it,
and a caller clones whatever it keeps.  A replay runs the kernels that eager
mode runs, on the same addresses, so a captured path is bit-equal to the
eager one.  A capture that fails raises; nothing runs eager in its place.

A body may draw from `torch.Generator`s (the reset templates, the action
noise, the shuffles), the ones its `Graph` is given.  The capture
registers each with its graph (`register_generator_state`), puts each
back after the warm-up as it puts back the tensors, and a replay then
draws what the body draws eagerly from the generator's state at that
moment (Philox at the same offsets) and advances the generator by the
same amount: captured and eager draws are bit-equal, and a generator
re-seeded on the host before a replay is drawn from anew.  A body that
draws from a generator its graph was not given fails at capture; on the
card a CPU generator raises.

On the CPU a `Graph` calls its body directly, over the same static
buffers: the caller's CPU path, which the tests exercise.

Kernel launch counts (`fused_sample_action.launches`,
`ppo_sgd_step.launches`) stay true under replay: the warm-up's launches
are real and count, the capture's launch nothing and are taken back out,
and each replay adds the number its capture recorded.

`GraphCache` holds a few captured programs by key and releases the oldest
when full, so that many configurations in one process do not pile up
memory pools; `ShapeGraph` holds one graph, made anew when the shapes of
its inputs change (the adapters' steps).

Each capture on the card is a `graphs.capture` span (`utils/profiling.py`)
with its cause (which program asked: `update`, `eval.runner`,
`eval.draws`, `shape_graph` or `other`), graphs, nodes and seconds, and
adds to the counters `graphs.captures` and `graphs.capture_s`, in all and
by cause (`graphs.captures[<cause>]`); a `GraphCache` counts its hits,
misses and evictions under `graph_cache.*` (or a name of its own).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import gc
import time
from typing import Callable, Iterable, List, Sequence

import torch

from drone2d_tpu_torch.ops.fused_policy import fused_sample_action
from drone2d_tpu_torch.ops.ppo_sgd import ppo_sgd_step
from drone2d_tpu_torch.utils import profiling

# the kernel wrappers whose `launches` count a replay must advance
COUNTED = (fused_sample_action, ppo_sgd_step)


# -- trees of tensors ---------------------------------------------------------


def leaves(tree) -> List:
    """The tensors of a tree of dataclasses, tuples, lists and dicts, in a
    fixed order; a None leaf is kept as None."""
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree):
    """`tree` with each tensor leaf replaced by fn(leaf); None stays None."""
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def clone(tree):
    """A contiguous copy of every tensor of `tree`, in storage of its own."""
    out = tree_map(lambda t: torch.empty_like(t, memory_format=torch.contiguous_format), tree)
    copy_(out, tree)
    return out


@torch.no_grad()
def copy_(dst, src) -> None:
    """Copy the tensors of `src` into the matching static tensors of `dst`
    (a leaf that is the same tensor is left as it is), one `_foreach_copy_`
    a dtype and device: a few launches for a whole env state."""
    got, want = leaves(dst), leaves(src)
    if len(got) != len(want):
        raise ValueError(f"trees of {len(got)} and {len(want)} leaves")
    groups = collections.defaultdict(lambda: ([], []))
    for d, s in zip(got, want):
        if (d is None) != (s is None):
            raise ValueError("trees disagree on an optional leaf")
        if d is not None and d is not s:
            ds, ss = groups[(d.dtype, s.dtype, d.device, s.device)]
            ds.append(d)
            ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def signature(tree) -> tuple:
    """The shapes, dtypes and devices of a tree's leaves (None kept): what
    a graph over static copies of it depends on."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype, t.device)
                 for t in leaves(tree))


def storage_key(tensors: Iterable[torch.Tensor]) -> tuple:
    """The addresses and shapes of `tensors`: a graph that reads or writes
    them in place is valid for exactly these storages."""
    return tuple((t.data_ptr(), tuple(t.shape)) for t in tensors)


def optimizer_tensors(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    """Every tensor of an optimizer's state, in parameter order."""
    return [v for group in opt.param_groups for p in group["params"]
            for v in opt.state.get(p, {}).values() if isinstance(v, torch.Tensor)]


# -- graphs -------------------------------------------------------------------


class Graph:
    """A body run as a CUDA graph on the card, called directly on the CPU
    (or on the card with `eager=True`, the caller's explicit reference),
    drawing from `generators` (none by default).

    `outputs` is what the body returned: at capture when captured (the
    static tensors each replay writes), else at the latest call.  A body may
    read another graph's `outputs` (read when it runs, so the captured body
    reads that graph's static tensors)."""

    def __init__(self, body: Callable, device: torch.device, *, eager: bool = False,
                 generators: Sequence[torch.Generator] = ()):
        self.body, self.device = body, torch.device(device)
        self.eager = eager or self.device.type == "cpu"
        self.generators = list(generators)  # the ones the body draws from
        self.graph = None
        self.outputs = None
        self.launches = 0         # kernel launches a replay makes
        self.launches_by = {}     # the same, by kernel wrapper
        self.nodes = None         # the captured graph's node count
        self.capture_s = 0.0      # seconds to record the body
        self.instantiate_s = 0.0  # seconds to instantiate the recorded graph

    def __call__(self):
        if self.eager:
            self.outputs = self.body()
            return self.outputs
        if self.graph is None:
            raise RuntimeError("Graph called before capture()")
        self.graph.replay()
        for wrapper in COUNTED:
            wrapper.launches += self.launches_by[wrapper]
        return self.outputs


@dataclasses.dataclass
class CaptureStats:
    """What a `capture` call cost: seconds of warm-up, recording and
    instantiation, the bytes the pool reserved, and each graph's nodes."""

    warmup_s: float
    capture_s: float
    instantiate_s: float
    pool_bytes: int
    nodes: List


def _restore_point(tensors: Sequence[torch.Tensor], optimizers: Sequence):
    """A function that puts `tensors` and the optimizers' state back as they
    are now.  State an optimizer creates after this point (Adam's lazy
    moments and step count) is set to zero, its initial value."""
    saved = [(t, t.detach().clone()) for t in tensors]
    before = [{id(v): v.detach().clone() for v in optimizer_tensors(opt)} for opt in optimizers]

    @torch.no_grad()
    def restore():
        for t, c in saved:
            t.detach().copy_(c)
        for opt, old in zip(optimizers, before):
            for v in optimizer_tensors(opt):
                if id(v) in old:
                    v.copy_(old[id(v)])
                else:
                    v.zero_()
    return restore


def capture(graphs: Sequence[Graph], *, restore: Sequence[torch.Tensor] = (),
            optimizers: Sequence = (), cause: str = "other") -> CaptureStats | None:
    """Warm up and capture `graphs`, in order, into one memory pool, for
    the program `cause` names (see the module's docstring), which the
    capture's span and counters carry.

    The warm-up runs each body once, in order, on a side stream; then the
    tensors of `restore`, the state of `optimizers` and the graphs'
    generators are put back as they were, so that the capture leaves the
    caller's state as it found it and the first replay draws what the
    eager path would.  Each graph's generators are registered with it
    before its recording.  Raises if a body cannot be captured (a host
    sync, a host-to-card copy, a generator its graph was not given).  Graphs that run
    eagerly (on the CPU, or asked to) are not captured: then it does
    nothing and returns None.

    A body may run NCCL collectives: the warm-up then also makes NCCL's
    communicator, which it creates lazily at the first collective, and the
    recording holds the collectives of every body in order, so every rank
    must capture the same bodies on the same call."""
    if any(g.eager for g in graphs):
        if not all(g.eager for g in graphs):
            raise ValueError("capture() takes graphs that all run eagerly or none")
        return None
    t0 = time.perf_counter()
    with profiling.span("graphs.capture", cause=cause) as span:
        stats = _capture(graphs, restore, optimizers)
        seconds = time.perf_counter() - t0
        span.set(graphs=len(graphs), nodes=sum(stats.nodes), warmup_s=stats.warmup_s,
                 capture_s=stats.capture_s, instantiate_s=stats.instantiate_s,
                 seconds=seconds)
    for key in ("", f"[{cause}]"):
        profiling.count("graphs.captures" + key)
        profiling.count("graphs.capture_s" + key, seconds)
    return stats


def _capture(graphs: Sequence[Graph], restore, optimizers) -> CaptureStats:
    """`capture`'s work on the card."""
    device = graphs[0].device
    generators = list({id(gen): gen for g in graphs for gen in g.generators}.values())
    for gen in generators:
        if gen.device.type != "cuda":
            raise ValueError(f"a CUDA graph draws from CUDA generators only, not a "
                             f"{gen.device.type} one")
    t0 = time.perf_counter()
    back = _restore_point(list(restore), list(optimizers))
    drawn = [(gen, gen.get_state()) for gen in generators]
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for g in graphs:
            g.outputs = g.body()
        back()
    for gen, at in drawn:
        gen.set_state(at)
    torch.cuda.current_stream(device).wait_stream(stream)
    torch.cuda.synchronize(device)
    warmup_s = time.perf_counter() - t0
    # torch.cuda.graph empties the allocator's cache as a capture opens: so
    # here, and the pool's bytes are what the captures reserved after it
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    pool = torch.cuda.graph_pool_handle()
    # a graph that the cyclic collector frees during a recording (an
    # adapter or program dropped earlier) invalidates that recording: so
    # collect now and not again until every graph is recorded
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        _record(graphs, pool, stream, device)
    finally:
        if collecting:
            gc.enable()
    record_s = sum(g.capture_s for g in graphs)
    inst_s = sum(g.instantiate_s for g in graphs)
    return CaptureStats(warmup_s, record_s, inst_s,
                        torch.cuda.memory_reserved(device) - reserved, [g.nodes for g in graphs])


def _record(graphs: Sequence[Graph], pool, stream, device) -> None:
    """Record each of `graphs` into `pool` on `stream` and instantiate it,
    with its launch counts, nodes and seconds."""
    for g in graphs:
        t0 = time.perf_counter()
        g.graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in g.generators:
            g.graph.register_generator_state(gen)
        counts = {w: w.launches for w in COUNTED}
        try:
            with torch.cuda.graph(g.graph, pool=pool, stream=stream):
                g.outputs = g.body()
        finally:
            # a capture launches nothing: its counts come back out
            g.launches_by = {w: w.launches - counts[w] for w in COUNTED}
            for w in COUNTED:
                w.launches = counts[w]
        g.launches = sum(g.launches_by.values())
        t1 = time.perf_counter()
        g.nodes = graph_nodes(g.graph)
        g.graph.instantiate()
        torch.cuda.synchronize(device)
        g.capture_s, g.instantiate_s = t1 - t0, time.perf_counter() - t1


@functools.cache
def _cu_graph_get_nodes():
    fn = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t))
    fn.restype = ctypes.c_int
    return fn


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a recorded graph (libcuda's cuGraphGetNodes)."""
    n = ctypes.c_size_t(0)
    err = _cu_graph_get_nodes()(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return int(n.value)


class ShapeGraph:
    """One graph over static copies of a tree of inputs, made (on the card:
    captured) at the first call and anew whenever the tree's shapes change,
    the old one released first: a step that resets may give new shapes, and
    that every other call replays.

    `make_body(inputs)` returns the body over the static copies `inputs`;
    `stepped(inputs)` the tensors of `inputs` that the body changes in
    place, which the capture's warm-up puts back; `generators` the ones the
    body draws from."""

    def __init__(self, make_body: Callable, stepped: Callable, device: torch.device,
                 generators: Sequence[torch.Generator] = ()):
        self.make_body, self.stepped, self.device = make_body, stepped, torch.device(device)
        self.generators = list(generators)
        self.shapes = self.graph = self.inputs = None

    def __call__(self, tree):
        """Copy `tree` into the static inputs (a leaf that already is one is
        not copied) and run the graph -> (its outputs, the static inputs)."""
        shapes = signature(tree)
        if self.graph is None or shapes != self.shapes:
            self.graph = self.inputs = None  # release the old graph's pool first
            inputs = clone(tree)
            graph = Graph(self.make_body(inputs), self.device, generators=self.generators)
            capture([graph], restore=[t for t in leaves(self.stepped(inputs)) if t is not None],
                    cause="shape_graph")
            self.shapes, self.graph, self.inputs = shapes, graph, inputs
        else:
            copy_(self.inputs, tree)
        return self.graph(), self.inputs


class GraphCache:
    """Captured programs by key, at most `size` of them: adding one to a full
    cache releases the least recently used (its graphs and memory pool).
    It counts the programs made (`captures`), and the recorder its hits,
    misses and evictions (`<counter>.*`: `graph_cache.*` unless it is
    given a name).

    A key names what a program depends on: the shapes of its inputs, the
    storages it reads and writes in place (`storage_key`) and the
    generators its graphs are bound to (the objects themselves).  A program
    holds those tensors and generators, so no other can take their
    addresses while it is cached."""

    def __init__(self, size: int = 2, counter: str = "graph_cache"):
        self.size, self.counter = size, counter
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.captures = 0  # programs made, over the cache's life

    def get(self, key):
        """The program under `key`, or None."""
        program = self.entries.get(key)
        if program is None:
            profiling.count(f"{self.counter}.misses")
        else:
            profiling.count(f"{self.counter}.hits")
            self.entries.move_to_end(key)
        return program

    def put(self, key, program) -> None:
        released = False
        while len(self.entries) >= self.size:
            self.entries.popitem(last=False)
            released = True
            profiling.count(f"{self.counter}.evictions")
        self.entries[key] = program
        self.captures += 1
        if released and torch.cuda.is_available():
            torch.cuda.empty_cache()  # hand the released pools back to the card
