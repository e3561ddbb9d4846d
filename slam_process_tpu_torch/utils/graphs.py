"""CUDA graphs of the port's fixed-shape programs.

The JAX package runs its session pipeline and its stream's window step as
one compiled executable per static shape (``jax.jit``, cached per byte
bucket), with nothing issued from the host between stages.  On a CUDA
device the port's counterpart is a CUDA graph: the program's kernels and
PyTorch operations captured once and replayed by one launch.
``GraphRunner`` owns one such program:

  * its static inputs: copies of the first call's inputs, into which every
    later call copies its own (``load``);
  * the first ``run`` executes the program once on the device's capture
    stream (the warm-up: kernel builds, the kernels' lazily made scratch and
    first allocations happen there, outside the capture, as
    ``torch.cuda.graphs`` requires), then captures it; every later ``run``
    replays the graph on the caller's current stream.  So each ``run`` does
    the program's work once, and a program that updates state in place can
    be run this way;
  * its static outputs (``outputs``), which every replay overwrites;
  * the kernel wrappers' launch counters: a replay calls no wrapper, so each
    replay adds to every ``LAUNCHES`` (and ``LAUNCHES_BY_K``, where a
    wrapper keeps one) what its capture recorded, and the capture, which ran
    nothing, takes its own additions back;
  * ``pool_bytes`` (the graph's memory pool) and ``capture_ms``;
  * a span ``slam.graph.capture`` (``utils/profiling.annotate``) around the
    warm-up and capture, so that a capture shows in a profiler trace.

A runner's graph allocates from a private memory pool, or from ``pool``
(``new_pool()``), which it shares with the other graphs given the same one.
Share a pool only among the graphs of one program that replay in order on
one stream and keep nothing alive but the first graph's static outputs (a
session's round: its graph before the count read, then one of those after
it): a later capture may take a block that an earlier graph's replay
writes as scratch, so graphs that share a pool must never both hold live
outputs, and a graph captured after the others were dropped needs a new
pool.  ``pool_bytes`` is then the shared pool's.

Its device is a CUDA device: it refuses CPU tensors at construction
(``load`` also takes host tensors and copies them into the static
inputs); on the CPU callers run the eager body.  A capture
that fails raises; nothing falls back to the eager body.  The one retry: a
dead graph's private pool stays cached in the allocator, which frees
cached memory to satisfy an allocation only outside a capture, so a
capture that runs out of memory empties the cache (``empty_cache``, which
waits for the device) and captures once more.  ``torch.cuda.graph`` empties
it before every capture; a runner does so only when the capture needs it.  Replays of one
device's graphs share the kernels' scratch words of its capture stream, so
they must run in order on one stream, as the port's entry points run them.

``FlatOutputs`` packs a program's outputs into one byte buffer, so that a
caller who must not hand out the static outputs clones one tensor.

``GraphProgram`` is a cached ``jax.jit``: a body with one ``GraphRunner``
per input signature (a bounded number, the least recently called dropped
first), static inputs loaded from device tensors or, through pinned
memory, from host arrays, and each call's outputs its own (a clone of the
flat buffer, or one host copy of it).  ``program_cache`` is the
``lru_cache`` of the functions that make programs (one per estimator key,
as the JAX package caches its jitted functions), and ``clear_programs``
empties them all.

The port's counterpart of the JAX package's ``jax.jit`` with
``utils/cache.py``; a graph lives in its process, so there is no persistent
cache to port.
"""

from __future__ import annotations

import functools
import inspect
import time
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from slam_process_tpu_torch.utils.profiling import annotate

_KERNEL_MODULES = ("cuda_decode", "cuda_correct", "cuda_raster", "cuda_sweep_sums",
                   "cuda_compact", "cuda_tracker", "cuda_nnls")


@functools.lru_cache(maxsize=None)
def capture_stream(index: int) -> torch.cuda.Stream:
    """The side stream on which every runner of CUDA device ``index`` warms
    up and captures (one per device: the kernels' scratch words, keyed by
    stream, are then made once, by the first warm-up)."""
    return torch.cuda.Stream(device=index)


def _kernel_modules() -> list:
    import importlib

    return [importlib.import_module(f"slam_process_tpu_torch.ops.{m}") for m in _KERNEL_MODULES]


def new_pool() -> tuple:
    """A memory pool id for ``GraphRunner(pool=...)`` (module docstring)."""
    return torch.cuda.graph_pool_handle()


def pool_bytes(pool) -> int:
    """Bytes of the caching allocator's segments that belong to a graph's
    private pool (``CUDAGraph.pool()``)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


class GraphRunner:
    """``fn(*inputs)`` as one CUDA graph, captured on the first ``run``
    (module docstring).  ``inputs`` are CUDA tensors on one device (the
    static inputs start as their copies); with no inputs, ``device`` names
    the device and ``fn`` reads tensors it owns.  ``pool``: a shared
    memory pool (``new_pool``), or None for a private one."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor] = (),
                 device: Optional[torch.device] = None, pool: Optional[tuple] = None):
        inputs = tuple(inputs)
        for x in inputs:
            if not isinstance(x, torch.Tensor) or not x.is_cuda:
                raise ValueError("a CUDA graph takes CUDA tensors; on the CPU run the eager "
                                 f"body (got {getattr(x, 'device', type(x).__name__)})")
        devices = {x.device for x in inputs} | ({torch.device(device)} if device else set())
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError("a CUDA graph runs on one CUDA device, got "
                             f"{sorted(map(str, devices))}")
        self.device = next(iter(devices))
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._fn = fn
        self._pool = pool
        self.inputs = tuple(x.clone() for x in inputs)
        self.outputs = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: dict = {}        # kernel module -> launches a replay makes
        self.launches_by_k: dict = {}   # kernel module -> {K: launches} a replay makes
        self.capture_ms: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self.replays = 0
        self._scratch: list = []

    def load(self, *inputs) -> None:
        """Copy ``inputs`` into the static inputs, in order on the current
        stream: tensors of the static shape and dtype on the device or on
        the CPU (copied through pinned memory without a host wait), or a
        Python int for a 0-d input."""
        if len(inputs) != len(self.inputs):
            raise ValueError(f"expected {len(self.inputs)} inputs, got {len(inputs)}")
        for static, x in zip(self.inputs, inputs):
            if isinstance(x, int) and static.dim() == 0:
                static.fill_(x)
                continue
            if (isinstance(x, torch.Tensor) and x.device.type == "cpu"
                    and x.dtype == static.dtype and x.shape == static.shape):
                static.copy_(x if x.is_pinned() else x.contiguous().pin_memory(),
                             non_blocking=True)
                continue
            if (not isinstance(x, torch.Tensor) or x.device != self.device
                    or x.dtype != static.dtype or x.shape != static.shape):
                raise ValueError(f"a graph input must be {static.dtype}{list(static.shape)} on "
                                 f"{self.device}, got {getattr(x, 'dtype', type(x).__name__)}"
                                 f"{list(getattr(x, 'shape', []))} on "
                                 f"{getattr(x, 'device', None)}")
            static.copy_(x)

    def __call__(self, *inputs):
        """``load(*inputs)``, then ``run()``."""
        self.load(*inputs)
        return self.run()

    def run(self):
        """The program once on the static inputs: the first run warms up and
        captures (returning the warm-up's outputs), every later one replays
        (returning the static outputs)."""
        if self.graph is None:
            with annotate("slam.graph.capture"):
                return self._warm_up_and_capture()
        with torch.cuda.device(self.device):
            self.graph.replay()
        for m, n in self.launches.items():
            m.LAUNCHES += n
        for m, by_k in self.launches_by_k.items():
            for k, n in by_k.items():
                m.LAUNCHES_BY_K[k] = m.LAUNCHES_BY_K.get(k, 0) + n
        self.replays += 1
        return self.outputs

    def _warm_up_and_capture(self):
        from slam_process_tpu_torch.ops import _build

        caller = torch.cuda.current_stream(self.device)
        side = capture_stream(self.device.index)
        side.wait_stream(caller)
        modules = _kernel_modules()
        with torch.cuda.stream(side):
            out = self._fn(*self.inputs)                      # the warm-up: this run's work
            t0 = time.perf_counter()
            try:
                captured = self._capture(modules)
            except torch.OutOfMemoryError:
                captured = None         # the failed capture is freed with its traceback
            if captured is None:
                torch.cuda.empty_cache()                      # dead graphs' pools (docstring)
                t0 = time.perf_counter()
                captured = self._capture(modules)
            graph, static, counted, counted_k = captured
            self.capture_ms = (time.perf_counter() - t0) * 1e3
        caller.wait_stream(side)
        self.graph, self.outputs = graph, static
        self.launches = {m: n for m, n in zip(modules, counted) if n}
        self.launches_by_k = {m: by_k for m, by_k in counted_k.items() if by_k}
        # A later call may grow a scratch the graph was captured with: keep
        # the tensors it reads alive for as long as the graph lives.
        self._scratch = _build.scratch_tensors()
        self.pool_bytes = pool_bytes(graph.pool())
        return out

    def _capture(self, modules):
        """(graph, static outputs, launches by module, launches by K by
        module) of one capture of the program on the current stream."""
        before = [m.LAUNCHES for m in modules]
        before_k = {m: dict(m.LAUNCHES_BY_K) for m in modules if hasattr(m, "LAUNCHES_BY_K")}
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self._pool)
        try:
            static = self._fn(*self.inputs)
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass                                          # the capture was already broken
            raise
        finally:
            counted = [m.LAUNCHES - b for m, b in zip(modules, before)]
            for m, b in zip(modules, before):
                m.LAUNCHES = b                                # a capture launches nothing
            counted_k = {m: {k: n - b.get(k, 0) for k, n in m.LAUNCHES_BY_K.items()
                             if n != b.get(k, 0)} for m, b in before_k.items()}
            for m, b in before_k.items():
                m.LAUNCHES_BY_K.clear()
                m.LAUNCHES_BY_K.update(b)
        graph.capture_end()
        return graph, static, counted, counted_k


class _Field(NamedTuple):
    offset: int
    nbytes: int
    dtype: torch.dtype
    shape: tuple


class FlatOutputs:
    """A program's outputs, a tree of tuples (NamedTuples included) whose
    leaves are tensors or None, as one flat uint8 buffer and back.  The
    fields lie in the buffer by element size, largest first, so each starts
    at a multiple of its own element size and is a view of the buffer.  The
    tree's structure is set by the first ``pack``."""

    def __init__(self):
        self._template = None
        self._fields: list = []

    @staticmethod
    def _leaves(tree) -> list:
        if isinstance(tree, torch.Tensor):
            return [tree]
        if tree is None:
            return []
        return [x for item in tree for x in FlatOutputs._leaves(item)]

    def pack(self, tree) -> torch.Tensor:
        """One uint8 tensor holding every leaf's bytes (one ``torch.cat``)."""
        leaves = [t.contiguous() for t in self._leaves(tree)]
        order = sorted(range(len(leaves)), key=lambda i: -leaves[i].element_size())
        if self._template is None:
            fields, off = [None] * len(leaves), 0
            for i in order:
                nbytes = leaves[i].numel() * leaves[i].element_size()
                fields[i] = _Field(off, nbytes, leaves[i].dtype, tuple(leaves[i].shape))
                off += nbytes
            self._template, self._fields = tree, fields
        elif [(t.dtype, tuple(t.shape)) for t in leaves] != [(f.dtype, f.shape)
                                                            for f in self._fields]:
            raise ValueError("the program's outputs changed their dtypes or shapes")
        return torch.cat([leaves[i].reshape(-1).view(torch.uint8) for i in order])

    def unpack(self, flat: torch.Tensor):
        """The tree of ``pack``, each leaf a view of ``flat``."""
        leaves = iter([flat[f.offset:f.offset + f.nbytes].view(f.dtype).view(f.shape)
                       for f in self._fields])

        def build(node):
            if isinstance(node, torch.Tensor):
                return next(leaves)
            if node is None:
                return None
            items = [build(item) for item in node]
            return type(node)(*items) if hasattr(node, "_fields") else type(node)(items)

        return build(self._template)


def _tree_map(fn, tree):
    """``fn`` on every tensor leaf of a tree of tuples (NamedTuples
    included) whose leaves are tensors or None."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if tree is None:
        return None
    items = [_tree_map(fn, item) for item in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


class GraphProgram:
    """``body`` as one compiled program per input signature, the port's
    counterpart of a cached ``jax.jit``.

    On a CUDA device each signature (the inputs' shapes and dtypes; a
    Python int is a 0-d int32 input) has its own ``GraphRunner`` of
    ``body``, captured at the signature's first call and replayed after
    it, with the outputs packed into one flat buffer (``FlatOutputs``).
    At most ``max_graphs`` signatures keep their graphs: the least recently
    called goes first, its graph and memory pool with it.  Inputs are
    tensors on the program's device, CPU tensors or numpy arrays (loaded
    into the static inputs through pinned memory, with no host wait), or
    ints.  ``__call__`` returns tensors of the call's own (one clone of the
    flat buffer, every field a view of it, which no later replay
    overwrites); ``host`` makes one device-to-host copy of the flat buffer
    and returns numpy arrays.  On the CPU ``body`` runs on the inputs, so
    the graphs' eager body is also the CPU's program.  A capture that fails
    raises (``GraphRunner``); nothing runs ``body`` eagerly on CUDA.  A
    program of several graphs a signature overrides ``compile`` (its
    runners from the first inputs) and ``replay`` (a call on them), as
    ``models/lasso_refine.LassoProgram`` does."""

    def __init__(self, body: Callable, device, max_graphs: int):
        self.body = body
        self.device = torch.device(device)
        self.max_graphs = max_graphs
        self.graphs: "OrderedDict[tuple, tuple]" = OrderedDict()   # signature -> compile()
        self.runner: Optional[GraphRunner] = None      # the last call's

    @staticmethod
    def _inputs(inputs) -> list:
        out = []
        for x in inputs:
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(np.ascontiguousarray(x))
            elif isinstance(x, np.integer):
                x = int(x)
            out.append(x)
        return out

    def issue(self, *inputs):
        """(outputs, None) of the eager body on the CPU; on CUDA ``replay``
        of the signature's compiled program."""
        xs = self._inputs(inputs)
        if self.device.type != "cuda":
            return self.body(*(x.to(self.device) if isinstance(x, torch.Tensor) else x
                               for x in xs)), None
        sig = tuple(("int",) if isinstance(x, int) else (tuple(x.shape), x.dtype) for x in xs)
        if sig in self.graphs:
            self.graphs.move_to_end(sig)
        else:
            while len(self.graphs) >= self.max_graphs:
                self.graphs.popitem(last=False)
            self.graphs[sig] = self.compile([
                torch.full((), x, dtype=torch.int32, device=self.device) if isinstance(x, int)
                else x.to(self.device) for x in xs])
        return self.replay(self.graphs[sig], xs)

    def compile(self, xs: list):
        """The compiled program of one signature, from its first inputs on
        the device: (``GraphRunner`` of the packed body, its
        ``FlatOutputs``)."""
        flat, body = FlatOutputs(), self.body
        return GraphRunner(lambda *a: flat.pack(body(*a)), xs), flat

    def replay(self, compiled, xs):
        """(the graph's flat output buffer, which its next replay
        overwrites, and its ``FlatOutputs``) of ``xs``."""
        self.runner, flat = compiled
        return self.runner(*xs), flat

    def __call__(self, *inputs):
        """The outputs as tensors of this call's own on the program's
        device."""
        out, flat = self.issue(*inputs)
        return out if flat is None else flat.unpack(out.clone())

    def host(self, *inputs):
        """The outputs as numpy arrays, in one device-to-host copy on CUDA."""
        out, flat = self.issue(*inputs)
        if flat is None:
            return _tree_map(lambda x: x.cpu().numpy(), out)
        return _tree_map(lambda x: x.numpy(), flat.unpack(out.cpu()))


_PROGRAM_CACHES: list = []


def program_device(device) -> torch.device:
    """``device`` as a program's cache key: ``pipeline/device.resolve_device``
    (None means CUDA; with no CUDA device a CUDA request raises), a CUDA
    device with its index."""
    from slam_process_tpu_torch.pipeline.device import resolve_device

    dev = resolve_device(device)
    return torch.device("cuda", torch.cuda.current_device()) if dev == torch.device("cuda") else dev


def program_cache(maxsize: int):
    """``functools.lru_cache(maxsize)`` for a function that makes compiled
    programs and takes a ``device`` argument, registered so that
    ``clear_programs`` empties it.  The key is every argument by name, its
    default where the call leaves it out, with ``device`` resolved by
    ``program_device``: None, ``"cuda"`` and ``"cuda:0"`` on card 0 give one
    program, so each card holds one program (and one set of graphs) per
    key."""
    def wrap(fn):
        signature = inspect.signature(fn)
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def make(*args, **kwargs):
            bound = signature.bind(*args, **kwargs)
            bound.apply_defaults()
            bound.arguments["device"] = program_device(bound.arguments["device"])
            return cached(**bound.arguments)

        make.cache_info, make.cache_clear = cached.cache_info, cached.cache_clear
        _PROGRAM_CACHES.append(cached)
        return make
    return wrap


def clear_programs() -> None:
    """Empty every ``program_cache``: their programs, graphs and memory
    pools go (the pools' memory returns to the allocator's cache)."""
    for cached in _PROGRAM_CACHES:
        cached.cache_clear()
