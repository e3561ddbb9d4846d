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
  * ``pool_bytes`` (the graph's memory pool) and ``capture_ms``.

A runner's graph allocates from a private memory pool, or from ``pool``
(``new_pool()``), which it shares with the other graphs given the same one.
Share a pool only among the graphs of one program that replay in order on
one stream and keep nothing alive but the first graph's static outputs (a
session's round: its graph before the count read, then one of those after
it): a later capture may take a block that an earlier graph's replay
writes as scratch, so graphs that share a pool must never both hold live
outputs, and a graph captured after the others were dropped needs a new
pool.  ``pool_bytes`` is then the shared pool's.

It refuses CPU tensors: on the CPU callers run the eager body.  A capture
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

The port's counterpart of the JAX package's ``jax.jit`` with
``utils/cache.py``; a graph lives in its process, so there is no persistent
cache to port.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, NamedTuple, Optional, Sequence

import torch

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
        stream: tensors of the static shape and dtype on the device, or a
        Python int for a 0-d input."""
        if len(inputs) != len(self.inputs):
            raise ValueError(f"expected {len(self.inputs)} inputs, got {len(inputs)}")
        for static, x in zip(self.inputs, inputs):
            if isinstance(x, int) and static.dim() == 0:
                static.fill_(x)
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
