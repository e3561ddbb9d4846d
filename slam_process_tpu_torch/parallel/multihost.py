"""Sessions, sweeps and streams across processes, on ``torch.distributed``.

The port of ``slam_process_tpu/parallel/multihost.py``.  The JAX package
runs one program over a mesh that spans processes; here every process runs
its own rows of that mesh (``Mesh.local``) on its own devices, and what
crosses processes is host data only: the agreed byte bucket, padded counts
and estimator dims, the window rounds' ``go`` bits and the flushes'
alignment.  The tensors never leave their process's device, so the process
group is gloo on the CPU whatever the devices are (NCCL refuses two ranks
on one GPU).

  * ``initialize_multihost``: join a gloo process group at
    ``tcp://<coordinator>`` with an explicit timeout, so a peer that never
    arrives raises instead of hanging.
  * ``global_data_mesh``: the ``data x model`` mesh over every process's
    positions, process-major as ``jax.devices()`` orders them; this
    process's ``local_device_count`` positions lie on
    ``cuda:(process_id % torch.cuda.device_count())``, or on the CPU where
    ``initialize_multihost`` was given ``device="cpu"``.  The model axis
    must lie within one process (``Mesh.local`` raises otherwise).
  * ``run_batched_multihost`` / ``estimate_sessions_multihost``: the
    batched summary pipeline and the sharded session estimator over this
    process's sessions, with the shapes agreed by an all-gather; they
    return this process's rows (``local_shard``).
  * ``MultihostMultiStream``: live ingest where every process tails its own
    captures and all of them advance in lockstep window rounds.

No fallback: a failed ``init_process_group`` raises, a lost peer raises at
the group's timeout, and nothing goes on single-process.
"""

from __future__ import annotations

import datetime
import threading
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from slam_process_tpu_torch.parallel.mesh import Mesh
from slam_process_tpu_torch.pipeline.device import resolve_device

__all__ = [
    "initialize_multihost",
    "global_data_mesh",
    "run_batched_multihost",
    "estimate_sessions_multihost",
    "MultihostMultiStream",
    "local_shard",
]

DEFAULT_TIMEOUT_S = 120.0
# The process group's layout, set by initialize_multihost: the process
# group itself is process-wide state in torch.distributed.
_LAYOUT: dict = {}


def initialize_multihost(coordinator_address: str, num_processes: int, process_id: int,
                         local_device_count: Optional[int] = None, *, device=None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join (or create) the process group: gloo over
    ``tcp://<coordinator_address>`` (``host:port``; process 0 listens) with
    ``num_processes`` and ``process_id``.  ``local_device_count`` positions
    of the global mesh belong to this process (default 1), all on ``device``
    (None: this process's CUDA device, ``cuda:(process_id %
    torch.cuda.device_count())``).  Every collective waits at most
    ``timeout_s`` for its peers, then raises."""
    import torch.distributed as dist

    dev = resolve_device(device)   # no card and no device="cpu": raises before joining
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    rank = dist.get_rank()
    if dev.type == "cuda" and (device is None or dev.index is None):
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    _LAYOUT.update(rank=rank, world=dist.get_world_size(), device=dev,
                   local=int(local_device_count or 1))


def shutdown_multihost() -> None:
    """Leave the process group (after a last barrier, so no peer is left
    waiting in a collective)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    _LAYOUT.clear()


def _layout() -> dict:
    if not _LAYOUT:
        raise RuntimeError("call initialize_multihost first")
    return _LAYOUT


def allgather_host(values) -> np.ndarray:
    """[num_processes, ...] int64: every process's ``values`` (same shape
    everywhere), in process order; a collective."""
    import torch.distributed as dist

    t = torch.as_tensor(np.asarray(values, np.int64))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def global_or(flag: bool) -> bool:
    """Whether any process's ``flag`` is set: one all-reduce."""
    import torch.distributed as dist

    t = torch.tensor([int(bool(flag))], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def global_data_mesh(model: int = 1) -> Mesh:
    """``data x model`` mesh over every position of every process,
    process-major; this process's positions on its device
    (``initialize_multihost``)."""
    lay = _layout()
    n = lay["world"] * lay["local"]
    if n % model:
        raise ValueError(f"{n} positions ({lay['world']} processes x {lay['local']}) do not "
                         f"divide model={model}")
    # Another process's positions name the device it would pick on this
    # host; only this process's own rows are ever run here.
    procs = np.repeat(np.arange(lay["world"]), lay["local"])
    devs = np.empty(n, dtype=object)
    for i, p in enumerate(procs):
        devs[i] = (torch.device("cuda", int(p) % torch.cuda.device_count())
                   if lay["device"].type == "cuda" and p != lay["rank"] else lay["device"])
    shape = (n // model, model)
    mesh = Mesh(devs.reshape(shape), ("data", "model"), procs.reshape(shape), lay["rank"])
    mesh.local()   # the model axis must lie within one process
    return mesh


def local_shard(x) -> np.ndarray:
    """This process's rows of a multi-host output, as numpy (the port's
    multi-host outputs hold only this process's rows, in its input order)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def run_batched_multihost(mesh: Mesh, raw_list_local: Sequence[np.ndarray],
                          n_bytes_padded: Optional[int] = None, **pipeline_kwargs):
    """The batched summary pipeline over a process-spanning mesh: this
    process's sessions on its rows (``Mesh.local``).  Every process calls it
    with the same number of sessions (pad with zero-length ones).  The byte
    width is agreed by an all-gather of the local maxima.  Returns the
    ``SessionSummaryOut`` of this process's sessions, on its first row's
    device (``local_shard`` reads a field)."""
    from slam_process_tpu_torch.parallel.batch import batched_session_pipeline, stack_sessions
    from slam_process_tpu_torch.pipeline.device import device_lut

    local_max = max((len(r) for r in raw_list_local), default=0)
    if n_bytes_padded is None:
        n_bytes_padded = int(allgather_host([local_max]).max())
    local = mesh.local()
    batch, lengths = stack_sessions(raw_list_local, n_bytes_padded)
    fn = batched_session_pipeline(local, n_bytes_padded, outputs="summary", **pipeline_kwargs)
    return fn(batch, lengths, device_lut(local.rows()[0][0]))


def estimate_sessions_multihost(sessions, angle_file, mesh: Mesh, flavor: str = "v1-7",
                                **overrides):
    """NN-OMP over a process-spanning mesh: every process builds only its
    sessions' scenes and dictionaries on the host, the pad shape (U, B, Ga,
    Gd) is agreed by an all-gather, and this process's rows run the sharded
    estimator (``nn_omp_sessions_sharded``: sessions over ``data``, the AoA
    grid over ``model``).  Call with the same number of sessions in every
    process.  Returns the OmpPaths of this process's sessions (numpy)."""
    from slam_process_tpu_torch.models.batch_estimation import (
        flavor_config, nn_omp_sessions_sharded, pack_scenes)
    from slam_process_tpu_torch.models.dictionary import make_dictionary
    from slam_process_tpu_torch.models.registry import build_scene

    local = mesh.local()
    dict_cfg, cfg, log_transform, keep_rule, stop_np = flavor_config(flavor, **overrides)
    mats, dicts = [], []
    for s in sessions:
        matrix, ue_ang, bs_ang = build_scene(s, angle_file, log_transform,
                                             device=local.rows()[0][0])
        mats.append(matrix)
        dicts.append(make_dictionary(ue_ang, bs_ang, dict_cfg))
    local_dims = [max(m.shape[0] for m in mats), max(m.shape[1] for m in mats),
                  max(len(d.aoa_grid) for d in dicts), max(len(d.aod_grid) for d in dicts)]
    dims = allgather_host(local_dims).max(axis=0)
    packed = pack_scenes(mats, dicts, pad_to=tuple(int(x) for x in dims))
    return nn_omp_sessions_sharded(packed, cfg, local, keep_rule, stop_np)


class MultihostMultiStream:
    """Live ingest across processes: each process tails ``n_local`` streams
    on its rows of the mesh (a ``MultiStreamingSession`` over
    ``Mesh.local``), and all processes advance in lockstep window rounds.

    Every method is COLLECTIVE: all processes call the same methods in the
    same order (``feed`` once per round with their own chunks, ``b""`` for
    idle streams).  The padded per-process count is agreed by an all-gather
    (the max over processes, raised until the global count divides the
    ``data`` axis; padding slots are inert, never fed or read); ``feed``'s
    window-round ``go`` bit is a global OR, one all-reduce per round;
    ``finalize_streams`` takes process-LOCAL indices (possibly none) and
    runs one collective masked flush; the constructor runs a warm-up no-op
    window and flush (which builds the kernels) and re-aligns the processes
    after it.  The readers are ``local_*``: a process reads its own streams.
    Checkpoints and ``reset_streams`` are single-process features.  Each
    stream's results equal a single-process ``MultiStreamingSession``
    replay of the same bytes.
    """

    def __init__(self, mesh: Mesh, n_local: int, config=None, chunk_bytes: int = 1 << 20,
                 group_capacity: int = 8192, max_groups: int = 128,
                 max_baselines_per_group: int = 192, n_beams: int = 64, collect_paths=None,
                 emit_capacity: int = 0):
        from slam_process_tpu_torch.parallel.streaming_device import MultiStreamingSession

        self.mesh = mesh
        self.n_local_real = int(n_local)
        dp = mesh.shape["data"]
        nproc = _layout()["world"]
        counts = allgather_host([self.n_local_real])[:, 0]
        n_pad = int(counts.max())
        while (n_pad * nproc) % dp:
            n_pad += 1
        self.n_local = n_pad
        self.n_streams = n_pad * nproc            # incl. padding slots
        self.n_streams_real = int(counts.sum())   # live captures only
        self._ms = MultiStreamingSession(n_pad, config=config, chunk_bytes=chunk_bytes,
                                         group_capacity=group_capacity, max_groups=max_groups,
                                         max_baselines_per_group=max_baselines_per_group,
                                         n_beams=n_beams, mesh=mesh.local(),
                                         collect_paths=collect_paths,
                                         emit_capacity=emit_capacity)
        self.config = self._ms.config
        self.chunk_bytes = self._ms.chunk_bytes
        self._paths_spec = self._ms._paths_spec
        self._byte_carry = [np.zeros(0, np.uint8) for _ in range(self.n_local)]
        self._stream_finalized = np.zeros(self.n_local, bool)
        self._finalized = False
        # Warm-up: one empty window and one all-False flush (both no-ops for
        # the state) build and load the kernels before live data flows; the
        # all-gather after it re-aligns the processes, whose builds differ.
        self._ms._window(np.zeros((n_pad, self.chunk_bytes), np.uint8),
                         np.zeros(n_pad, np.int64))
        self._masked_flush(np.zeros(n_pad, bool))
        self._ms.block_until_ready()
        allgather_host([0])

    # -- collective ingest -----------------------------------------------------

    def feed(self, chunks) -> None:
        """Advance this process's streams by one chunk each (COLLECTIVE: all
        processes call feed in the same round; ``b""`` for streams with no
        new data).  A process whose streams all ended keeps calling it with
        empty chunks, so the rounds stay aligned."""
        from slam_process_tpu_torch.parallel.streaming_device import (
            _has_window, _next_windows)

        if len(chunks) != self.n_local_real:
            raise ValueError(f"expected {self.n_local_real} chunks")
        chunks = list(chunks) + [b""] * (self.n_local - self.n_local_real)
        bufs, offs = [], [0] * self.n_local
        for i, chunk in enumerate(chunks):
            if isinstance(chunk, (bytes, bytearray)):
                chunk = np.frombuffer(chunk, dtype=np.uint8)
            chunk = np.asarray(chunk, np.uint8)
            if len(chunk) and self._stream_finalized[i]:
                raise RuntimeError(f"local stream {i} already finalized (pass b'' for ended "
                                   "streams)")
            bufs.append(np.concatenate([self._byte_carry[i], chunk]))
        # Lockstep rounds: the continue decision is a global OR.
        while global_or(_has_window(bufs, offs)):
            self._ms._window(*_next_windows(bufs, offs, self.n_local, self.chunk_bytes))
        self._byte_carry = [b[o:].copy() for b, o in zip(bufs, offs)]

    def _masked_flush(self, mask_local: np.ndarray) -> None:
        """The collective flush: the processes align on it (one all-gather),
        then each flushes its masked streams (none is a no-op)."""
        allgather_host([int(np.sum(mask_local))])
        if np.any(mask_local):
            self._ms._masked_flush(np.asarray(mask_local, bool))
        for i in np.nonzero(mask_local)[0]:
            self._byte_carry[i] = np.zeros(0, np.uint8)

    def finalize_streams(self, local_indices) -> None:
        """Close the open sweep group of this process's given streams
        (COLLECTIVE: every process calls with its ended streams, possibly
        none)."""
        idx = np.asarray(list(local_indices), int)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n_local_real):
            raise IndexError(f"stream index out of range: {idx.tolist()}")
        mask = np.zeros(self.n_local, bool)
        mask[idx] = True
        already = mask & self._stream_finalized
        if already.any():
            raise RuntimeError(f"local streams {np.nonzero(already)[0].tolist()} already "
                               "finalized")
        self._masked_flush(mask)
        self._stream_finalized |= mask
        if bool(self._stream_finalized[:self.n_local_real].all()):
            self._finalized = True

    def finalize(self) -> None:
        """Flush every stream still open: COLLECTIVE, once per process at
        shutdown; it always runs exactly one masked flush (an all-False one
        where nothing is left), so ragged clusters stay in lockstep."""
        mask = ~self._stream_finalized
        mask[self.n_local_real:] = False
        self._masked_flush(mask)
        self._stream_finalized[:] = True
        self._finalized = True

    # -- process-local readers ---------------------------------------------------

    def _check_local(self, i: int) -> None:
        if not 0 <= i < self.n_local_real:
            raise IndexError(f"local stream {i} out of range")

    def n_sweeps_closed_all(self) -> np.ndarray:
        """Closed-sweep counts of this process's streams ([n_local_real]
        int64); no collective."""
        return self._ms.n_sweeps_closed_all()[:self.n_local_real]

    def stream_track_columns(self, i: int, lo: int, hi: int):
        """Local stream ``i``'s track-ring columns of closed sweeps ``[lo,
        hi)`` (``MultiStreamingSession.stream_track_columns``); no
        collective, so processes may poll at their own cadence."""
        self._check_local(i)
        return self._ms.stream_track_columns(i, lo, hi)

    def local_results(self):
        """This process's streams' (n_frames, n_kept, n_groups, sums, counts,
        overflow), leading axis ``n_local_real`` in feed order."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            out = tuple(x[:self.n_local_real] for x in self._ms.results())
        if bool(np.any(out[5])):
            bad = np.nonzero(out[5])[0].tolist()
            warnings.warn(f"MultihostMultiStream capacity exceeded on local streams {bad}; "
                          "their results are incomplete — rebuild with larger bounds",
                          RuntimeWarning, stacklevel=2)
        return out

    def local_stream_filtered(self, i: int) -> np.ndarray:
        """Local stream ``i``'s corrected rows [N, 4] in stream order
        (requires ``emit_capacity``)."""
        self._check_local(i)
        return self._ms.stream_filtered(i)

    def local_stream_paths(self, i: int):
        """Local stream ``i``'s online per-sweep estimates."""
        self._check_local(i)
        return self._ms.stream_paths(i)

    def local_stream_tracks(self, i: int):
        """Local stream ``i``'s online tracks: (tracks, times, velocities)."""
        self._check_local(i)
        return self._ms.stream_tracks(i)


_PORTS_GIVEN: set = set()
_PORTS_LOCK = threading.Lock()
ADDRESS_IN_USE = "EADDRINUSE"   # in torch.distributed's error when a store cannot listen


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago and that this
    process has not handed out before, so clusters started together never
    share one."""
    import socket

    held = []
    with _PORTS_LOCK:
        try:
            while True:
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                held.append(sock)   # held open, so the next bind gets another port
                sock.bind(("127.0.0.1", 0))
                port = int(sock.getsockname()[1])
                if port not in _PORTS_GIVEN:
                    _PORTS_GIVEN.add(port)
                    return port
        finally:
            for sock in held:
                sock.close()


def run_local_cluster(argvs_for, timeout_s: float, *, cwd=None,
                      interrupt_when: Optional[str] = None) -> list:
    """Run one local cluster, one process per argv of
    ``argvs_for(coordinator)`` (``coordinator`` is ``127.0.0.1:<port>`` on
    a ``free_port``), and return [(returncode, stdout, stderr)] in order.
    Each process has ``timeout_s`` seconds: on expiry every process still
    running is killed and ``TimeoutError`` names the outputs so far.
    ``interrupt_when``: once every process has written that text to its
    stderr, each is sent SIGINT (a multi-host watch's end signal).  Where
    a process could not listen on the port (another program took it
    between the pick and the bind), its peers are killed and the cluster
    runs once more on another port."""
    res = _run_processes(argvs_for(f"127.0.0.1:{free_port()}"), timeout_s, cwd, interrupt_when)
    if any(ADDRESS_IN_USE in err for _, _, err in res):
        res = _run_processes(argvs_for(f"127.0.0.1:{free_port()}"), timeout_s, cwd,
                             interrupt_when)
    return res


def _run_processes(argvs, timeout_s, cwd, interrupt_when) -> list:
    import os
    import signal
    import subprocess
    import tempfile
    import time

    with tempfile.TemporaryDirectory() as tmp:
        procs, files = [], []
        try:
            for k, argv in enumerate(argvs):
                out = open(os.path.join(tmp, f"{k}.out"), "w+")
                err = open(os.path.join(tmp, f"{k}.err"), "w+")
                files.append((out, err))
                procs.append(subprocess.Popen(list(argv), stdout=out, stderr=err, cwd=cwd))
            deadline = time.monotonic() + timeout_s
            sent = interrupt_when is None
            while any(p.poll() is None for p in procs):
                errs = [open(e.name).read() for _, e in files]
                if any(ADDRESS_IN_USE in e for e in errs):
                    break   # the finally kills the peers
                if not sent and all(interrupt_when in e for e in errs):
                    for p in procs:
                        if p.poll() is None:
                            p.send_signal(signal.SIGINT)
                    sent = True
                if time.monotonic() > deadline:
                    raise TimeoutError(f"local cluster still running after {timeout_s} s; "
                                       f"stderr: {[e[-2000:] for e in errs]}")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for o, e in files:
                o.close()
                e.close()
        return [(p.returncode, open(o.name).read(), open(e.name).read())
                for p, (o, e) in zip(procs, files)]
