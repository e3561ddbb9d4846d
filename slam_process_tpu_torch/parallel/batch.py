"""Batched multi-session pipeline, on one device or over a mesh.

The port of ``slam_process_tpu/parallel/batch.py``: S sessions, padded to
one byte width and stacked to [S, N], run the session pipeline as one batch
(``session_axis="vmap"``, ``pipeline/device.session_pipeline_batch``): one
launch of kernel K1 over the [S, N] bytes, one of K2 for all S sessions'
rows (group ids offset per session, ``ops/correct.py``), the intensity sums
of all S grids in one ``index_add_`` and one launch of K3 over the [S, 64,
64] tiles.  ``session_axis="scan"`` is JAX's ``lax.map`` form: a loop of
the single-session pipeline, S launches per stage, with outputs equal bit
for bit to the batch's.  On CPU tensors every kernel's plain version runs.

With a mesh (``parallel/mesh.py``) the S sessions pad with empty sessions
(zero bytes decode to zero frames) to a multiple of the ``data`` axis, as
the JAX package pads them, and each data shard runs that batch body on its
row's first device: K1 over its [S / dp, N] bytes, K2 once on its rows, the
sums and K3 over its tiles, issued device after device.  The JAX package
shards only ``data`` here (``P("data", None)``) and replicates the batch
over ``model``, so each shard runs once.  Results equal ``mesh=None`` bit
for bit.

As in the JAX package, ``batched_session_pipeline`` is one program per
(mesh, bucket, config), cached (32 at most): on a CUDA device each data
shard's batch body is a CUDA graph (``utils/graphs.py``), captured at its
first call and replayed, shard after shard, at every later call of the
same row count; a call with another row count captures anew and drops the
shard's old graph with its memory pool, so a program holds one graph per
shard.  On the CPU the body runs eagerly.

The bytes reach the device through one reused host buffer a data shard
(``_Staging``, made at a program's first call and remade at a new row
count): pinned memory on CUDA, plain memory on the CPU, where the eager
body reads it in place.  ``run_dataset`` writes each session's bytes and
the stale part of its zero tail straight into its row (``stage``), with
no padded copy and no stacked batch; a ready [S, N] batch (``__call__``,
``shards``) is copied into it.  On CUDA the graph's ``GraphRunner.load``
copies the pinned rows into its static input without a host wait (a
new graph is made from a device copy of them), and an event after the
replay marks the copy done: the host waits on it before it next writes
that buffer, and only if it has not passed (``STAGING_WAITS``).  For ``run_dataset`` each shard's
flat output buffer is copied, right after its replay and without a host
wait, into a reused pinned buffer, and an event marks that copy; once
every bucket was issued, ``run_dataset`` waits on each bucket's events in
turn (``READBACK_WAITS`` counts the copies still in flight) and splits it
into per-session numpy arrays of their own (``np.concatenate`` copies out
of the pinned buffer, which the next call overwrites), while the card
runs the later buckets.

Each bucket's host steps are spans (``utils/profiling.annotate``), in
this order: ``slam.batch.stack`` (the program lookup and the bytes'
writes into the staging buffers, with ``slam.batch.staging_wait`` inside
it where the host waits for a copy out of them), ``slam.batch.upload``
(the lookup table's move, and a new graph's runner with its device copy
of the rows; on the CPU the eager body's inputs), ``slam.batch.replay``
(the graph's load from the pinned rows and its replay, or its capture,
and the launch of the copy back), then, after every bucket was issued,
``slam.batch.readback`` (the wait for the copy back) and
``slam.batch.split`` (the per-session numpy arrays and the overflow
check); with a mesh, upload and replay once per data shard.
"""

from __future__ import annotations

import functools
import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from slam_process_tpu_torch.parallel.mesh import placement, shard_rows
from slam_process_tpu_torch.pipeline.device import (
    DeviceSessionOut, bucket_size, device_lut, pad_bytes, session_pipeline,
    session_pipeline_batch)
from slam_process_tpu_torch.utils.graphs import FlatOutputs, GraphRunner
from slam_process_tpu_torch.utils.profiling import annotate

STAGING_WAITS = 0   # shard batches whose staging buffer was still being copied (the host waited)
READBACK_WAITS = 0  # shard outputs whose copy back was still in flight when read (the host waited)


class SessionSummaryOut(NamedTuple):
    """Per-session results without the [S, R] frame tensors."""

    n_frames: torch.Tensor          # [S] i32
    correct_overflow: torch.Tensor  # [S] bool
    n_kept: torch.Tensor            # [S] i32
    mean_grid: torch.Tensor         # [S, 64, 64] f32
    counts: torch.Tensor            # [S, 64, 64] i32
    rgba: torch.Tensor              # [S, 64, 64, 4] f32
    blurred: torch.Tensor           # [S, 64, 64] f32
    norm_t: torch.Tensor            # [S, 64, 64] f32


def _stack_outputs(outs: Sequence[DeviceSessionOut]) -> DeviceSessionOut:
    return DeviceSessionOut(*(None if f == "n_discarded" else torch.stack(
        [getattr(o, f) for o in outs]) for f in DeviceSessionOut._fields))


class _Staging:
    """One data shard's reused host buffers (module docstring): ``bytes``
    [rows, N] u8, the shard's next batch (pinned on CUDA), each row zero
    past its first ``filled`` bytes, and ``sent``, the event after the
    replay that read it; ``out``, the pinned copy of the graph's flat output
    buffer (made at the first copy back), and ``read``, the event after
    that copy.  On the CPU there are no events and no ``out``."""

    def __init__(self, rows: int, n_bytes: int, device: torch.device):
        cuda = device.type == "cuda"
        self.rows = rows
        self.bytes = torch.zeros((rows, n_bytes), dtype=torch.uint8, pin_memory=cuda)
        self.bytes_np = self.bytes.numpy()
        self.filled = [0] * rows
        self.sent = torch.cuda.Event() if cuda else None
        self.out: Optional[torch.Tensor] = None
        self.read = torch.cuda.Event() if cuda else None

    def write(self, rows: Sequence[np.ndarray]) -> None:
        """Row j <- ``rows[j]`` padded with zeros, and the rows past them
        all zeros: each row's bytes, then zeros where the last write left
        bytes past them.  First the host waits for the previous batch's copy
        out of ``bytes``, only if it is still in flight (``STAGING_WAITS``)."""
        global STAGING_WAITS
        if self.sent is not None and not self.sent.query():
            STAGING_WAITS += 1
            with annotate("slam.batch.staging_wait"):
                self.sent.synchronize()
        buf = self.bytes_np
        for j in range(self.rows):
            n = len(rows[j]) if j < len(rows) else 0
            if n:
                buf[j, :n] = rows[j]
            if self.filled[j] > n:
                buf[j, n:self.filled[j]] = 0
            self.filled[j] = n

    def copy_back(self, flat: torch.Tensor) -> torch.Tensor:
        """Launch the copy of a graph's flat output buffer into ``out`` on
        the current stream, record ``read`` after it, and return ``out``."""
        if self.out is None or self.out.numel() != flat.numel():
            self.out = torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=True)
        self.out.copy_(flat, non_blocking=True)
        self.read.record(torch.cuda.current_stream(flat.device))
        return self.out


class _BatchedPipeline:
    """What ``batched_session_pipeline`` returns: called, the outputs of
    every row on the first row's device; ``shards`` gives each data shard's
    outputs on its own device.  On CUDA each data shard has one
    ``GraphRunner`` of ``_body``, for the row count of its last call, whose
    outputs are one flat buffer (``FlatOutputs``); a call returns tensors
    of its own (one clone of that buffer), as ``pipeline/device._Program``
    does.  Each data shard stages its bytes in one ``_Staging``."""

    def __init__(self, rows, n_bytes_padded: int, outputs: str, session_axis: str, kw: dict):
        self.rows = rows
        self.n_bytes_padded = n_bytes_padded
        self.outputs = outputs
        self.session_axis = session_axis
        self.kw = kw
        self.runners: dict = {}         # shard -> (rows, GraphRunner, FlatOutputs)
        self.staging: list = []         # shard -> _Staging, for the last call's row count

    def _body(self, b: torch.Tensor, lut: torch.Tensor):
        if self.session_axis == "scan":
            out = _stack_outputs([session_pipeline(b[i], lut, **self.kw)
                                  for i in range(b.shape[0])])
        else:
            out = session_pipeline_batch(b, lut, **self.kw)
        if self.outputs == "summary":
            return SessionSummaryOut(*(getattr(out, f) for f in SessionSummaryOut._fields))
        return out

    def _shard_staging(self, n_sessions: int) -> int:
        """Rows per shard of a batch of ``n_sessions`` (padded with empty
        sessions to a multiple of the shard count); each shard's
        ``_Staging`` made anew where it holds another row count."""
        per = shard_rows(n_sessions, len(self.rows))[1]
        if not self.staging or self.staging[0].rows != per:
            self.staging = [_Staging(per, self.n_bytes_padded, devs[0]) for devs in self.rows]
        return per

    def stage(self, sessions: Sequence[np.ndarray]) -> None:
        """Write ``sessions`` (u8 arrays of at most N bytes each, or the rows
        of an [S, N] batch) into the staging buffers, shard ``r`` rows
        ``[r * per, (r + 1) * per)`` and the padding rows all zeros, as
        ``stack_sessions`` would stack them, for ``_issue``."""
        per = self._shard_staging(len(sessions))
        for r, st in enumerate(self.staging):
            st.write(sessions[r * per:(r + 1) * per])

    def _issue(self, lut, to_host: bool = False) -> list:
        """Each data shard's rows, from its staging buffer (``stage``), run
        on its row's first device, shard after shard.  Per shard (the eager
        body's outputs, None, None) on the CPU, or on CUDA (the graph's
        flat output buffer, which its next replay overwrites, its layout,
        None), or with ``to_host`` (the buffer's pinned host copy, its
        layout, the copy's event), the copy launched without a host wait.
        Spans, once per shard: ``slam.batch.upload`` and
        ``slam.batch.replay`` (module docstring)."""
        lut = torch.as_tensor(lut, dtype=torch.float32)
        out = []
        for r, (devs, st) in enumerate(zip(self.rows, self.staging)):
            dev = devs[0]
            with annotate("slam.batch.upload"):
                lut_r = lut.to(dev)
                if dev.type != "cuda":
                    x = st.bytes.to(dev)
                elif self.runners.get(r, (None,))[0] != st.rows:
                    self.runners.pop(r, None)       # the old graph and its pool go first
                    flat, body = FlatOutputs(), self._body
                    self.runners[r] = (st.rows, GraphRunner(
                        lambda *xs: flat.pack(body(*xs)),
                        [st.bytes.to(dev, non_blocking=True), lut_r]), flat)
            with annotate("slam.batch.replay"):
                if dev.type != "cuda":
                    out.append((self._body(x, lut_r), None, None))
                    continue
                _, runner, flat = self.runners[r]
                res = runner(st.bytes, lut_r)
                st.sent.record(torch.cuda.current_stream(dev))
                out.append((st.copy_back(res), flat, st.read) if to_host else (res, flat, None))
        return out

    def shards(self, byte_batch, n_bytes, lut) -> list:
        """One output per data shard, each on its row's first device:
        ``byte_batch`` [S, N] (a device tensor is read back to the host)
        staged, then issued shard after shard (``_issue``)."""
        del n_bytes
        b = torch.as_tensor(byte_batch, dtype=torch.uint8).cpu().numpy()
        if b.ndim != 2 or b.shape[1] != self.n_bytes_padded:
            raise ValueError(f"byte_batch must be [S, {self.n_bytes_padded}], got "
                             f"{tuple(b.shape)}")
        self.stage(b)
        return [out if flat is None else flat.unpack(out.clone())
                for out, flat, _ in self._issue(lut)]

    def __call__(self, byte_batch, n_bytes, lut):
        """The S sessions' outputs, every field with a leading S axis, on
        the first row's device."""
        s = len(byte_batch)
        outs = self.shards(byte_batch, n_bytes, lut)
        if len(outs) == 1:
            return outs[0]
        first = self.rows[0][0]
        return type(outs[0])(*(None if fs[0] is None else torch.cat(
            [x.to(first) for x in fs])[:s] for fs in zip(*outs)))


@functools.lru_cache(maxsize=32)
def batched_session_pipeline(mesh, n_bytes_padded: int, blur_sigma: float = 1.0,
                             use_log: bool = True, max_groups: int = 128,
                             max_baselines_per_group: int = 192, outputs: str = "full",
                             session_axis: str = "vmap", *, device=None):
    """An [S, N]-batched pipeline on ``device`` (None: CUDA) or over
    ``mesh``'s data shards (module docstring).

    Returns fn(byte_batch [S, N] u8, n_bytes [S] i32, lut [256, 4] f32) ->
    ``DeviceSessionOut`` with a leading S axis on every field
    (``n_discarded`` None), or with ``outputs="summary"`` a
    ``SessionSummaryOut``, on the device (the mesh's first row's device);
    ``fn.shards(...)`` gives each data shard's output on its own device.
    The inputs may be numpy arrays or tensors.  ``n_bytes`` is unused: the
    padding is inert, as in the JAX package.  ``session_axis="vmap"`` runs
    the batch (one launch per kernel and shard), ``"scan"`` a loop of the
    single-session pipeline (S launches per kernel), bit-equal to it.
    Cached per argument set (module docstring): on CUDA the first call of
    a row count captures, later calls of that count replay.
    """
    if outputs not in ("full", "summary"):
        raise ValueError(f"outputs must be 'full' or 'summary', got {outputs!r}")
    if session_axis not in ("vmap", "scan"):
        raise ValueError(f"session_axis must be 'vmap' or 'scan', got {session_axis!r}")
    kw = dict(blur_sigma=blur_sigma, use_log=use_log, max_groups=max_groups,
              max_baselines_per_group=max_baselines_per_group)
    return _BatchedPipeline(placement(mesh, device), int(n_bytes_padded), outputs,
                            session_axis, kw)


def stack_sessions(raw_list: Sequence[np.ndarray], n_bytes_padded: Optional[int] = None):
    """Stack tokenized sessions into a padded [S, N] u8 batch + lengths."""
    if n_bytes_padded is None:
        n_bytes_padded = max(len(r) for r in raw_list)
    batch = np.stack([pad_bytes(r, n_bytes_padded) for r in raw_list])
    lengths = np.asarray([len(r) for r in raw_list], dtype=np.int32)
    return batch, lengths


def _bucket_groups(mesh, raw_list, quantum: int, device, pipeline_kwargs,
                   to_host: bool = False) -> list:
    """[(indices, pipeline, per-shard (output, layout, event) from
    ``_issue``)] per byte bucket, in bucket order: each group's bytes
    written into its program's staging buffers (``stage``), every shard of
    every group issued before any is read (each bucket has its own program,
    so no replay overwrites another group's outputs)."""
    groups: dict = {}
    for i, r in enumerate(raw_list):
        groups.setdefault(bucket_size(len(r), quantum), []).append(i)
    results = []
    for bucket, idxs in sorted(groups.items()):
        with annotate("slam.batch.stack"):
            fn = batched_session_pipeline(mesh, bucket, outputs="summary", device=device,
                                          **pipeline_kwargs)
            fn.stage([raw_list[i] for i in idxs])
        results.append((idxs, fn, fn._issue(device_lut(fn.rows[0][0]), to_host)))
    return results


def run_dataset_batched_grouped(mesh, raw_list: Sequence[np.ndarray], quantum: int = 1 << 18,
                                *, device=None, **pipeline_kwargs):
    """The batch without uniform-padding waste: sessions group by their
    byte bucket (``pipeline.device.bucket_size``) and one batched call runs
    per bucket, so each session is padded only to its own bucket.

    Returns ``[(indices, SessionSummaryOut), ...]``, one entry per bucket
    group in bucket order, on ``device`` (None: CUDA) or the mesh's first
    row's device.  Each output's first ``len(indices)`` rows are the
    sessions at those input positions; with a mesh the group is padded with
    empty sessions to a multiple of the data axis, and those trailing rows
    are the padding (zero frames), as in the JAX package.
    """
    out = []
    for idxs, fn, issued in _bucket_groups(mesh, raw_list, quantum, device, pipeline_kwargs):
        shards = [x if flat is None else flat.unpack(x.clone()) for x, flat, _ in issued]
        if len(shards) == 1:
            out.append((idxs, shards[0]))
            continue
        first = fn.rows[0][0]
        out.append((idxs, SessionSummaryOut(*(torch.cat([x.to(first) for x in fs])
                                              for fs in zip(*shards)))))
    return out


def run_dataset(mesh, raw_list: Sequence[np.ndarray], *, device=None, **pipeline_kwargs):
    """Every session through the per-bucket batches, ONE device-to-host copy
    per bucket and data shard, and per-session ``SessionSummaryOut`` of
    numpy arrays of their own in input order.  Every bucket is issued
    before the first is read, and each copy back is waited for through its
    event (module docstring).  Warns (JAX's message) when a session
    overflowed the corrector's bounds.  ``device`` None means CUDA; with
    ``mesh`` the shards run on its rows (module docstring).
    """
    grouped = _bucket_groups(mesh, raw_list, pipeline_kwargs.pop("quantum", 1 << 18), device,
                             pipeline_kwargs, True)
    results: list = [None] * len(raw_list)
    bad = []
    for idxs, _, issued in grouped:
        with annotate("slam.batch.readback"):
            read = [_read_back(*shard) for shard in issued]
        with annotate("slam.batch.split"):
            host = [_host_fields(r, flat) for r, (_, flat, _) in zip(read, issued)]
            fields = SessionSummaryOut(*(np.concatenate(fs) for fs in zip(*host)))
            for row, orig in enumerate(idxs):
                results[orig] = SessionSummaryOut(*(x[row] for x in fields))
            bad += [orig for row, orig in enumerate(idxs) if fields.correct_overflow[row]]
    if bad:
        warnings.warn(
            f"corrector capacity exceeded on sessions {sorted(bad)}: their rows "
            "were silently truncated — re-run with larger max_groups/"
            "max_baselines_per_group", RuntimeWarning, stacklevel=2)
    return results


def _read_back(out, flat: Optional[FlatOutputs], ready=None):
    """A shard's outputs on the host: eager outputs of a CPU device
    (``flat`` None), or a graph's flat buffer's pinned copy once ``ready``
    (the copy's event) has passed: the host waits only if the copy is still
    in flight (``READBACK_WAITS``)."""
    global READBACK_WAITS
    if ready is not None and not ready.query():
        READBACK_WAITS += 1
        ready.synchronize()
    return out


def _host_fields(read, flat: Optional[FlatOutputs]) -> SessionSummaryOut:
    """``_read_back``'s tensors as numpy arrays: a flat buffer split by its
    layout (views of one host buffer)."""
    return SessionSummaryOut(*(x.numpy() for x in (read if flat is None
                                                    else flat.unpack(read))))
