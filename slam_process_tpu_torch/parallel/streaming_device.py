"""Device streaming session: an unbounded byte stream, window by window,
with all state on the device.

The port of ``slam_process_tpu/parallel/streaming_device.py``: the single
stream (``DeviceStreamingSession``, ``replay_log_device``), S streams in
one session (``MultiStreamingSession``, on one device or over a mesh's data
shards) and the checkpoint helpers.  Both sessions run one window round
(``_WindowRound``) on a state with a leading stream axis, the single
stream at S = 1.  A round runs, on the state's device, each stage once for
all S streams: decode (kernel K1), the
corrector on the closed groups' rows (K2), the intensity sums, the open
groups' carry compaction (K5), one compaction of the kept rows (K5) into
the emit rings and, with ``collect_paths``, into fresh buffers for the
online paths, then the per-sweep sums of those rows (K4), the per-sweep
estimator (NN-OMP or SM-SIC) on the sweeps the round closed and the
tracker block (K6).  On CPU tensors every kernel's plain version runs
instead.

Semantics kept from the JAX package:

  * byte carry: consecutive windows overlap by exactly ``CARRY_BYTES``
    (every position with a full 11-byte window gets its verdict in the
    window that holds it, so no frame is lost or counted twice); a padded
    last window masks with ``n_valid``;
  * frame carry: the rows before the window's last UE-decrease boundary
    are corrected; the rows from the boundary on (the open group) carry to
    the next window in a [group_capacity, 5] buffer, in stream order;
  * emit ring: kept rows (ue, corrected_bs, rss, clk) in stream order.  An
    explicit ``emit_capacity`` is fixed (past it ``filtered`` raises while
    counts and grids stay exact); ``None`` grows the ring before a window
    that could overflow it, from a host-side bound (kept <= one frame per
    11 bytes fed), with no device read;
  * online paths: the kept rows are segmented into sweeps by UE decrease,
    seeded with the previous window's last kept UE, so the stream's sweeps
    are ``detect_groups_np(filtered[:, 0])``; the open sweep's sums carry
    over; the estimator and the tracker run on the closed sweeps only.

``SceneConfig.log_transform`` is honoured: the running sums are then float64
sums of ln(RSS) over the rows with RSS > 0 (``ops/scene.py`` bounds them
between the card and the CPU), while the online paths' per-sweep sums stay
integer (the JAX package passes ``SceneConfig()`` there), so K4 runs.

Where the port differs: the running intensity sums are int64 (exact at any
stream length; the JAX package's float32 sums are exact below 2^24 per
cell), or float64 for the pre-log scene, and the state is updated in
place (the counterpart of JAX's donated state).  The single stream's
window reads nothing back, with or without ``collect_paths``: its paths
step runs the estimator on every sweep lane and writes the lanes' block of
ring rows at ``n_closed`` on the device, as the JAX package's step does,
and the estimator's NNLS loops run on the device (kernel K7).  So on CUDA
each of its windows is one CUDA graph replay (``DeviceStreamingSession``);
its host waits only for the copy out of its staging buffer before
refilling it (``STAGING_WAITS``).  ``MultiStreamingSession`` with
``collect_paths`` reads its S closed-sweep counts once a round and shard
(``HOST_SYNCS``) and runs the estimator as the JAX package's vmapped step
does: in 8-lane blocks up to the largest count, the lanes' results written
on the device.  On CUDA its round is one graph before that read and one
after it per block count (one graph without ``collect_paths``).  On CPU
tensors the NNLS plain version syncs nothing with a device but counts its
lockstep steps (``ops/nnls.HOST_SYNCS``).
``render()`` reads the sums back, builds the grid on the host as
``intensity()`` does and rasterizes it on the session's device (K3).

The host steps are spans (``utils/profiling.annotate``):
``slam.stream.stage`` (a feed's concatenation of carry and chunk, the
windows' fill), ``slam.stream.round`` (one window round: the copy to the
device, the graphs or the eager stages), ``slam.stream.count_read`` and
``slam.stream.staging_wait`` (where ``HOST_SYNCS`` and ``STAGING_WAITS``
count), ``slam.stream.flush``, ``slam.stream.read``
(``MultiStreamingSession``'s host copies of its state) and
``slam.stream.reset``.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import pickle
import warnings
import weakref
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from slam_process_tpu_torch.config import PipelineConfig, RenderConfig, SceneConfig
from slam_process_tpu_torch.io.angles import load_angle_lut
from slam_process_tpu_torch.models.sweep_estimation import (
    estimator_dictionary, path_power, sweep_estimator_body, sweep_estimator_setup, zero_paths)
from slam_process_tpu_torch.models.tracking import Tracks, track_velocities
from slam_process_tpu_torch.ops.compact import compact_rows_streams
from slam_process_tpu_torch.ops.correct import correct_rows
from slam_process_tpu_torch.ops.decode import decode_rows_streams
from slam_process_tpu_torch.ops.scene import (
    grid_from_sums_np, grid_to_device, intensity_cell_sums, intensity_per_sweep_sums)
from slam_process_tpu_torch.ops.tracker import track_block_streams
from slam_process_tpu_torch.parallel.mesh import placement, shard_rows
from slam_process_tpu_torch.pipeline.device import resolve_device
from slam_process_tpu_torch.render.heatmap import RenderedHeatmap, render_intensity
from slam_process_tpu_torch.utils.graphs import GraphRunner, new_pool
from slam_process_tpu_torch.utils.profiling import annotate
from slam_process_tpu_torch.utils.timestamps import unwrap_clk_anchors

_LOGGER = logging.getLogger("slam_process_tpu_torch.streaming_device")

CARRY_BYTES = 10   # frame_len - 1: the only positions without a verdict
HOST_SYNCS = 0     # host reads of a window's closed-sweep count since the caller set it to 0
STAGING_WAITS = 0  # windows whose staging buffer was still being copied (the host waited)


class StreamPathsSpec(NamedTuple):
    """Configuration of online per-sweep estimation and tracking.

    The beam set (``ue_ids`` / ``bs_ids``) and the dictionary built from it
    are fixed up front; ``Session.sweep_paths(..., beam_ids=(ue_ids,
    bs_ids))`` pins the offline result to the same set.  ``s_step`` bounds
    the sweeps closing in one window and ``capacity`` the sweeps closed in
    all; past either the paths readers raise.
    """

    estimator: str          # "nn_omp" | "sm_sic"
    est_key: tuple          # from sweep_estimator_setup
    ue_ids: tuple           # participating UE beam ids (ints)
    bs_ids: tuple           # participating BS beam ids
    s_step: int             # max sweeps closing per window
    capacity: int           # max total closed sweeps
    max_tracks: int
    gate_deg: float


def make_paths_spec(angle_file, estimator: str = "nn_omp", beam_ids=None, s_step: int = 64,
                    capacity: int = 4096, max_tracks: int = 8, gate_deg: float = 10.0,
                    **overrides):
    """(spec, dict_args) for ``DeviceStreamingSession(collect_paths=...)``.

    ``beam_ids``: optional (ue_ids, bs_ids); by default every beam with a
    finite angle in the table.  ``overrides`` are ``Session.sweep_paths``'s
    estimator overrides (max_paths, grid_res, beam_width, keep_rule,
    stop_nonpositive).  ``dict_args`` is (phi_rx, phi_tx, aoa_grid,
    aod_grid) as numpy arrays in the estimator body's dtypes
    (``sweep_estimation.estimator_dictionary``: float32, the SM-SIC grids
    float64).
    """
    lut = load_angle_lut(angle_file)
    if beam_ids is None:
        ue_ids = bs_ids = np.nonzero(np.isfinite(lut))[0]
    else:
        ue_ids = np.asarray(beam_ids[0], dtype=np.int64)
        bs_ids = np.asarray(beam_ids[1], dtype=np.int64)
    d, est_key = sweep_estimator_setup(estimator, lut[ue_ids], lut[bs_ids], **overrides)
    spec = StreamPathsSpec(estimator=estimator, est_key=est_key,
                           ue_ids=tuple(int(i) for i in ue_ids),
                           bs_ids=tuple(int(i) for i in bs_ids), s_step=int(s_step),
                           capacity=int(capacity), max_tracks=int(max_tracks),
                           gate_deg=float(gate_deg))
    d = estimator_dictionary(est_key, d)
    return spec, (d.phi_rx, d.phi_tx, d.aoa_grid, d.aod_grid)


@dataclasses.dataclass
class PathsState:
    """Online-estimation state, tensors on the session's device, updated
    in place window by window.  Rings hold ``capacity + s_step + 1`` rows;
    rows past ``n_closed`` are never read."""

    open_sums: torch.Tensor     # [64, 64] f32: the open sweep's cells so far
    open_counts: torch.Tensor   # [64, 64] f32
    open_time: torch.Tensor     # i32: CLK of the open sweep's first kept row (-1: none)
    last_kept_ue: torch.Tensor  # i32: the last kept row's UE (-1: none)
    n_closed: torch.Tensor      # i32: sweeps closed and estimated
    overflow: torch.Tensor      # bool: s_step or capacity exceeded
    est_rings: tuple            # OmpPaths ([P, K] per field, n_iters [P]) or SmSicPaths
    valid_ring: torch.Tensor    # [P] bool: the sweep had an observed cell
    time_ring: torch.Tensor     # [P] i32 raw CLK anchors
    trk_pos: torch.Tensor       # [T, 2] f32 tracker carry
    trk_created: torch.Tensor   # [T] bool
    trk_count: torch.Tensor     # i32
    trk_aoa: torch.Tensor       # [P, T] f32 track columns
    trk_aod: torch.Tensor       # [P, T] f32
    trk_pow: torch.Tensor       # [P, T] f32
    trk_obs: torch.Tensor       # [P, T] bool


@dataclasses.dataclass
class DeviceStreamState:
    """The stream's state, tensors on the session's device, updated in
    place window by window."""

    carry_frames: torch.Tensor   # [Gcap, 5] i32: the open group's rows
    carry_count: torch.Tensor    # i32
    sums: torch.Tensor           # [64, 64] int64 running intensity sums (float64 pre-log)
    counts: torch.Tensor         # [64, 64] int64 running cell counts
    n_frames: torch.Tensor       # i32
    n_kept: torch.Tensor         # i32
    n_groups: torch.Tensor       # i32 closed groups
    overflow: torch.Tensor       # bool: a corrector or carry bound was exceeded
    emit_buf: torch.Tensor       # [Ecap, 4] i32 (ue, corrected_bs, rss, clk)
    emit_count: torch.Tensor     # i32 rows in emit_buf
    emit_overflow: torch.Tensor  # bool: kept rows were dropped at the ring's end
    paths: Optional[PathsState]


def _zero_stream_state(lead: tuple, gcap: int, nb: int, ecap: int, log_transform: bool,
                       spec: Optional[StreamPathsSpec], dev) -> DeviceStreamState:
    """The zero state, every tensor with the leading shape ``lead`` (``()``
    for one stream, ``(S,)`` for S streams).  Not all zeros: the paths
    state's open time and last kept UE start at -1."""

    def scalar(value, dtype=torch.int32):
        return torch.full(lead, value, dtype=dtype, device=dev)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(lead + shape, dtype=dtype, device=dev)

    paths = None
    if spec is not None:
        p_n = spec.capacity + spec.s_step + 1
        t_n = spec.max_tracks
        f32 = torch.float32
        rings = zero_paths(spec.est_key, p_n, dev)
        rings = type(rings)(*(zeros(*x.shape, dtype=x.dtype) for x in rings))
        paths = PathsState(
            open_sums=zeros(nb, nb, dtype=f32), open_counts=zeros(nb, nb, dtype=f32),
            open_time=scalar(-1), last_kept_ue=scalar(-1), n_closed=scalar(0),
            overflow=scalar(False, torch.bool), est_rings=rings,
            valid_ring=zeros(p_n, dtype=torch.bool), time_ring=zeros(p_n),
            trk_pos=zeros(t_n, 2, dtype=f32), trk_created=zeros(t_n, dtype=torch.bool),
            trk_count=scalar(0), trk_aoa=zeros(p_n, t_n, dtype=f32),
            trk_aod=zeros(p_n, t_n, dtype=f32), trk_pow=zeros(p_n, t_n, dtype=f32),
            trk_obs=zeros(p_n, t_n, dtype=torch.bool))
    return DeviceStreamState(
        carry_frames=zeros(gcap, 5), carry_count=scalar(0),
        sums=zeros(nb, nb, dtype=torch.float64 if log_transform else torch.int64),
        counts=zeros(nb, nb, dtype=torch.int64),
        n_frames=scalar(0), n_kept=scalar(0), n_groups=scalar(0),
        overflow=scalar(False, torch.bool), emit_buf=zeros(ecap, 4),
        emit_count=scalar(0), emit_overflow=scalar(False, torch.bool), paths=paths)


def _leaves(obj) -> list:
    """The state's tensors in a fixed order (the checkpoint's leaf table)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if obj is None:
        return []
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj) for x in _leaves(getattr(obj, f.name))]
    return [x for item in obj for x in _leaves(item)]


def _group_starts(ue: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[S, F] bool: a valid row whose UE is below the previous valid row's
    in its stream.  The first valid row continues the carried open group.
    The previous row is an index into the flattened rows (positions run on
    across streams, so a stream's running max stays in that stream)."""
    pos = torch.arange(ue.numel(), device=ue.device).view(ue.shape)
    last = torch.cummax(torch.where(valid, pos, -1), dim=-1).values
    prev = torch.cat([last.new_full(last.shape[:-1] + (1,), -1), last], dim=-1)[..., :-1]
    return valid & (prev >= 0) & (ue.flatten()[prev.clamp(min=0)] > ue)


def _kept_rows(frames: torch.Tensor, corrected: torch.Tensor) -> torch.Tensor:
    """[..., F, 4] i32 (ue, corrected_bs, rss, clk): the emitted row layout."""
    return torch.stack([frames[..., 1], corrected, frames[..., 3], frames[..., 4]], dim=-1)


def _host_to(dev: torch.device, array: np.ndarray) -> torch.Tensor:
    """A host array on ``dev``: through pinned memory and a copy that does
    not wait, on CUDA (a pageable copy would wait for the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _map_state(st: DeviceStreamState, fn) -> DeviceStreamState:
    """A new state object with ``fn`` applied to every tensor of ``st``:
    ``x[None]`` lifts a single stream's state to S = 1 (views, so in-place
    updates reach the original), ``x[0]`` lowers it again,
    ``x.index_select(0, idx)`` picks streams."""
    def pick(x):
        if isinstance(x, torch.Tensor):
            return fn(x)
        if x is None:
            return None
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: pick(getattr(x, f.name)) for f in dataclasses.fields(x)})
        return type(x)(*(pick(item) for item in x))
    return pick(st)


class _PathsMid(NamedTuple):
    """The paths step's values between its two halves
    (``_paths_before_read``, ``_paths_after_read``)."""

    sums: torch.Tensor      # [S s1, nb, nb] f32: each sweep lane's cells, the open sweep's added
    counts: torch.Tensor    # [S s1, nb, nb] f32
    times: torch.Tensor     # [S s1] i32: CLK of each lane's first kept row (-1: none)
    m: torch.Tensor         # [S] i32 sweeps closed by a boundary
    m_eff: torch.Tensor     # [S] i32 sweeps that close (at the flush also the open one)
    last_ue: torch.Tensor   # [S] i32 the last kept row's UE


def _paths_before_read(p: PathsState, kr: torch.Tensor, n_keep: torch.Tensor,
                       spec: StreamPathsSpec, close_all: bool) -> _PathsMid:
    """The first half of the paths step for S streams, up to the closed-
    sweep counts: ``kr`` [S, T, 4] holds one window round's kept rows,
    compacted in stream order (K5), the first ``n_keep[s]`` of stream s.

    They are exactly the offline filtered table's rows, so segmenting them
    by UE decrease, seeded with ``last_kept_ue``, reproduces
    ``detect_groups_np(filtered[:, 0])``.  One K4 launch gives the sums of
    the S s1 sweep lanes (sweep ids offset by ``s * s1``); lane 0 of each
    stream adds the open sweep's sums.  At the flush (``close_all``) the
    open sweep closes too if it has cells.  Reads ``p`` only."""
    dev = kr.device
    s_n, t = kr.shape[:2]
    s1 = spec.s_step + 1
    nb = p.open_sums.shape[-1]
    ue, bs, rss, clk = kr.unbind(dim=-1)
    idx = _steps(t, 1, dev)
    inside = idx[None] < n_keep[:, None]
    prev_ue = torch.cat([p.last_kept_ue[:, None], ue[:, :-1]], dim=1)
    bnd = inside & (prev_ue > ue)
    ls = torch.cumsum(bnd, dim=1, dtype=torch.int32)         # local sweep id per row
    m = bnd.sum(dim=1, dtype=torch.int32)                    # sweeps closed by a boundary
    last_at = (n_keep - 1).clamp(min=0).long()[:, None]
    last_ue = torch.where(n_keep > 0, torch.gather(ue, 1, last_at)[:, 0], p.last_kept_ue)

    use = inside & (ls < s1)
    lane_of = ls + _steps(s_n, s1, dev)[:, None]             # flattened sweep lane
    sums, counts = intensity_per_sweep_sums(ue.flatten(), bs.flatten(), rss.flatten(),  # K4
                                            lane_of.flatten(), use.flatten(), s_n * s1)
    sums, counts = sums.view(s_n * s1, nb, nb), counts.view(s_n * s1, nb, nb)
    sums.view(s_n, s1, nb, nb)[:, 0] += p.open_sums
    counts.view(s_n, s1, nb, nb)[:, 0] += p.open_counts
    # CLK of each lane's first kept row; lane 0 of a stream inherits the
    # open sweep's anchor.  The last bin collects the rows that start none.
    first = use & (bnd | (idx == 0)[None])
    times = torch.full((s_n * s1 + 1,), -1, dtype=torch.int32, device=dev)
    times.index_put_((torch.where(first, lane_of, s_n * s1).flatten().long(),), clk.flatten())
    times = times[:-1]
    times[::s1] = torch.where(p.open_time >= 0, p.open_time, times[::s1])

    m_eff = m
    if close_all:
        in_lane = counts.view(s_n, s1, nb, nb).sum(dim=(2, 3))
        has_open = torch.gather(in_lane, 1, m.clamp(max=s1 - 1).long()[:, None])[:, 0] > 0
        m_eff = m + has_open.to(torch.int32)
    return _PathsMid(sums, counts, times, m, m_eff, last_ue)


def _lane_groups(nblk: int, s1: int, one_call: bool) -> tuple:
    """The estimator's calls for ``nblk`` of the JAX package's 8-lane blocks
    (``blk = min(8, s1)``, block i starting at ``min(blk i, s1 - blk)``):
    ((first lane, lanes), ...), block after block, or with ``one_call`` one
    call over lanes [0, min(blk nblk, s1)), the blocks' union."""
    blk = min(8, s1)
    if one_call:
        return ((0, min(blk * nblk, s1)),) if nblk else ()
    return tuple((min(blk * i, s1 - blk), blk) for i in range(nblk))


def _paths_after_read(p: PathsState, mid: _PathsMid, spec: StreamPathsSpec, dict_args,
                      beam_ids, close_all: bool, groups: tuple, own_blocks: bool) -> None:
    """The second half of the paths step, in place: the per-sweep estimator
    on the lanes of ``groups`` (``_lane_groups``) of every stream, the
    tracker block (one K6 launch for the S trackers, which takes the
    closed-sweep counts on the device), the ring writes and the open
    sweep's carry.  Reads nothing back.

    The JAX package's block write: each lane j's results go to ring row
    ``n_closed + j`` of its stream (the rings hold ``capacity + s1`` rows),
    the time ring and the track columns for all s1 lanes.  Rows past the
    new ``n_closed`` are slack that no reader reads and a later round
    overwrites: the groups cover every stream's closing sweeps, and the
    lanes past a stream's count are empty sweeps or its open sweep, which
    change no row below ``n_closed`` (a block's clamped start recomputes
    lanes an earlier block wrote, with the same values).  With
    ``own_blocks`` (the multi-stream round) a stream's estimator rings take
    only the lanes of its own blocks, ``[0, min(blk ceil(min(m_eff, s1) /
    blk), s1))``, as under the JAX package's ``vmap`` of its block loop,
    so that its slack rows do not depend on the other streams of its shard.
    The open lanes are taken by a device index."""
    s_n = p.n_closed.shape[0]
    dev = p.n_closed.device
    s1 = spec.s_step + 1
    nb = p.open_sums.shape[-1]
    k_n = p.est_rings.aoa.shape[-1]
    p_n = p.valid_ring.shape[1]
    ring_idx = (_steps(s_n, p_n, dev)[:, None] + p.n_closed[:, None]
                + _steps(s1, 1, dev)[None]).long()                     # [S, s1] flat ring rows
    lanes = [torch.zeros((s_n, s1, k_n), dtype=torch.float32, device=dev) for _ in range(3)]
    val_l = torch.zeros((s_n, s1, k_n), dtype=torch.bool, device=dev)
    if own_blocks:
        blk = min(8, s1)
        own = ((mid.m_eff.clamp(max=s1) + blk - 1) // blk * blk).clamp(max=s1)   # [S] lanes
    for start, width in groups:
        at = slice(start, start + width)
        counts_l = mid.counts.view(s_n, s1, nb, nb)[:, at].reshape(-1, nb, nb)
        sums_l = mid.sums.view(s_n, s1, nb, nb)[:, at].reshape(-1, nb, nb)
        mean = torch.where(counts_l > 0, sums_l / counts_l.clamp(min=1.0), float("nan"))
        sub = mean[:, beam_ids[0]][:, :, beam_ids[1]]
        est, sv = sweep_estimator_body(spec.est_key)(sub, *dict_args)
        rows = ring_idx[:, at].flatten()
        if own_blocks:
            mine = ((_steps(width, 1, dev) + start)[None] < own[:, None]).flatten()
        for ring, block in zip((*p.est_rings, p.valid_ring), (*est, sv)):
            flat = ring.flatten(0, 1)
            if own_blocks:
                block = torch.where(mine.view((-1,) + (1,) * (block.dim() - 1)), block,
                                    flat.index_select(0, rows))
            flat.index_copy_(0, rows, block)
        for lane, x in zip((*lanes, val_l), (est.aoa, est.aod, path_power(est),
                                             est.valid & sv[:, None])):
            lane[:, at] = x.view(s_n, width, k_n)
    rows = ring_idx.flatten()
    p.time_ring.flatten(0, 1).index_copy_(0, rows, mid.times)

    c_aoa, c_aod, c_pow, c_obs, pos, created, count = track_block_streams(        # K6
        *lanes, val_l, mid.m_eff, p.trk_pos, p.trk_created, p.trk_count, spec.gate_deg)
    for ring, col in ((p.trk_aoa, c_aoa), (p.trk_aod, c_aod), (p.trk_pow, c_pow),
                      (p.trk_obs, c_obs)):
        ring.flatten(0, 1).index_copy_(0, rows, col.flatten(0, 1))
    for x, new in ((p.trk_pos, pos), (p.trk_created, created), (p.trk_count, count)):
        x.copy_(new)

    p.overflow |= (mid.m_eff > spec.s_step) | (p.n_closed + mid.m_eff > spec.capacity)
    p.n_closed.add_(mid.m_eff).clamp_(max=spec.capacity)
    p.last_kept_ue.copy_(mid.last_ue)
    if close_all:
        p.open_sums.zero_()
        p.open_counts.zero_()
        p.open_time.fill_(-1)
    else:
        at_mc = (_steps(s_n, s1, dev) + mid.m.clamp(max=s1 - 1)).long()   # each open lane
        open_counts = mid.counts.index_select(0, at_mc)
        p.open_sums.copy_(mid.sums.index_select(0, at_mc))
        p.open_counts.copy_(open_counts)
        p.open_time.copy_(torch.where(open_counts.sum(dim=(1, 2)) > 0,
                                      mid.times.index_select(0, at_mc), -1))


@functools.lru_cache(maxsize=None)
def _steps(n: int, step: int, dev: torch.device) -> torch.Tensor:
    """int32 [n]: 0, step, 2 step, ... on ``dev``, made once per (n, step,
    device); callers must not write to it."""
    return torch.arange(0, n * step, step, dtype=torch.int32, device=dev)


class _Window(NamedTuple):
    """One window round's rows after decode and correction, per stream."""

    combined: torch.Tensor    # [S, Gcap + R, 5] i32: the carried group, then the window's rows
    open_mask: torch.Tensor   # [S, Gcap + R] bool: valid rows of the still-open group
    boundary: torch.Tensor    # [S, Gcap + R] bool: rows that start a group
    corrected: torch.Tensor   # [S, Gcap + R] i32 corrected BS
    keep: torch.Tensor        # [S, Gcap + R] bool: kept (filtered) rows
    c_overflow: torch.Tensor  # [S] bool: the corrector's bounds were exceeded
    n_new: torch.Tensor       # [S] i32 frames decoded in the window


class _WindowRound:
    """What both sessions share: the bounds, the online-paths configuration
    and the window round on an [S, ...] state, one launch per stage for
    all S streams.  ``DeviceStreamingSession`` runs it at S = 1 on a view
    of its state."""

    # The paths step's lanes (``_paths_after_read``): every lane in one
    # estimator call with no host read (the single stream), or the JAX
    # package's 8-lane blocks, block after block, up to the largest count
    # after one read of the S counts.
    _every_lane = False

    def _setup(self, config, chunk_bytes, group_capacity, max_groups,
               max_baselines_per_group, n_beams, collect_paths, device) -> None:
        self.config = config or PipelineConfig()
        if n_beams != self.config.scene.n_beams:
            raise ValueError(f"n_beams={n_beams} differs from the scene config's "
                             f"{self.config.scene.n_beams}")
        self.chunk_bytes = int(chunk_bytes)
        if self.chunk_bytes <= CARRY_BYTES:
            raise ValueError("chunk_bytes must exceed the 10-byte carry")
        self.device = resolve_device(device)
        self._gcap = int(group_capacity)
        self._mg = int(max_groups)
        self._mbpg = int(max_baselines_per_group)
        self._n_beams = int(n_beams)
        if collect_paths is not None:
            spec, dict_args = collect_paths
            self._paths_spec: Optional[StreamPathsSpec] = spec
            self._dict_args = tuple(torch.as_tensor(a, device=self.device) for a in dict_args)
            self._beam_ids = tuple(torch.tensor(ids, dtype=torch.long, device=self.device)
                                   for ids in (spec.ue_ids, spec.bs_ids))
        else:
            self._paths_spec = None
            self._dict_args = ()
            self._beam_ids = ()

    def _close_streams(self, st: DeviceStreamState, pieces: torch.Tensor,
                       lens: Optional[torch.Tensor]) -> _Window:
        """Decode the S windows ``pieces`` [S, chunk_bytes] (stream s's first
        ``lens[s]`` bytes; None: all) after each stream's carried open
        group, and correct the groups each stream's last UE-decrease
        boundary closes.  Reads ``st`` only."""
        cfg = self.config
        rows_new, valid_new, n_new = decode_rows_streams(pieces, cfg.decode, n_valid=lens)  # K1
        combined = torch.cat([st.carry_frames, rows_new], dim=1)
        rows = _steps(combined.shape[1], 1, self.device)
        valid = torch.cat([rows[None, :self._gcap] < st.carry_count[:, None], valid_new], dim=1)
        boundary = _group_starts(combined[..., 1], valid)
        closed = torch.where(boundary, rows, 0).amax(dim=1, keepdim=True)  # 0: no boundary
        corrected, keep, c_overflow = correct_rows(                                        # K2
            combined, valid & (rows < closed), self._mg, self._mbpg, cfg.correct)
        return _Window(combined, valid & (rows >= closed), boundary, corrected, keep,
                       c_overflow, n_new)

    def _round(self, st: DeviceStreamState, pieces: torch.Tensor,
               lens: Optional[torch.Tensor]) -> None:
        """One window round for the S streams of ``st``, in place: the JAX
        package's ``_step_body`` with a leading S axis."""
        _drain([(self, functools.partial(self._round_pre, st, pieces, lens),
                 functools.partial(self._round_post, st))])

    def _round_pre(self, st: DeviceStreamState, pieces: torch.Tensor,
                   lens: Optional[torch.Tensor]) -> Optional[_PathsMid]:
        """A round up to the host read of the closed-sweep counts: K1, K2,
        the sums, K5 twice, the counters and the paths step's first half
        (K4), whose values it returns (None without ``collect_paths``: the
        round is then whole)."""
        w = self._close_streams(st, pieces, lens)
        d_sums, d_counts = intensity_cell_sums(w.combined[..., 1], w.corrected,
                                               w.combined[..., 3], w.keep, w.combined[..., 0],
                                               self.config.scene)
        st.sums += d_sums
        st.counts += d_counts
        (new_carry,), n_carry = compact_rows_streams(                                      # K5
            w.combined, w.open_mask, [(self._gcap, None, None)])
        emitted = self._emit(st, _kept_rows(w.combined, w.corrected), w.keep)
        st.carry_frames.copy_(new_carry)
        st.carry_count.copy_(n_carry.clamp(max=self._gcap))
        st.n_frames += w.n_new
        st.n_kept += w.keep.sum(dim=1, dtype=torch.int32)
        st.n_groups += w.boundary.sum(dim=1, dtype=torch.int32)
        st.overflow |= w.c_overflow | (n_carry > self._gcap)
        return self._paths_pre(st, emitted, close_all=False)

    def _round_post(self, st: DeviceStreamState, mid: Optional[_PathsMid], nblk: int,
                    close_all: bool = False) -> None:
        """The rest of a round (or of a flush) after the count read: the
        paths step's second half on ``nblk`` blocks (``_blocks``)."""
        if mid is not None:
            _paths_after_read(st.paths, mid, self._paths_spec, self._dict_args,
                              self._beam_ids, close_all, self._groups(nblk),
                              not self._every_lane)

    def _blocks(self, mid: Optional[_PathsMid]) -> int:
        """The estimator's 8-lane blocks for this round: all of them for the
        single stream, which reads nothing; else the JAX package's
        ``ceil(min(max_s m_eff, s1) / blk)``, from one host read of the S
        counts (``HOST_SYNCS``).  0 without ``collect_paths``."""
        global HOST_SYNCS
        if mid is None:
            return 0
        s1 = self._paths_spec.s_step + 1
        if self._every_lane:
            m_max = s1
        else:
            HOST_SYNCS += 1
            with annotate("slam.stream.count_read"):
                m_max = min(int(mid.m_eff.amax()), s1)
        return -(-m_max // min(8, s1))

    def _groups(self, nblk: int) -> tuple:
        """The estimator's calls for ``nblk`` blocks (``_lane_groups``): every
        lane in one call for the single stream."""
        return _lane_groups(nblk, self._paths_spec.s_step + 1, self._every_lane)

    def _emit(self, st: DeviceStreamState, kept: torch.Tensor, keep: torch.Tensor):
        """One compaction of the kept rows (K5) for both their consumers:
        each stream's emit ring at its count (offsets read on the device;
        rows past the capacity are dropped and flagged) and the online
        paths' fresh buffers, which it returns with their counts (None
        without ``collect_paths``)."""
        dests = []
        if self._ecap:
            dests.append((self._ecap, st.emit_buf, st.emit_count))
        if st.paths is not None:
            dests.append((kept.shape[1], None, None))
        if not dests:
            return None
        outs, n = compact_rows_streams(kept, keep, dests)                                 # K5
        if self._ecap:
            st.emit_overflow |= st.emit_count + n > self._ecap
            st.emit_count.add_(n).clamp_(max=self._ecap)
        return None if st.paths is None else (outs[-1], n)

    def _paths_pre(self, st: DeviceStreamState, emitted, close_all: bool):
        if emitted is None:
            return None
        return _paths_before_read(st.paths, *emitted, self._paths_spec, close_all)

    def _flush(self, st: DeviceStreamState) -> None:
        """Close the open group of every stream of ``st``, in place."""
        with annotate("slam.stream.flush"):
            _drain([(self, functools.partial(self._flush_pre, st),
                     functools.partial(self._round_post, st, close_all=True))])

    def _flush_pre(self, st: DeviceStreamState) -> Optional[_PathsMid]:
        """``_flush`` up to the count read, as ``_round_pre`` is."""
        cfg = self.config
        valid = _steps(self._gcap, 1, self.device)[None] < st.carry_count[:, None]
        corrected, keep, c_overflow = correct_rows(st.carry_frames, valid, self._mg,
                                                   self._mbpg, cfg.correct)
        cf = st.carry_frames
        d_sums, d_counts = intensity_cell_sums(cf[..., 1], corrected, cf[..., 3], keep,
                                               cf[..., 0], cfg.scene)
        st.sums += d_sums
        st.counts += d_counts
        emitted = self._emit(st, _kept_rows(cf, corrected), keep)
        st.n_kept += keep.sum(dim=1, dtype=torch.int32)
        st.n_groups += (st.carry_count > 0).to(torch.int32)
        st.overflow |= c_overflow
        st.carry_frames.zero_()
        st.carry_count.zero_()
        return self._paths_pre(st, emitted, close_all=True)

    # -- the multi-stream round's window buffer and CUDA graphs ----------------

    def _init_rounds(self, n_rows: int) -> None:
        """The static window input of a shard of ``n_rows`` streams: K1's
        limits as int64 at the buffer's start, the [n_rows, chunk_bytes]
        pieces from ``_win_off`` (a multiple of 128 bytes), filled from one
        pinned staging buffer on CUDA; and no graph yet (the state is
        written in place by every path, so a graph lives as long as the
        shard)."""
        self._win_off = -(-8 * n_rows // 128) * 128
        size = self._win_off + n_rows * self.chunk_bytes
        self._win = torch.zeros(size, dtype=torch.uint8, device=self.device)
        if self.device.type == "cuda":
            self._win_staging = torch.zeros(size, dtype=torch.uint8, pin_memory=True)
            self._win_staged = torch.cuda.Event()
        else:
            self._win_staging, self._win_staged = self._win, None
        self._win_np = self._win_staging.numpy()
        self._pre_graph: Optional[GraphRunner] = None
        self._post_graphs: dict = {}          # nblk -> GraphRunner
        self._pool = None

    def _win_inputs(self):
        """(pieces [n_rows, chunk_bytes] u8, K1's limits [n_rows] int64):
        views of the window buffer."""
        n_rows = self._state.n_frames.shape[0]
        return (self._win[self._win_off:].view(n_rows, -1),
                self._win[:8 * n_rows].view(torch.int64))

    def _staged(self):
        """(lens [n_rows] int64, pieces [n_rows, chunk_bytes] u8): numpy
        views of the staging buffer, to be filled with a round's windows.
        On CUDA the host first waits for the previous round's copy out of
        it (``STAGING_WAITS``), as ``DeviceStreamingSession._load_window``
        does."""
        global STAGING_WAITS
        if self._win_staged is not None and not self._win_staged.query():
            STAGING_WAITS += 1
            with annotate("slam.stream.staging_wait"):
                self._win_staged.synchronize()
        n_rows = self._state.n_frames.shape[0]
        return (self._win_np[:8 * n_rows].view(np.int64),
                self._win_np[self._win_off:].reshape(n_rows, -1))

    def _send(self) -> None:
        """The staged round into the window buffer: on CUDA one copy that
        does not wait (the CPU stages in the window buffer itself)."""
        if self._win_staged is not None:
            self._win.copy_(self._win_staging, non_blocking=True)
            self._win_staged.record()

    def _pre(self) -> Optional[_PathsMid]:
        """The loaded round up to the count read: eager on the CPU; on CUDA
        one graph, captured at the first round, whose static outputs hold
        the values the post-read graphs read (after the capture the warm-up
        run's values are copied into them)."""
        if self.device.type != "cuda":
            return self._round_pre(self._state, *self._win_inputs())
        if self._pre_graph is None:
            this, st, inputs = weakref.ref(self), self._state, self._win_inputs()
            self._pool = new_pool()
            self._pre_graph = GraphRunner(lambda: this()._round_pre(st, *inputs),
                                          device=self.device, pool=self._pool)
        mid = self._pre_graph.run()
        static = self._pre_graph.outputs
        if mid is not static:                 # the first run returns the warm-up's values
            for x, y in zip(static, mid):
                x.copy_(y)
        return static

    def _post(self, mid: Optional[_PathsMid], nblk: int) -> None:
        """The round after the count read: eager on the CPU; on CUDA the
        graph of ``nblk`` blocks, captured at its first use, reading the
        pre-read graph's static outputs."""
        if mid is None:
            return
        if self.device.type != "cuda":
            self._round_post(self._state, mid, nblk)
            return
        graph = self._post_graphs.get(nblk)
        if graph is None:
            this, st = weakref.ref(self), self._state
            graph = self._post_graphs[nblk] = GraphRunner(
                lambda: this()._round_post(st, mid, nblk), device=self.device, pool=self._pool)
        graph.run()


def _drain(jobs: list) -> None:
    """Run one window step (a round or a flush) of each mesh shard: ``jobs``
    holds (shard, its part up to the count read, its part after:
    ``post(mid, nblk)``).  Every shard's first part runs first, so that
    every shard's work is queued on its device before the host waits on
    any; then each shard's count read (``_WindowRound._blocks``); then each
    shard's second part."""
    mids = [pre() for _, pre, _ in jobs]
    nblks = [sh._blocks(mid) for (sh, _, _), mid in zip(jobs, mids)]
    for (_, _, post), mid, nblk in zip(jobs, mids, nblks):
        post(mid, nblk)


def _lift(x: torch.Tensor) -> torch.Tensor:
    return x[None]


def _lower(x: torch.Tensor) -> torch.Tensor:
    return x[0]


class DeviceStreamingSession(_WindowRound):
    """Unbounded-stream session with all state on one device.

    ``feed`` runs one window per ``chunk_bytes`` (host syncs only with
    ``collect_paths``, as the module docstring counts them): the window
    round of ``MultiStreamingSession`` at S = 1, on a view of the state
    with a leading axis of 1.  Results are read back when a property or
    reader is called.  ``device=None`` means CUDA.

    Every window, full or the short last piece of a feed, is one static
    input: its bytes, zero-padded to ``chunk_bytes``, and K1's limit (their
    count), in one device buffer that one pinned staging buffer fills.  The
    paths step takes the read-free form (``_every_lane``: the estimator on
    all s_step + 1 lanes in one call, NNLS in kernel K7), so a window reads
    nothing back, with or without ``collect_paths``.  So on CUDA the round
    is one CUDA graph (the counterpart of the JAX package's jitted step
    with a donated state): the first window runs it once and captures it,
    every later window, whatever its length, replays it.  A grown emit
    ring drops the graph and the next window captures anew.  ``finalize``
    runs once a stream and stays eager, in the same read-free form (the JAX
    package jits its flush; a graph of a single call would save nothing).
    """

    _every_lane = True

    def __init__(self, config: Optional[PipelineConfig] = None, chunk_bytes: int = 1 << 20,
                 group_capacity: int = 8192, max_groups: int = 128,
                 max_baselines_per_group: int = 192, collect_filtered: bool = False,
                 n_beams: int = 64, emit_capacity: Optional[int] = None, collect_paths=None,
                 device=None):
        self._setup(config, chunk_bytes, group_capacity, max_groups, max_baselines_per_group,
                    n_beams, collect_paths, device)
        self.collect_filtered = bool(collect_filtered)
        # An explicit emit_capacity is fixed; None grows the ring in place.
        self._emit_auto = self.collect_filtered and emit_capacity is None
        if self.collect_filtered:
            self._ecap = int(emit_capacity) if emit_capacity is not None else 1 << 18
        else:
            self._ecap = 0
        self._emit_bound = 0     # kept rows <= one frame per 11 bytes fed
        self._state = self._zero_state()
        # The window: K1's limit as int64 in bytes [0, 8), the bytes from 16.
        self._window = torch.zeros(16 + self.chunk_bytes, dtype=torch.uint8,
                                   device=self.device)
        if self.device.type == "cuda":
            self._staging = torch.zeros(16 + self.chunk_bytes, dtype=torch.uint8,
                                        pin_memory=True)
            self._staged = torch.cuda.Event()
        else:
            self._staging, self._staged = self._window, None
        self._staging_np = self._staging.numpy()
        self._graph: Optional[GraphRunner] = None
        self._byte_carry = np.zeros(0, dtype=np.uint8)
        self._finalized = False
        self._overflow_warned = False
        self.checkpoint_extra = None

    def _zero_state(self) -> DeviceStreamState:
        return _zero_stream_state((), self._gcap, self._n_beams, self._ecap,
                                  self.config.scene.log_transform, self._paths_spec,
                                  self.device)

    def _maybe_grow_emit(self, rows_next: int) -> None:
        """Grow the emit ring before a window that could overflow it: a new
        tensor and one copy, from the host-side bound (no device read)."""
        if not self._emit_auto:
            return
        need = self._emit_bound + rows_next
        if need <= self._ecap:
            return
        new_ecap = -(-max(self._ecap * 2, need) // (1 << 18)) * (1 << 18)
        _LOGGER.info("emit ring grows: %d -> %d rows", self._ecap, new_ecap)
        grown = torch.zeros((new_ecap, 4), dtype=torch.int32, device=self.device)
        grown[:self._ecap] = self._state.emit_buf
        self._state.emit_buf = grown
        self._ecap = new_ecap
        self._graph = None       # it writes the old ring: the next window recaptures

    # -- ingest --------------------------------------------------------------

    def feed(self, chunk: Union[bytes, np.ndarray]) -> None:
        """Consume one chunk of tokenized bytes (any length)."""
        if self._finalized:
            raise RuntimeError(
                "session already finalized: the flush closed the open sweep group, so "
                "feeding more bytes would mis-segment sweeps; start (or restore) a "
                "non-finalized session")
        if isinstance(chunk, (bytes, bytearray)):
            chunk = np.frombuffer(chunk, dtype=np.uint8)
        with annotate("slam.stream.stage"):
            buf = np.concatenate([self._byte_carry, np.asarray(chunk, dtype=np.uint8)])
        n = len(buf)
        c = self.chunk_bytes
        off = 0
        # Consecutive windows overlap by 10 bytes: a frame straddling a
        # window edge is decoded once, in the window that holds all of it.
        while n - off > CARRY_BYTES:
            piece = buf[off:off + c]
            rows_next = len(piece) // 11 + 1
            self._maybe_grow_emit(rows_next)
            self._step(piece, len(piece))
            self._emit_bound += rows_next
            off = min(off + c, n) - CARRY_BYTES
        self._byte_carry = buf[off:].copy()

    def _load_window(self, piece: np.ndarray, m: int) -> None:
        """Write a window, the ``m`` <= ``chunk_bytes`` bytes of ``piece``,
        and its length into the window buffer: on CUDA through the staging
        buffer and one copy that does not wait.  Before it refills the
        staging buffer the host waits for the previous window's copy out of
        it, so it runs at most about one window ahead of the device
        (``STAGING_WAITS`` counts the windows that waited)."""
        global STAGING_WAITS
        if self._staged is not None and not self._staged.query():
            STAGING_WAITS += 1
            with annotate("slam.stream.staging_wait"):
                self._staged.synchronize()
        with annotate("slam.stream.stage"):
            buf = self._staging_np
            buf[:8] = np.array([m], np.int64).view(np.uint8)
            buf[16:16 + m] = piece[:m]
            buf[16 + m:] = 0
        if self._staged is not None:
            self._window.copy_(self._staging, non_blocking=True)
            self._staged.record()

    def _window_inputs(self):
        """(pieces [1, chunk_bytes] u8, K1's limits [1] int64): views of the
        window buffer."""
        return self._window[16:].view(1, -1), self._window[:8].view(torch.int64)

    def _step(self, piece: np.ndarray, n_bytes: int) -> None:
        """One window (the ``n_bytes`` <= ``chunk_bytes`` bytes of
        ``piece``): the S = 1 round on the lifted state, in place; a CUDA
        graph on CUDA (the class docstring)."""
        self._load_window(piece, n_bytes)
        with annotate("slam.stream.round"):
            if self.device.type != "cuda":
                self._round(_map_state(self._state, _lift), *self._window_inputs())
                return
            if self._graph is None:
                st, inputs = _map_state(self._state, _lift), self._window_inputs()
                this = weakref.ref(self)      # the graph must not keep its session alive
                self._graph = GraphRunner(lambda: this()._round(st, *inputs),
                                          device=self.device)
            self._graph.run()

    def _close_groups(self, piece: np.ndarray, n_bytes: int) -> _Window:
        """A window's decode and correction without the stream axis, the
        state untouched: the kernel timers' K5 inputs."""
        self._load_window(piece, n_bytes)
        w = self._close_streams(_map_state(self._state, _lift), *self._window_inputs())
        return _Window(*(_lower(x) for x in w))

    def finalize(self) -> None:
        """Flush the final open sweep group (end of stream); a second call
        does nothing."""
        if self._finalized:
            return
        self._flush(_map_state(self._state, _lift))
        self._byte_carry = np.zeros(0, dtype=np.uint8)
        self._finalized = True

    # -- results -------------------------------------------------------------

    def _check_overflow(self) -> None:
        """Warn once when a static bound was exceeded: rows were dropped or
        mis-corrected, so counts and grids are incomplete.  The bytes are
        gone, so there is no fallback: rebuild with larger bounds."""
        if self._overflow_warned or not bool(self._state.overflow):
            return
        self._overflow_warned = True
        msg = ("DeviceStreamingSession capacity exceeded (group_capacity/max_groups/"
               "max_baselines_per_group): results are incomplete; rebuild with larger bounds")
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
        _LOGGER.warning(msg)

    @property
    def n_frames(self) -> int:
        self._check_overflow()
        return int(self._state.n_frames)

    @property
    def n_kept(self) -> int:
        self._check_overflow()
        return int(self._state.n_kept)

    @property
    def n_groups(self) -> int:
        self._check_overflow()
        return int(self._state.n_groups)

    @property
    def overflow(self) -> bool:
        return bool(self._state.overflow)

    @property
    def filtered(self) -> np.ndarray:
        """Corrected rows [N, 4] int64 (ue, corrected_bs, rss, clk), in
        stream order."""
        if not self.collect_filtered:
            raise ValueError("built with collect_filtered=False")
        self._check_overflow()
        if bool(self._state.emit_overflow):
            raise RuntimeError(
                f"emit ring overflowed: the stream kept {self.n_kept} rows but emit_capacity "
                f"is {self._ecap}; the exported table would be silently truncated - rebuild "
                "the session with a larger emit_capacity (counts/grids remain exact)")
        n = int(self._state.emit_count)
        return self._state.emit_buf[:n].cpu().numpy().astype(np.int64)

    def _paths_state(self) -> PathsState:
        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        return self._state.paths

    def _raise_if_paths_overflow(self, p: PathsState) -> None:
        if bool(p.overflow):
            raise RuntimeError(
                f"online estimation overflow: more than {self._paths_spec.s_step} sweeps "
                f"closed in one window or more than {self._paths_spec.capacity} sweeps "
                "total; rebuild the session with larger s_step/capacity (grids/counts "
                "remain exact)")

    def _paths_read(self):
        p = self._paths_state()
        self._check_overflow()
        self._raise_if_paths_overflow(p)
        return int(p.n_closed), p

    def sweep_paths(self):
        """Online per-sweep estimates: (OmpPaths or SmSicPaths of [n_closed,
        K] numpy arrays, sweep_valid [n_closed]).  Equal to
        ``Session.sweep_paths(..., beam_ids=(spec.ue_ids, spec.bs_ids))`` on
        the same stream."""
        n, p = self._paths_read()
        paths = type(p.est_rings)(*(x[:n].cpu().numpy() for x in p.est_rings))
        return paths, p.valid_ring[:n].cpu().numpy()

    def sweep_times(self) -> np.ndarray:
        """CLK anchors of the closed sweeps, unwrapped as
        ``Session.sweep_times`` unwraps them."""
        n, p = self._paths_read()
        return unwrap_clk_anchors(p.time_ring[:n].cpu().numpy().astype(np.int64), _LOGGER)

    def path_tracks(self):
        """(tracks, times, (vel_aoa, vel_aod, ok)): the offline
        ``Session.path_tracks`` contract, from the in-stream tracker."""
        n, p = self._paths_read()
        tracks = Tracks(*(r[:n].T.cpu().numpy().copy()
                          for r in (p.trk_aoa, p.trk_aod, p.trk_pow, p.trk_obs)),
                        p.trk_created.cpu().numpy(), int(p.trk_count))
        times = self.sweep_times()
        return tracks, times, track_velocities(tracks, times)

    def track_columns(self, lo: int, hi: int):
        """Track-ring columns of closed sweeps ``[lo, hi)``: (aoa [m, T],
        aod, power, observed, raw CLK anchors [m]); reads only those rows."""
        p = self._paths_state()
        self._raise_if_paths_overflow(p)
        return (p.trk_aoa[lo:hi].cpu().numpy(), p.trk_aod[lo:hi].cpu().numpy(),
                p.trk_pow[lo:hi].cpu().numpy(), p.trk_obs[lo:hi].cpu().numpy(),
                p.time_ring[lo:hi].cpu().numpy().astype(np.int64))

    @property
    def n_sweeps_closed(self) -> int:
        return int(self._paths_state().n_closed)

    def intensity(self):
        """IntensityGrid of numpy arrays from the running sums and counts."""
        self._check_overflow()
        return grid_from_sums_np(self._state.sums.cpu().numpy().astype(np.float64),
                                 self._state.counts.cpu().numpy().astype(np.int64))

    def render(self, angle_lut: np.ndarray, render_cfg: Optional[RenderConfig] = None
               ) -> RenderedHeatmap:
        """The heatmap raster of ``intensity()``'s grid, rasterized on the
        session's device (kernel K3 on CUDA)."""
        return render_grid(self.intensity(), angle_lut, self.device, render_cfg)

    def block_until_ready(self) -> "DeviceStreamingSession":
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    # -- checkpoint / resume -------------------------------------------------

    def save_checkpoint(self, path, extra: Optional[dict] = None) -> None:
        """Write the whole stream state to ``path`` (one npz file): every
        state tensor, the host byte carry and the session's configuration.
        ``restore(path)`` continues the stream exactly.  ``extra`` comes back
        as ``restored.checkpoint_extra``.  The layout is the JAX package's
        (``meta``, ``n_leaves``, ``leaf_0000``...), but the meta holds this
        package's config classes, so the two packages do not read each
        other's checkpoints."""
        meta = {
            "extra": extra, "version": CKPT_VERSION, "kind": "device_stream",
            "config": self.config, "chunk_bytes": self.chunk_bytes,
            "group_capacity": self._gcap, "max_groups": self._mg,
            "max_baselines_per_group": self._mbpg,
            "collect_filtered": self.collect_filtered, "n_beams": self._n_beams,
            "emit_auto": self._emit_auto, "ecap": self._ecap,
            "emit_bound": self._emit_bound, "finalized": self._finalized,
            "paths_spec": self._paths_spec,
            "dict_args": tuple(a.cpu().numpy() for a in self._dict_args),
            "byte_carry": np.asarray(self._byte_carry, np.uint8),
        }
        _ckpt_write(path, [x.cpu().numpy() for x in _leaves(self._state)], meta)

    @classmethod
    def restore(cls, path, device=None) -> "DeviceStreamingSession":
        """Rebuild a session from ``save_checkpoint`` output on ``device``
        (None: CUDA).  Every leaf's shape and dtype is checked against the
        zero state of the saved configuration.  Unpickles the meta: open
        only checkpoints you wrote."""
        meta, leaves = _ckpt_read(path)
        if meta.get("kind") != "device_stream":
            raise ValueError(f"not a DeviceStreamingSession checkpoint: kind="
                             f"{meta.get('kind')!r}")
        spec = meta["paths_spec"]
        sess = cls(config=meta["config"], chunk_bytes=meta["chunk_bytes"],
                   group_capacity=meta["group_capacity"], max_groups=meta["max_groups"],
                   max_baselines_per_group=meta["max_baselines_per_group"],
                   collect_filtered=meta["collect_filtered"], n_beams=meta["n_beams"],
                   emit_capacity=meta["ecap"] if meta["collect_filtered"] else None,
                   collect_paths=(spec, meta["dict_args"]) if spec is not None else None,
                   device=device)
        sess._emit_auto = bool(meta["emit_auto"])
        sess._emit_bound = int(meta["emit_bound"])
        sess._finalized = bool(meta["finalized"])
        sess._byte_carry = np.asarray(meta["byte_carry"], np.uint8)
        _ckpt_fill_state(sess._state, leaves)
        sess.checkpoint_extra = meta.get("extra")
        return sess


def render_grid(grid, angle_lut: np.ndarray, device, render_cfg: Optional[RenderConfig] = None
                ) -> RenderedHeatmap:
    """A stream's heatmap: its host-built grid on ``device``, rendered with
    NaN kept in empty cells (the JAX streams' ``render``)."""
    return render_intensity(grid_to_device(grid, device), angle_lut,
                            SceneConfig(keep_nan=True, fill_with_min=False),
                            render_cfg or RenderConfig())


# -- checkpoint / resume -------------------------------------------------------
#
# One npz file: every state tensor as ``leaf_NNNN`` (read back to the host
# once) and a pickled meta blob with the constructor configuration and the
# host-side carry.  Written to ``<path>.tmp`` and renamed, so a crash while
# saving leaves the previous checkpoint whole.

CKPT_VERSION = 1
_NP_DTYPE = {torch.bool: np.dtype(bool), torch.int32: np.dtype(np.int32),
             torch.int64: np.dtype(np.int64), torch.float32: np.dtype(np.float32),
             torch.float64: np.dtype(np.float64)}


def _ckpt_write(path, leaves, meta: dict) -> None:
    blob = np.frombuffer(pickle.dumps(meta, protocol=4), dtype=np.uint8)
    arrays = {f"leaf_{i:04d}": np.asarray(x) for i, x in enumerate(leaves)}
    # Through a file handle: np.savez(path) would append ".npz" to a bare path.
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, meta=blob, n_leaves=np.int64(len(leaves)), **arrays)
    os.replace(tmp, path)


def _ckpt_read(path):
    with np.load(path, allow_pickle=False) as z:
        meta = pickle.loads(z["meta"].tobytes())
        n = int(z["n_leaves"]) if "n_leaves" in z else 0
        leaves = [z[f"leaf_{i:04d}"] for i in range(n)]
    if meta.get("version") != CKPT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta.get('version')!r} (this "
                         f"build reads version {CKPT_VERSION})")
    return meta, leaves


def _ckpt_check(zero_leaves, leaves, shape_of) -> None:
    """Check the checkpointed leaves against a zero state's: their count,
    and each one's dtype and shape (``shape_of(zero_leaf)``)."""
    if len(zero_leaves) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} state leaves, the restored "
                         f"configuration builds {len(zero_leaves)}")
    for i, (z, arr) in enumerate(zip(zero_leaves, leaves)):
        want = shape_of(z)
        if want != tuple(arr.shape) or _NP_DTYPE[z.dtype] != arr.dtype:
            raise ValueError(f"checkpoint leaf {i} is {arr.dtype}{list(arr.shape)} but the "
                             f"restored configuration expects {z.dtype}{list(want)}")


def _ckpt_fill_state(zero_state: DeviceStreamState, leaves) -> None:
    """Copy the checkpointed leaves into ``zero_state``'s tensors after
    checking each one's shape and dtype."""
    zero_leaves = _leaves(zero_state)
    _ckpt_check(zero_leaves, leaves, lambda z: tuple(z.shape))
    for z, arr in zip(zero_leaves, leaves):
        z.copy_(torch.from_numpy(np.array(arr)))


def _has_window(bufs, offs) -> bool:
    """Whether any stream's buffer holds a window past its offset."""
    return any(len(b) - o > CARRY_BYTES for b, o in zip(bufs, offs))


def _next_windows(bufs, offs, n_rows: int, c: int):
    """The next lockstep round: (pieces [n_rows, c] u8, lens [n_rows]) with
    each stream's next 10-byte-overlap window (an empty piece where it has
    none left), advancing ``offs`` in place."""
    pieces = np.zeros((n_rows, c), np.uint8)
    lens = np.zeros(n_rows, np.int64)
    _fill_windows(bufs, offs, c, [(pieces[i], lens[i:i + 1]) for i in range(len(bufs))])
    return pieces, lens


def _fill_windows(bufs, offs, c: int, rows) -> None:
    """Write the next lockstep round into ``rows``, one (piece [c] u8, length
    [1] int64) pair of arrays per stream of ``bufs``, which hold the round
    before, zero past its length: each stream's next 10-byte-overlap
    window, zero-padded, or length 0 where it has none left (so only the
    previous round's bytes past the new length are cleared); advances
    ``offs`` in place."""
    with annotate("slam.stream.stage"):
        for i, (b, (row, n)) in enumerate(zip(bufs, rows)):
            off, prev = offs[i], int(n[0])
            m = min(c, len(b) - off) if len(b) - off > CARRY_BYTES else 0
            row[:m] = b[off:off + m]
            row[m:prev] = 0
            n[0] = m
            if m:
                offs[i] = min(off + c, len(b)) - CARRY_BYTES


class MultiStreamingSession(_WindowRound):
    """S live streams on one device or over a mesh, advanced together one
    window round at a time.

    The port of the JAX package's ``MultiStreamingSession``: the state is
    ``DeviceStreamState`` with a leading S axis, and a round runs each
    stage once for all S streams: K1 over the [S, chunk_bytes] windows with
    per-stream lengths, the corrector with one K2 launch (group ids offset
    per stream), the S intensity grids in one ``index_add_``, K5 with the
    stream axis for the carries and again for the kept rows (the per-stream
    emit rings and, with ``collect_paths``, the paths' buffers), then K4
    over the S s1 sweep lanes, the estimator on every stream's closing
    sweeps and K6 with the stream axis.  Per-stream results equal S
    independent ``DeviceStreamingSession`` replays of the same bytes
    exactly.  With ``collect_paths`` a round reads the S closed-sweep counts
    once (``HOST_SYNCS``) and runs the estimator as the JAX package's
    vmapped step does (``_paths_after_read``): on the lanes of ``nblk =
    ceil(min(max_s m_eff, s1) / blk)`` blocks of ``blk = min(8, s1)``
    lanes of every stream, block i from lane ``min(blk i, s1 - blk)``, each
    lane's results written to ring row ``n_closed + lane`` on the device
    (the NNLS loops on the device, kernel K7, on CUDA); without it a round
    never waits.

    Each shard's window, its bytes and K1's limits, is one static device
    buffer, filled from one pinned staging buffer a round
    (``STAGING_WAITS`` counts the rounds whose host waited for the previous
    copy out of it).  On CUDA a shard's round is CUDA graphs (the
    counterpart of the JAX package's jitted vmapped step with a donated
    state): one of the round up to the count read (``_round_pre``), whose
    static outputs hold what the rest reads, and one of the rest
    (``_round_post``) per block count, captured at its first use; without
    ``collect_paths`` the round is one graph.  A shard's graphs share one
    memory pool.  The state is written in place by every path (the rounds,
    the flushes, ``reset_streams``), so the graphs live as long as the
    session.  Flushes run eagerly, through the same two halves.

    With ``mesh`` (``parallel/mesh.py``) the S streams pad with inert
    streams (never fed, never flushed, never read) to a multiple of the
    ``data`` axis, and each data shard's state lives on its row's first
    device: a round issues every shard's stages, K1 to K4, before it reads
    any shard's counts (once per shard), then each shard's estimator and
    K6.  The estimator runs with the whole dictionary on the row's first
    device (the JAX package's stream step does not shard it over
    ``model``).  Results equal ``mesh=None`` exactly.

    ``feed`` takes one chunk per stream (b"" for a stream with nothing new);
    every stream's buffer drains in lockstep rounds of 10-byte-overlap
    windows, and a stream with no window left in a round gets an empty
    piece, a no-op for its state.  The emit ring is fixed at
    ``emit_capacity`` rows per stream (0: none), with an overflow flag per
    stream and no growth.  ``device`` (without a mesh): None means CUDA.
    """

    def __init__(self, n_streams: int, config: Optional[PipelineConfig] = None,
                 chunk_bytes: int = 1 << 20, group_capacity: int = 8192, max_groups: int = 128,
                 max_baselines_per_group: int = 192, n_beams: int = 64, mesh=None,
                 collect_paths=None, emit_capacity: int = 0, *, device=None):
        self.n_streams = int(n_streams)
        if self.n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        rows = placement(mesh, device)
        self.mesh = mesh
        self._setup(config, chunk_bytes, group_capacity, max_groups, max_baselines_per_group,
                    n_beams, collect_paths, rows[0][0])
        self._collect_paths = collect_paths
        self._ecap = int(emit_capacity)
        self._n_pad, self._per = shard_rows(self.n_streams, len(rows))
        if mesh is None:
            self._state = self._zero_state(self.n_streams, self.device)
            self._shards = [self]
        else:
            self._shards = [self._new_shard(devs[0]) for devs in rows]
        for sh in self._shards:
            sh._init_rounds(self._per)
        self._byte_carry = [np.zeros(0, np.uint8) for _ in range(self.n_streams)]
        self._finalized = False
        self._stream_finalized = np.zeros(self.n_streams, bool)
        self._paths_host = None   # host memo of the online-paths state
        self._emit_host = None    # host memo of the emit rings
        self.checkpoint_extra = None

    def _zero_state(self, n: int, device) -> DeviceStreamState:
        return _zero_stream_state((n,), self._gcap, self._n_beams, self._ecap,
                                  self.config.scene.log_transform, self._paths_spec, device)

    def _new_shard(self, device) -> _WindowRound:
        """One data shard: the session's bounds and dictionary on ``device``
        with the zero state of ``_per`` streams."""
        sh = _WindowRound()
        sh._setup(self.config, self.chunk_bytes, self._gcap, self._mg, self._mbpg,
                  self._n_beams, self._collect_paths, device)
        sh._ecap = self._ecap
        sh._state = self._zero_state(self._per, sh.device)
        return sh

    def _parts(self) -> list:
        """(shard, its first stream, its count of real streams) per shard."""
        return [(sh, k * self._per, max(0, min(self._per, self.n_streams - k * self._per)))
                for k, sh in enumerate(self._shards)]

    def _locate(self, i: int):
        """(shard state, row) of stream ``i``."""
        return self._shards[i // self._per]._state, i % self._per

    def _host_rows(self, get) -> list:
        """``get(state)``'s tensors of every shard, read back and joined
        along the stream axis, the padding streams dropped."""
        with annotate("slam.stream.read"):
            per_shard = [[x.cpu().numpy() for x in get(sh._state)] for sh in self._shards]
            return [np.concatenate(xs)[:self.n_streams] for xs in zip(*per_shard)]

    def _forget_host(self) -> None:
        self._paths_host = None
        self._emit_host = None

    # -- ingest --------------------------------------------------------------

    def feed(self, chunks) -> None:
        """Advance every stream by one chunk (``chunks``: S byte buffers;
        b"" for streams with no new data this round)."""
        if self._finalized:
            raise RuntimeError(
                "session already finalized: the flush closed every stream's open sweep "
                "group; start (or restore) a non-finalized session")
        if len(chunks) != self.n_streams:
            raise ValueError(f"expected {self.n_streams} chunks")
        self._forget_host()
        bufs, offs = [], [0] * self.n_streams
        with annotate("slam.stream.stage"):
            for i, chunk in enumerate(chunks):
                if isinstance(chunk, (bytes, bytearray)):
                    chunk = np.frombuffer(chunk, dtype=np.uint8)
                chunk = np.asarray(chunk, np.uint8)
                if len(chunk) and self._stream_finalized[i]:
                    raise RuntimeError(
                        f"stream {i} already finalized: its flush closed the open sweep "
                        "group, so feeding more bytes would mis-segment sweeps (pass b'' for "
                        "ended streams)")
                bufs.append(np.concatenate([self._byte_carry[i], chunk]))
        while _has_window(bufs, offs):
            # Each round's windows go straight into the shards' staging buffers.
            rows = []
            for sh, _, m in self._parts():
                lens, pieces = sh._staged()
                rows += [(pieces[j], lens[j:j + 1]) for j in range(m)]
            _fill_windows(bufs, offs, self.chunk_bytes, rows)
            self._window()
        self._byte_carry = [b[o:].copy() for b, o in zip(bufs, offs)]

    def _window(self, pieces: Optional[np.ndarray] = None,
                lens: Optional[np.ndarray] = None) -> None:
        """One window round of every shard: pieces [S_pad, chunk_bytes],
        lens [S_pad] int64, or None where ``feed`` has staged the round
        (class docstring)."""
        self._forget_host()
        parts = self._parts()
        with annotate("slam.stream.round"):
            for sh, lo, _ in parts:
                if pieces is not None:
                    staged_lens, staged_pieces = sh._staged()
                    staged_lens[:] = lens[lo:lo + self._per]
                    staged_pieces[:] = pieces[lo:lo + self._per]
                sh._send()
            _drain([(sh, sh._pre, sh._post) for sh, _, _ in parts])

    def _masked_flush(self, mask: np.ndarray) -> None:
        """Flush the streams of ``mask`` and leave the others as they are,
        eagerly: a shard flushes whole when every one of its streams is
        selected, else the selected streams' state is gathered, flushed and
        written back.  Every state tensor is written in place, so the
        shards' graphs stay valid."""
        with annotate("slam.stream.flush"):
            jobs, writes = [], []
            for sh, lo, _ in self._parts():
                idx = np.nonzero(mask[lo:lo + self._per])[0]
                if not len(idx):
                    continue
                if len(idx) == self._per:
                    st = sh._state
                else:
                    idx_t = _host_to(sh.device, idx.astype(np.int64))
                    st = _map_state(sh._state, lambda x, i=idx_t: x.index_select(0, i))
                    writes.append((sh._state, idx_t, st))
                jobs.append((sh, functools.partial(sh._flush_pre, st),
                             functools.partial(sh._round_post, st, close_all=True)))
            _drain(jobs)
            for whole_st, idx_t, sub in writes:
                for whole, part in zip(_leaves(whole_st), _leaves(sub)):
                    whole.index_copy_(0, idx_t, part)
            for i in np.nonzero(mask)[0]:
                self._byte_carry[i] = np.zeros(0, np.uint8)
            self._forget_host()

    def _checked(self, indices) -> np.ndarray:
        idx = np.atleast_1d(np.asarray(indices, dtype=np.int64))
        if np.any((idx < 0) | (idx >= self.n_streams)):
            raise ValueError(f"stream indices {idx} out of range")
        return idx

    def finalize_streams(self, indices) -> None:
        """Flush the open sweep group of the given streams only: a capture
        that stops closes its last sweep (and runs its last online-estimation
        step) while the others go on.  Finalized streams take b"" in
        ``feed``; real bytes raise."""
        idx = self._checked(indices)
        if idx.size == 0:
            return
        already = idx[self._stream_finalized[idx]]
        if already.size:
            raise RuntimeError(f"streams {already.tolist()} already finalized")
        mask = np.zeros(self.n_streams, bool)
        mask[idx] = True
        self._masked_flush(mask)
        self._stream_finalized |= mask
        if bool(self._stream_finalized.all()):
            self._finalized = True

    def finalize(self) -> None:
        """Flush every stream still open (end of all streams)."""
        if self._finalized:
            return
        remaining = ~self._stream_finalized
        if remaining.any():
            self._masked_flush(remaining)
        self._stream_finalized[:] = True
        self._finalized = True

    def reset_streams(self, indices) -> None:
        """Return finalized streams to the zero state so new live feeds can
        attach.  Only finalized streams may reset (read their results
        first: their rings are zeroed)."""
        with annotate("slam.stream.reset"):
            idx = self._checked(indices)
            if idx.size == 0:
                return
            live = idx[~self._stream_finalized[idx]]
            if live.size:
                raise RuntimeError(
                    f"streams {live.tolist()} are still live; finalize_streams them (and read "
                    "their results) before resetting")
            for sh, lo, _ in self._parts():
                local = idx[(idx >= lo) & (idx < lo + self._per)] - lo
                if not len(local):
                    continue
                idx_t = _host_to(sh.device, local.astype(np.int64))
                for whole, zero in zip(_leaves(sh._state),
                                       _leaves(self._zero_state(len(local), sh.device))):
                    whole.index_copy_(0, idx_t, zero)
            for i in idx:
                self._byte_carry[i] = np.zeros(0, np.uint8)
            self._stream_finalized[idx] = False
            self._finalized = False
            self._forget_host()

    # -- results -------------------------------------------------------------

    def _warn_overflow(self, overflow: np.ndarray, what: str) -> None:
        if overflow.any():
            bad = np.nonzero(overflow)[0].tolist()
            msg = f"MultiStreamingSession capacity exceeded on streams {bad}{what}"
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
            _LOGGER.warning(msg)

    def _paths_read_all(self):
        """One copy per shard of the whole [S, ...] online-paths state, kept
        on the host until the next feed, finalize or reset."""
        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        if self._paths_host is not None:
            return self._paths_host

        def leaves(st):
            p = st.paths
            return (p.n_closed, p.overflow, *p.est_rings, p.valid_ring, p.time_ring, p.trk_aoa,
                    p.trk_aod, p.trk_pow, p.trk_obs, p.trk_created, p.trk_count, st.overflow)

        host = self._host_rows(leaves)
        n_est = len(self._shards[0]._state.paths.est_rings)
        if host[1].any():
            bad = np.nonzero(host[1])[0].tolist()
            raise RuntimeError(
                f"online estimation overflow on streams {bad}: more than "
                f"{self._paths_spec.s_step} sweeps closed in one step or more than "
                f"{self._paths_spec.capacity} sweeps total; rebuild with larger "
                "s_step/capacity")
        self._warn_overflow(host[-1], "; online paths/tracks for those streams are computed "
                                      "from incomplete corrections")
        est = type(self._shards[0]._state.paths.est_rings)(*host[2:2 + n_est])
        self._paths_host = (host[0], est, *host[2 + n_est:-1])
        return self._paths_host

    def stream_filtered(self, i: int) -> np.ndarray:
        """Stream ``i``'s corrected rows [N, 4] int64 in stream order (the
        single stream's ``filtered``; needs ``emit_capacity``)."""
        if not self._ecap:
            raise ValueError("built with emit_capacity=0")
        if self._emit_host is None:
            self._emit_host = self._host_rows(
                lambda st: (st.emit_buf, st.emit_count, st.emit_overflow))
        buf, count, ovf = self._emit_host
        if bool(ovf[i]):
            raise RuntimeError(
                f"emit ring overflowed on stream {i} (emit_capacity={self._ecap}); the "
                "exported table would be silently truncated - rebuild with a larger "
                "emit_capacity (counts/grids remain exact)")
        return buf[i][:int(count[i])].astype(np.int64)

    def stream_paths(self, i: int):
        """Stream ``i``'s online per-sweep estimates: (paths [n, K], sweep_valid
        [n]), the single stream's ``sweep_paths``."""
        n_closed, est, valid = self._paths_read_all()[:3]
        n = int(n_closed[i])
        return type(est)(*(x[i][:n] for x in est)), valid[i][:n]

    def n_sweeps_closed_all(self) -> np.ndarray:
        """Closed-sweep counts per stream ([S] int64): one small read per
        shard."""
        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        return self._host_rows(lambda st: (st.paths.n_closed,))[0].astype(np.int64)

    def stream_track_columns(self, i: int, lo: int, hi: int):
        """Stream ``i``'s track-ring columns of closed sweeps ``[lo, hi)``:
        (aoa [m, T], aod, power, observed, raw CLK anchors [m]); reads only
        those rows of that stream."""
        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        st, r = self._locate(i)
        p = st.paths
        if bool(p.overflow[r]):
            raise RuntimeError(
                f"online estimation overflow on stream {i}: more than "
                f"{self._paths_spec.s_step} sweeps closed in one step or more than "
                f"{self._paths_spec.capacity} sweeps total; rebuild with larger "
                "s_step/capacity")
        return (p.trk_aoa[r, lo:hi].cpu().numpy(), p.trk_aod[r, lo:hi].cpu().numpy(),
                p.trk_pow[r, lo:hi].cpu().numpy(), p.trk_obs[r, lo:hi].cpu().numpy(),
                p.time_ring[r, lo:hi].cpu().numpy().astype(np.int64))

    def stream_tracks(self, i: int):
        """Stream ``i``'s online tracks: (tracks, times, velocities), the
        single stream's ``path_tracks``."""
        n_closed, _, _, time_ring, taoa, taod, tpow, tobs, created, count = \
            self._paths_read_all()
        n = int(n_closed[i])
        tracks = Tracks(taoa[i][:n].T.copy(), taod[i][:n].T.copy(), tpow[i][:n].T.copy(),
                        tobs[i][:n].T.copy(), created[i], int(count[i]))
        t = unwrap_clk_anchors(time_ring[i][:n].astype(np.int64), _LOGGER)
        return tracks, t, track_velocities(tracks, t)

    def results(self):
        """One copy per shard: per-stream (n_frames, n_kept, n_groups, sums,
        counts, overflow) numpy arrays with a leading S axis (sums int64,
        float64 for the pre-log scene).  Warns when a stream exceeded a
        bound."""
        out = tuple(self._host_rows(lambda s: (s.n_frames, s.n_kept, s.n_groups, s.sums,
                                               s.counts, s.overflow)))
        self._warn_overflow(out[5], " (group_capacity/max_groups/max_baselines_per_group): "
                                    "those streams' results are incomplete; rebuild with "
                                    "larger bounds")
        return out

    def block_until_ready(self) -> "MultiStreamingSession":
        for dev in {sh.device for sh in self._shards}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return self

    # -- checkpoint / resume -------------------------------------------------

    def save_checkpoint(self, path, extra: Optional[dict] = None) -> None:
        """Write all S streams' state to ``path`` (one npz file, the single
        stream's layout, ``kind="multi_stream"``); ``restore`` continues
        every stream exactly.  The mesh is not saved (the restoring process
        names its own): the leaves hold the S real streams, as without one."""
        meta = {
            "extra": extra, "version": CKPT_VERSION, "kind": "multi_stream",
            "config": self.config, "n_streams": self.n_streams,
            "chunk_bytes": self.chunk_bytes, "group_capacity": self._gcap,
            "max_groups": self._mg, "max_baselines_per_group": self._mbpg,
            "n_beams": self._n_beams, "ecap": self._ecap, "finalized": self._finalized,
            "stream_finalized": np.asarray(self._stream_finalized, bool),
            "paths_spec": self._paths_spec,
            "dict_args": tuple(a.cpu().numpy() for a in self._dict_args),
            "byte_carry": [np.asarray(b, np.uint8) for b in self._byte_carry],
        }
        _ckpt_write(path, self._host_rows(_leaves), meta)

    @classmethod
    def restore(cls, path, mesh=None, device=None) -> "MultiStreamingSession":
        """Rebuild from ``save_checkpoint`` on ``device`` (None: CUDA) or
        over ``mesh``; per-stream results after the rest of the feed equal an
        uninterrupted run exactly.  Unpickles the meta: open only
        checkpoints you wrote."""
        meta, leaves = _ckpt_read(path)
        if meta.get("kind") != "multi_stream":
            raise ValueError(f"not a MultiStreamingSession checkpoint: kind="
                             f"{meta.get('kind')!r}")
        spec = meta["paths_spec"]
        sess = cls(meta["n_streams"], config=meta["config"], chunk_bytes=meta["chunk_bytes"],
                   group_capacity=meta["group_capacity"], max_groups=meta["max_groups"],
                   max_baselines_per_group=meta["max_baselines_per_group"],
                   n_beams=meta["n_beams"], mesh=mesh,
                   collect_paths=(spec, meta["dict_args"]) if spec is not None else None,
                   emit_capacity=meta["ecap"], device=device)
        sess._finalized = bool(meta["finalized"])
        sess._stream_finalized = np.asarray(meta["stream_finalized"], bool).copy()
        sess._byte_carry = [np.asarray(b, np.uint8) for b in meta["byte_carry"]]
        zero_leaves = _leaves(sess._shards[0]._state)
        _ckpt_check(zero_leaves, leaves, lambda z: (sess.n_streams,) + tuple(z.shape[1:]))
        for sh, lo, m in sess._parts():
            for z, arr in zip(_leaves(sh._state), leaves):
                z[:m].copy_(torch.from_numpy(np.array(arr[lo:lo + m])))
        sess.checkpoint_extra = meta.get("extra")
        return sess


def replay_log_device(raw: np.ndarray, chunk_bytes: int = 1 << 20,
                      config: Optional[PipelineConfig] = None,
                      **kwargs) -> DeviceStreamingSession:
    """Replay one tokenized log through the device streaming session.

    A replay knows its length, so with ``collect_filtered`` the emit ring
    is sized to the log up front (one frame per 11 bytes bounds the kept
    rows, in buckets of 64 Ki rows): no growth, no overflow.
    """
    if kwargs.get("collect_filtered") and "emit_capacity" not in kwargs:
        need = len(raw) // 11 + 1
        kwargs["emit_capacity"] = -(-need // (1 << 16)) * (1 << 16)
    s = DeviceStreamingSession(config, chunk_bytes=chunk_bytes, **kwargs)
    for off in range(0, len(raw), chunk_bytes):
        s.feed(raw[off:off + chunk_bytes])
    s.finalize()
    return s
