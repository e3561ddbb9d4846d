"""Device streaming session: an unbounded byte stream, window by window,
with all state on one device.

The port of ``slam_process_tpu/parallel/streaming_device.py``'s single
stream (``DeviceStreamingSession``, ``replay_log_device``, the checkpoint
helpers).  Each ``chunk_bytes`` window runs, on the session's device:
decode (kernel K1), the corrector on the closed groups' rows (K2), the
intensity sums, the open group's carry compaction (K5), one compaction of
the kept rows (K5) into the emit ring and, with ``collect_paths``, into a
fresh buffer for the online paths, then the per-sweep sums of those rows
(K4), the per-sweep estimator (NN-OMP or SM-SIC) on the sweeps the window
closed and the tracker block (K6).  On CPU tensors every kernel's plain
version runs instead.

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
place.  A window waits on the device
only with ``collect_paths``: once to read the count of sweeps it closed,
which sizes the estimator's batch (``HOST_SYNCS``), and, when it closed
any, at each step of the NNLS solver's lockstep loops
(``ops/nnls.HOST_SYNCS``).  Without ``collect_paths`` a window never waits.
``render()`` reads the sums back, builds the grid on the host as
``intensity()`` does and rasterizes it on the session's device (K3).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import warnings
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from slam_process_tpu_torch.config import PipelineConfig, RenderConfig, SceneConfig
from slam_process_tpu_torch.io.angles import load_angle_lut
from slam_process_tpu_torch.models.sweep_estimation import (
    estimator_dictionary, path_power, sweep_estimator_body, sweep_estimator_setup, zero_paths)
from slam_process_tpu_torch.models.tracking import Tracks, track_velocities
from slam_process_tpu_torch.ops.compact import compact_rows, compact_rows_multi
from slam_process_tpu_torch.ops.correct import correct_rows
from slam_process_tpu_torch.ops.decode import decode_rows
from slam_process_tpu_torch.ops.scene import (
    grid_from_sums_np, grid_to_device, intensity_cell_sums, intensity_per_sweep_sums)
from slam_process_tpu_torch.ops.tracker import track_block
from slam_process_tpu_torch.pipeline.device import resolve_device
from slam_process_tpu_torch.render.heatmap import RenderedHeatmap, render_intensity
from slam_process_tpu_torch.utils.timestamps import unwrap_clk_anchors

_LOGGER = logging.getLogger("slam_process_tpu_torch.streaming_device")

CARRY_BYTES = 10   # frame_len - 1: the only positions without a verdict
HOST_SYNCS = 0     # host reads of a window's closed-sweep count since the caller set it to 0


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
    """[F] bool: a valid row whose UE is below the previous valid row's.
    The first valid row continues the carried open group."""
    pos = torch.arange(ue.shape[0], device=ue.device)
    last = torch.cummax(torch.where(valid, pos, -1), dim=0).values
    prev = torch.cat([last.new_full((1,), -1), last[:-1]])
    return valid & (prev >= 0) & (ue[prev.clamp(min=0)] > ue)


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a device scalar ``i`` >= 0, without a host read."""
    return x.index_select(0, i.reshape(1).clamp(min=0).long())[0]


def _kept_rows(frames: torch.Tensor, corrected: torch.Tensor) -> torch.Tensor:
    """[F, 4] i32 (ue, corrected_bs, rss, clk): the emitted row layout."""
    return torch.stack([frames[:, 1], corrected, frames[:, 3], frames[:, 4]], dim=1)


def _paths_substep(p: PathsState, kr: torch.Tensor, n_keep: torch.Tensor,
                   spec: StreamPathsSpec, dict_args, beam_ids, close_all: bool) -> None:
    """Advance the online-estimation state by one window's kept rows.

    ``kr`` holds the window's kept rows compacted in stream order (K5), the
    first ``n_keep`` of them; they are exactly the offline filtered table's
    rows, so segmenting them by UE decrease, seeded with ``last_kept_ue``,
    reproduces ``detect_groups_np(filtered[:, 0])``.  The sweeps the window
    closes (and at the flush, ``close_all``, the open one if it has cells)
    go through the per-sweep estimator and the tracker block (K6); the open
    sweep's sums carry to the next window.
    """
    global HOST_SYNCS
    dev = kr.device
    t = kr.shape[0]
    s1 = spec.s_step + 1
    ue, bs, rss, clk = kr.unbind(dim=1)
    idx = torch.arange(t, dtype=torch.int32, device=dev)
    inside = idx < n_keep
    # UE ids are 6-bit, so a -1 seed (no kept row yet) never starts a sweep.
    prev_ue = torch.cat([p.last_kept_ue.view(1), ue[:-1]])
    bnd = inside & (prev_ue > ue)
    ls = torch.cumsum(bnd, dim=0, dtype=torch.int32)        # local sweep id per row
    m = bnd.sum(dtype=torch.int32)                          # sweeps closed by a boundary
    last_ue = torch.where(n_keep > 0, _at(ue, n_keep - 1), p.last_kept_ue)

    use = inside & (ls < s1)
    sums, counts = intensity_per_sweep_sums(ue, bs, rss, ls, use, s1)   # K4 on CUDA
    sums[0] += p.open_sums
    counts[0] += p.open_counts
    # CLK of each local sweep's first kept row; sweep 0 inherits the open
    # sweep's anchor.  Bin s1 collects the rows that start no sweep.
    first = use & (bnd | (idx == 0))
    times = torch.full((s1 + 1,), -1, dtype=torch.int32, device=dev)
    times.index_put_((torch.where(first, ls, s1).long(),), clk)
    times = times[:s1]
    times[0] = torch.where(p.open_time >= 0, p.open_time, times[0])

    m_eff_t = m
    if close_all:
        has_open = _at(counts, m.clamp(max=s1 - 1)).sum() > 0
        m_eff_t = m + has_open.to(torch.int32)
    HOST_SYNCS += 1
    m_eff = int(m_eff_t)          # sizes the estimator's batch
    live = min(m_eff, s1)

    k_n = p.est_rings.aoa.shape[1]
    lanes = [torch.zeros((s1, k_n), dtype=torch.float32, device=dev) for _ in range(3)]
    val_l = torch.zeros((s1, k_n), dtype=torch.bool, device=dev)
    ring_idx = (p.n_closed + torch.arange(live, dtype=torch.int32, device=dev)).long()
    if live:
        mean = torch.where(counts[:live] > 0, sums[:live] / counts[:live].clamp(min=1.0),
                           float("nan"))
        sub = mean[:, beam_ids[0]][:, :, beam_ids[1]]
        est, sv = sweep_estimator_body(spec.est_key)(sub, *dict_args)
        for ring, block in zip(p.est_rings, est):
            ring.index_copy_(0, ring_idx, block)
        p.valid_ring.index_copy_(0, ring_idx, sv)
        p.time_ring.index_copy_(0, ring_idx, times[:live])
        for lane, x in zip(lanes, (est.aoa, est.aod, path_power(est))):
            lane[:live] = x
        val_l[:live] = est.valid & sv[:, None]

    c_aoa, c_aod, c_pow, c_obs, pos, created, count = track_block(
        *lanes, val_l, m_eff_t, p.trk_pos, p.trk_created, p.trk_count, spec.gate_deg)
    for ring, col in ((p.trk_aoa, c_aoa), (p.trk_aod, c_aod), (p.trk_pow, c_pow),
                      (p.trk_obs, c_obs)):
        ring.index_copy_(0, ring_idx, col[:live])
    p.trk_pos, p.trk_created, p.trk_count = pos, created, count

    p.overflow |= (m_eff_t > spec.s_step) | (p.n_closed + m_eff_t > spec.capacity)
    p.n_closed = (p.n_closed + m_eff_t).clamp(max=spec.capacity)
    p.last_kept_ue = last_ue
    if close_all:
        p.open_sums.zero_()
        p.open_counts.zero_()
        p.open_time.fill_(-1)
    else:
        mc = min(m_eff, s1 - 1)
        p.open_sums.copy_(sums[mc])
        p.open_counts.copy_(counts[mc])
        p.open_time = torch.where(counts[mc].sum() > 0, times[mc], -1)


class _Window(NamedTuple):
    """One window's rows after decode and correction."""

    combined: torch.Tensor    # [Gcap + R, 5] i32: the carried group, then the window's rows
    open_mask: torch.Tensor   # [Gcap + R] bool: valid rows of the still-open group
    boundary: torch.Tensor    # [Gcap + R] bool: rows that start a group
    corrected: torch.Tensor   # [Gcap + R] i32 corrected BS
    keep: torch.Tensor        # [Gcap + R] bool: kept (filtered) rows
    c_overflow: torch.Tensor  # bool: the corrector's bounds were exceeded
    n_new: torch.Tensor       # i32 frames decoded in the window


class DeviceStreamingSession:
    """Unbounded-stream session with all state on one device.

    ``feed`` runs one window per ``chunk_bytes`` (host syncs only with
    ``collect_paths``, as the module docstring counts them); results are
    read back when a property or reader is called.  ``device=None`` means
    CUDA.
    """

    def __init__(self, config: Optional[PipelineConfig] = None, chunk_bytes: int = 1 << 20,
                 group_capacity: int = 8192, max_groups: int = 128,
                 max_baselines_per_group: int = 192, collect_filtered: bool = False,
                 n_beams: int = 64, emit_capacity: Optional[int] = None, collect_paths=None,
                 device=None):
        self.config = config or PipelineConfig()
        if n_beams != self.config.scene.n_beams:
            raise ValueError(f"n_beams={n_beams} differs from the scene config's "
                             f"{self.config.scene.n_beams}")
        self.chunk_bytes = int(chunk_bytes)
        if self.chunk_bytes <= CARRY_BYTES:
            raise ValueError("chunk_bytes must exceed the 10-byte carry")
        self.device = resolve_device(device)
        self.collect_filtered = bool(collect_filtered)
        self._gcap = int(group_capacity)
        self._mg = int(max_groups)
        self._mbpg = int(max_baselines_per_group)
        self._n_beams = int(n_beams)
        # An explicit emit_capacity is fixed; None grows the ring in place.
        self._emit_auto = self.collect_filtered and emit_capacity is None
        if self.collect_filtered:
            self._ecap = int(emit_capacity) if emit_capacity is not None else 1 << 18
        else:
            self._ecap = 0
        self._emit_bound = 0     # kept rows <= one frame per 11 bytes fed

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

        self._state = self._zero_state()
        self._byte_carry = np.zeros(0, dtype=np.uint8)
        self._finalized = False
        self._overflow_warned = False
        self.checkpoint_extra = None

    def _zero_state(self) -> DeviceStreamState:
        dev = self.device

        def scalar(value, dtype=torch.int32):
            return torch.tensor(value, dtype=dtype, device=dev)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        nb = self._n_beams
        paths = None
        spec = self._paths_spec
        if spec is not None:
            p_n = spec.capacity + spec.s_step + 1
            t_n = spec.max_tracks
            f32 = torch.float32
            rings = zero_paths(spec.est_key, p_n, dev)
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
            carry_frames=zeros(self._gcap, 5), carry_count=scalar(0),
            sums=zeros(nb, nb, dtype=torch.float64 if self.config.scene.log_transform
                       else torch.int64),
            counts=zeros(nb, nb, dtype=torch.int64),
            n_frames=scalar(0), n_kept=scalar(0), n_groups=scalar(0),
            overflow=scalar(False, torch.bool), emit_buf=zeros(self._ecap, 4),
            emit_count=scalar(0), emit_overflow=scalar(False, torch.bool), paths=paths)

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
        buf = np.concatenate([self._byte_carry, np.asarray(chunk, dtype=np.uint8)])
        n = len(buf)
        c = self.chunk_bytes
        off = 0
        # Consecutive windows overlap by 10 bytes: a frame straddling a
        # window edge is decoded once, in the window that holds all of it.
        while n - off > CARRY_BYTES:
            piece = buf[off:off + c]
            m = len(piece)
            if m < c:
                piece = np.pad(piece, (0, c - m))
            rows_next = m // 11 + 1
            self._maybe_grow_emit(rows_next)
            self._step(self._to_device(piece), m)
            self._emit_bound += rows_next
            off = min(off + c, n) - CARRY_BYTES
        self._byte_carry = buf[off:].copy()

    def _to_device(self, piece: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(piece))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _close_groups(self, chunk: torch.Tensor, n_bytes: int) -> "_Window":
        """Decode one window after the carried open group and correct the
        groups its last UE-decrease boundary closes."""
        st, cfg = self._state, self.config
        rows_new, valid_new, n_new = decode_rows(chunk, cfg.decode, n_valid=n_bytes)   # K1
        combined = torch.cat([st.carry_frames, rows_new])
        rows = torch.arange(combined.shape[0], dtype=torch.int32, device=self.device)
        valid = torch.cat([rows[:self._gcap] < st.carry_count, valid_new])
        boundary = _group_starts(combined[:, 1], valid)
        closed = torch.where(boundary, rows, 0).max()       # 0 when no boundary
        corrected, keep, c_overflow = correct_rows(                                    # K2
            combined, valid & (rows < closed), self._mg, self._mbpg, cfg.correct)
        return _Window(combined, valid & (rows >= closed), boundary, corrected, keep,
                       c_overflow, n_new)

    def _emit_and_paths(self, kept: torch.Tensor, keep: torch.Tensor, close_all: bool) -> None:
        """One compaction of the kept rows (K5) for both their consumers:
        the emit-ring append at ``emit_count`` (offset read on the device;
        rows past the logical capacity are dropped and flagged) and the
        online paths' fresh buffer."""
        st = self._state
        dests = []
        if self._ecap:
            dests.append((self._ecap, st.emit_buf, st.emit_count))
        if st.paths is not None:
            dests.append((kept.shape[0], None, None))
        if not dests:
            return
        outs, n = compact_rows_multi(kept, keep, dests)
        if self._ecap:
            st.emit_overflow |= st.emit_count + n > self._ecap
            st.emit_count = (st.emit_count + n).clamp(max=self._ecap)
        if st.paths is not None:
            _paths_substep(st.paths, outs[-1], n, self._paths_spec, self._dict_args,
                           self._beam_ids, close_all)

    def _step(self, chunk: torch.Tensor, n_bytes: int) -> None:
        """One window: the JAX package's ``_step_body``, in place."""
        st = self._state
        w = self._close_groups(chunk, n_bytes)
        d_sums, d_counts = intensity_cell_sums(w.combined[:, 1], w.corrected, w.combined[:, 3],
                                               w.keep, w.combined[:, 0], self.config.scene)
        st.sums += d_sums
        st.counts += d_counts

        new_carry, n_carry = compact_rows(w.combined, w.open_mask, self._gcap)          # K5
        self._emit_and_paths(_kept_rows(w.combined, w.corrected), w.keep, close_all=False)

        st.carry_frames = new_carry
        st.carry_count = n_carry.clamp(max=self._gcap)
        st.n_frames += w.n_new
        st.n_kept += w.keep.sum(dtype=torch.int32)
        st.n_groups += w.boundary.sum(dtype=torch.int32)
        st.overflow |= w.c_overflow | (n_carry > self._gcap)

    def finalize(self) -> None:
        """Flush the final open sweep group (end of stream); a second call
        does nothing."""
        if self._finalized:
            return
        st, cfg = self._state, self.config
        valid = torch.arange(self._gcap, device=self.device) < st.carry_count
        corrected, keep, c_overflow = correct_rows(st.carry_frames, valid, self._mg,
                                                   self._mbpg, cfg.correct)
        d_sums, d_counts = intensity_cell_sums(st.carry_frames[:, 1], corrected,
                                               st.carry_frames[:, 3], keep,
                                               st.carry_frames[:, 0], cfg.scene)
        st.sums += d_sums
        st.counts += d_counts
        self._emit_and_paths(_kept_rows(st.carry_frames, corrected), keep, close_all=True)
        st.n_kept += keep.sum(dtype=torch.int32)
        st.n_groups += (st.carry_count > 0).to(torch.int32)
        st.overflow |= c_overflow
        st.carry_frames.zero_()
        st.carry_count.zero_()
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


def _ckpt_fill_state(zero_state: DeviceStreamState, leaves) -> None:
    """Copy the checkpointed leaves into ``zero_state``'s tensors after
    checking each one's shape and dtype."""
    zero_leaves = _leaves(zero_state)
    if len(zero_leaves) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} state leaves, the restored "
                         f"configuration builds {len(zero_leaves)}")
    for i, (z, arr) in enumerate(zip(zero_leaves, leaves)):
        if tuple(z.shape) != tuple(arr.shape) or _NP_DTYPE[z.dtype] != arr.dtype:
            raise ValueError(f"checkpoint leaf {i} is {arr.dtype}{list(arr.shape)} but the "
                             f"restored configuration expects {z.dtype}{list(z.shape)}")
    for z, arr in zip(zero_leaves, leaves):
        z.copy_(torch.from_numpy(np.array(arr)))


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
