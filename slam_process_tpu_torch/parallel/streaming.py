"""Host streaming session: chunked decode -> correct -> intensity on the
CPU, with no CUDA device.

The port of ``slam_process_tpu/parallel/streaming.py`` (``StreamingSession``,
``replay_log``, ``iter_chunks``).  Bytes are decoded with the numpy
``frame_start_mask`` / ``extract_fields`` and each sweep group is corrected
with ``correct_frames_np`` once it closes, with the offline result's
semantics:

  * decode carry: positions with a full 11-byte window get their verdict in
    the chunk that holds them, so the carry is the last ``min(10, bytes
    after the last frame)`` bytes, the only ones whose verdict more data can
    change;
  * correction: a row's correction depends on every baseline of its sweep
    group, so rows wait until the group closes (UE decrease), then are
    corrected and folded into the running sums (cell means are sum / count,
    so the order of the folds does not matter).

With ``collect_paths`` each sweep of kept rows that closes runs the
per-sweep NN-OMP estimator at once (``models/sweep_estimation``) in PyTorch
on the CPU, one sweep per call: its products are float64 rounded once, so a
lane's result does not depend on the batch it runs in, and the JAX
package's padding of the call to eight lanes is not needed.  Nothing here
touches ``torch.cuda``: the host engine runs where there is no card.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Iterator, Optional, Union

import numpy as np
import torch

from slam_process_tpu_torch.config import PipelineConfig, RenderConfig
from slam_process_tpu_torch.models.sweep_estimation import path_power, sweep_estimator_body
from slam_process_tpu_torch.models.tracking import (
    track_paths_np, track_sweep_step_np, track_velocities)
from slam_process_tpu_torch.ops.correct import correct_frames_np
from slam_process_tpu_torch.ops.decode import extract_fields, frame_start_mask
from slam_process_tpu_torch.ops.scene import IntensityGrid, grid_from_sums_np
from slam_process_tpu_torch.parallel.streaming_device import render_grid
from slam_process_tpu_torch.render.heatmap import RenderedHeatmap
from slam_process_tpu_torch.utils.timestamps import unwrap_clk_anchors

_LOGGER = logging.getLogger("slam_process_tpu_torch.streaming")
_CPU = torch.device("cpu")


class StreamingSession:
    """Host-engine streaming session.

    ``collect_paths`` (a ``(spec, dict_args)`` pair from
    ``parallel.streaming_device.make_paths_spec``) arms online per-sweep
    estimation and CLK anchoring as ``DeviceStreamingSession(collect_paths=
    ...)`` does: kept rows are segmented into sweeps as they come (UE
    decrease, carried across chunks), each sweep that closes is estimated
    at once, and memory stays O(closed sweeps).  The paths readers equal the
    offline ``Session.sweep_paths`` / ``path_tracks`` on the same stream.
    """

    def __init__(self, config: Optional[PipelineConfig] = None, n_beams: int = 64,
                 collect_paths=None):
        self.config = config or PipelineConfig()
        self._carry = np.zeros(0, dtype=np.uint8)
        self._group_rows: list[np.ndarray] = []   # frames of the open sweep group
        self._last_ue: Optional[int] = None
        self.n_frames = 0
        self.n_kept = 0
        self.n_groups = 0
        self.filtered_parts: list[np.ndarray] = []
        nb = n_beams
        self._sums = np.zeros((nb, nb))
        self._counts = np.zeros((nb, nb), dtype=np.int64)
        self._finalized = False
        self.checkpoint_extra = None
        if collect_paths is not None:
            spec, dict_args = collect_paths
            self._paths_spec = spec
            self._dict_args = tuple(np.asarray(a) for a in dict_args)
            self._p_open_sums = np.zeros((nb, nb), np.float32)
            self._p_open_counts = np.zeros((nb, nb), np.float32)
            self._p_open_time = -1
            self._p_last_ue = -1
            self._p_est: list = []     # the body's paths, [1, K] numpy arrays, per closed sweep
            self._p_valid: list = []
            self._p_times: list = []
            # The tracker behind track_columns, advanced lazily over _p_est,
            # so a checkpoint needs no state of its own.
            t_n = spec.max_tracks
            self._trk_pos = np.zeros((t_n, 2), np.float32)
            self._trk_created = np.zeros(t_n, bool)
            self._trk_count = 0
            self._trk_cols: list = []  # per sweep (aoa, aod, power, observed) [T]
        else:
            self._paths_spec = None
            self._dict_args = ()

    # -- ingest --------------------------------------------------------------

    def feed(self, chunk: Union[bytes, np.ndarray]) -> int:
        """Consume one chunk of tokenized bytes; returns the frames decoded."""
        if self._finalized:
            raise RuntimeError(
                "session already finalized: the flush closed the open sweep group, so "
                "feeding more bytes would mis-segment sweeps; start (or restore) a "
                "non-finalized session")
        if isinstance(chunk, (bytes, bytearray)):
            chunk = np.frombuffer(chunk, dtype=np.uint8)
        buf = np.concatenate([self._carry, np.asarray(chunk, dtype=np.uint8)])
        n = len(buf)
        dec = self.config.decode
        starts = np.nonzero(frame_start_mask(buf, dec))[0]
        frames = extract_fields(buf, starts) if starts.size else np.zeros((0, 5), np.int64)
        # The carry: the suffix that may still become a frame with more data.
        last_end = int(starts[-1]) + dec.frame_len if starts.size else 0
        self._carry = buf[max(n - (dec.frame_len - 1), last_end):].copy()
        self.n_frames += len(frames)
        self._push_frames(frames)
        return len(frames)

    def _push_frames(self, frames: np.ndarray) -> None:
        """Split the chunk's frames at UE decreases, close every completed
        group and buffer the open tail."""
        if not len(frames):
            return
        ue = frames[:, 1]
        boundary = np.zeros(len(frames), dtype=bool)
        boundary[0] = self._last_ue is not None and ue[0] < self._last_ue
        boundary[1:] = ue[:-1] > ue[1:]
        start = 0
        for cut in np.nonzero(boundary)[0]:
            if cut > start:
                self._group_rows.append(frames[start:cut])
            self._correct_and_fold_open()
            start = int(cut)
        self._group_rows.append(frames[start:])
        self._last_ue = int(ue[-1])

    def _correct_and_fold_open(self) -> None:
        if not self._group_rows:
            return
        group = np.concatenate(self._group_rows)
        self._group_rows = []
        if not len(group):
            return
        self.n_groups += 1
        res = correct_frames_np(group, self.config.correct)
        if not len(res.filtered):
            return
        self.filtered_parts.append(res.filtered)
        self.n_kept += len(res.filtered)
        if self._paths_spec is not None:
            self._paths_push(res.filtered)
        ue, bs = res.filtered[:, 0], res.filtered[:, 1]
        rss = res.filtered[:, 2].astype(np.float64)
        if self.config.scene.log_transform:
            # The pre-log scene: drop RSS <= 0 and fold ln(RSS), so the sums
            # give the offline pivot's mean(ln).
            pos = rss > 0
            ue, bs, rss = ue[pos], bs[pos], np.log(rss[pos])
        np.add.at(self._sums, (ue, bs), rss)
        np.add.at(self._counts, (ue, bs), 1)

    # -- online per-sweep estimation -------------------------------------------

    def _paths_push(self, rows: np.ndarray) -> None:
        """Segment a fold's kept rows into sweeps (UE decrease, seeded with
        the previous fold's last kept UE) and estimate every sweep that
        closes: the device step's boundary rule."""
        ue = rows[:, 0]
        prev = np.concatenate([[self._p_last_ue], ue[:-1]])
        start = 0
        for cut in np.nonzero((prev >= 0) & (prev > ue))[0]:
            self._p_accumulate(rows[start:cut])
            self._p_close_sweep()
            start = int(cut)
        self._p_accumulate(rows[start:])
        self._p_last_ue = int(ue[-1])

    def _p_accumulate(self, rows: np.ndarray) -> None:
        if not len(rows):
            return
        if self._p_open_time < 0:
            self._p_open_time = int(rows[0, 3])
        np.add.at(self._p_open_sums, (rows[:, 0], rows[:, 1]), rows[:, 2].astype(np.float32))
        np.add.at(self._p_open_counts, (rows[:, 0], rows[:, 1]), np.float32(1))

    def _estimate(self, mats: np.ndarray):
        """(OmpPaths or SmSicPaths, sweep_valid) of numpy arrays for [S, U, B]
        float32 mats, the per-sweep estimator on the CPU."""
        est, valid = sweep_estimator_body(self._paths_spec.est_key)(
            torch.from_numpy(mats), *(torch.from_numpy(a) for a in self._dict_args))
        return type(est)(*(x.numpy() for x in est)), valid.numpy()

    def _p_close_sweep(self) -> None:
        """Estimate the closed sweep from its float32 sums and counts (exact
        integer sums, the device formulation), as a batch of one."""
        spec = self._paths_spec
        counts = self._p_open_counts
        mean = np.where(counts > 0, self._p_open_sums / np.maximum(counts, np.float32(1.0)),
                        np.float32(np.nan)).astype(np.float32)
        est, valid = self._estimate(mean[np.ix_(list(spec.ue_ids), list(spec.bs_ids))][None])
        self._p_est.append(est)
        self._p_valid.append(valid)
        self._p_times.append(self._p_open_time)
        self._p_open_sums[:] = 0
        self._p_open_counts[:] = 0
        self._p_open_time = -1

    def _spec(self):
        if self._paths_spec is None:
            raise ValueError("built without collect_paths")
        return self._paths_spec

    def sweep_paths(self):
        """Online per-sweep estimates: (OmpPaths or SmSicPaths of [n_closed,
        K] numpy arrays, sweep_valid [n_closed]); equal to the offline
        ``Session.sweep_paths`` on the same stream."""
        spec = self._spec()
        if not self._p_est:
            # No sweep closed: the empty result's shapes and dtypes from one
            # call on an all-NaN sweep.
            nan = np.full((1, len(spec.ue_ids), len(spec.bs_ids)), np.nan, np.float32)
            est, valid = self._estimate(nan)
            return type(est)(*(x[:0] for x in est)), valid[:0]
        paths = type(self._p_est[0])(*(np.concatenate(parts) for parts in zip(*self._p_est)))
        return paths, np.concatenate(self._p_valid)

    def sweep_times(self) -> np.ndarray:
        """CLK anchors of the closed sweeps, unwrapped as the offline
        ``Session.sweep_times`` unwraps them."""
        self._spec()
        return unwrap_clk_anchors(np.asarray(self._p_times, np.int64), _LOGGER)

    def path_tracks(self):
        """(tracks, times, (vel_aoa, vel_aod, ok)): the offline
        ``Session.path_tracks`` contract, from the online estimates."""
        spec = self._spec()
        paths, sweep_valid = self.sweep_paths()
        times = self.sweep_times()
        valid = np.asarray(paths.valid, bool) & sweep_valid[:, None] & (times >= 0)[:, None]
        tracks = track_paths_np(paths.aoa, paths.aod, path_power(paths), valid,
                                max_tracks=spec.max_tracks, gate_deg=spec.gate_deg)
        return tracks, times, track_velocities(tracks, times)

    def track_columns(self, lo: int, hi: int):
        """Track columns of closed sweeps ``[lo, hi)``: (aoa [m, T], aod,
        power, observed, raw CLK anchors [m]), the live ``watch --events``
        feed's read.  The association step ``path_tracks`` runs
        (``track_sweep_step_np``) is advanced lazily over the stored
        estimates and cached, so a poll costs O(new sweeps) and the columns
        equal ``path_tracks``' column for column."""
        spec = self._spec()
        n = len(self._p_times)
        lo, hi = max(int(lo), 0), min(int(hi), n)
        gate2 = np.float32(spec.gate_deg) * np.float32(spec.gate_deg)
        while len(self._trk_cols) < hi:
            s = len(self._trk_cols)
            est = self._p_est[s]
            # path_tracks' inputs for one sweep: path-valid, sweep-valid and
            # anchored (unwrapped anchors are >= 0 where raw ones are).
            valid_s = (np.asarray(est.valid, bool)[0] & bool(self._p_valid[s][0])
                       & (int(self._p_times[s]) >= 0))
            self._trk_count, *col = track_sweep_step_np(
                self._trk_pos, self._trk_created, self._trk_count,
                np.asarray(est.aoa, np.float32)[0], np.asarray(est.aod, np.float32)[0],
                np.asarray(path_power(est), np.float32)[0], valid_s, gate2)
            self._trk_cols.append(col)
        cols = self._trk_cols[lo:hi]
        t_n = spec.max_tracks
        if not cols:
            z = np.zeros((0, t_n), np.float32)
            return z, z.copy(), z.copy(), np.zeros((0, t_n), bool), np.zeros(0, np.int64)
        return (*(np.stack(c) for c in zip(*cols)),
                np.asarray(self._p_times[lo:hi], np.int64))

    @property
    def n_sweeps_closed(self) -> int:
        self._spec()
        return len(self._p_times)

    def finalize(self) -> None:
        """Flush the open sweep group (end of stream); a second call does
        nothing."""
        if self._finalized:
            return
        self._correct_and_fold_open()
        if self._paths_spec is not None and float(self._p_open_counts.sum()) > 0:
            self._p_close_sweep()
        self._last_ue = None
        self._finalized = True

    # -- checkpoint / resume ---------------------------------------------------

    def save_checkpoint(self, path, extra: Optional[dict] = None) -> None:
        """Write the whole host streaming state to ``path`` (one npz file):
        the JAX package's layout and ``kind="host_stream"``, with this
        package's classes in the pickled meta, so neither package reads the
        other's.  ``extra`` comes back as ``restored.checkpoint_extra``;
        the file is written to ``<path>.tmp`` and renamed."""
        group = (np.concatenate(self._group_rows) if self._group_rows
                 else np.zeros((0, 5), np.int64))
        meta = {
            "version": 1, "kind": "host_stream", "config": self.config,
            "last_ue": self._last_ue, "n_frames": self.n_frames, "n_kept": self.n_kept,
            "n_groups": self.n_groups, "finalized": self._finalized, "extra": extra,
            "paths_spec": self._paths_spec, "dict_args": tuple(self._dict_args),
            "paths_state": (None if self._paths_spec is None else {
                "open_sums": self._p_open_sums, "open_counts": self._p_open_counts,
                "open_time": self._p_open_time, "last_ue": self._p_last_ue,
                "est": self._p_est, "valid": self._p_valid, "times": self._p_times}),
        }
        blob = np.frombuffer(pickle.dumps(meta, protocol=4), np.uint8)
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, meta=blob, carry=self._carry, sums=self._sums, counts=self._counts,
                     group=group, filtered=self.filtered)
        os.replace(tmp, path)

    @classmethod
    def restore(cls, path) -> "StreamingSession":
        """Rebuild a session from ``save_checkpoint`` output.  Unpickles the
        meta: open only checkpoints you wrote."""
        with np.load(path, allow_pickle=False) as z:
            meta = pickle.loads(z["meta"].tobytes())
            if meta.get("kind") != "host_stream":
                raise ValueError(
                    f"not a StreamingSession checkpoint: kind={meta.get('kind')!r} "
                    "(device-engine checkpoints restore via DeviceStreamingSession.restore)")
            if meta.get("version") != 1:
                raise ValueError(f"unsupported checkpoint version {meta.get('version')!r}")
            carry, sums, counts, group, filtered = (z[k] for k in (
                "carry", "sums", "counts", "group", "filtered"))
        spec = meta.get("paths_spec")
        sess = cls(config=meta["config"], n_beams=sums.shape[0],
                   collect_paths=(spec, meta["dict_args"]) if spec is not None else None)
        if spec is not None:
            ps = meta["paths_state"]
            sess._p_open_sums = np.asarray(ps["open_sums"], np.float32)
            sess._p_open_counts = np.asarray(ps["open_counts"], np.float32)
            sess._p_open_time = int(ps["open_time"])
            sess._p_last_ue = int(ps["last_ue"])
            sess._p_est = list(ps["est"])
            sess._p_valid = list(ps["valid"])
            sess._p_times = list(ps["times"])
        sess._carry = np.asarray(carry, np.uint8)
        sess._sums = np.asarray(sums, np.float64)
        sess._counts = np.asarray(counts, np.int64)
        sess._group_rows = [np.asarray(group, np.int64)] if len(group) else []
        sess._last_ue = meta["last_ue"]
        sess.n_frames = int(meta["n_frames"])
        sess.n_kept = int(meta["n_kept"])
        sess.n_groups = int(meta["n_groups"])
        sess.filtered_parts = [np.asarray(filtered, np.int64)] if len(filtered) else []
        sess._finalized = bool(meta["finalized"])
        sess.checkpoint_extra = meta.get("extra")
        return sess

    # -- results ---------------------------------------------------------------

    @property
    def filtered(self) -> np.ndarray:
        """Corrected rows [N, 4] int64 (ue, corrected_bs, rss, clk), in
        stream order."""
        if not self.filtered_parts:
            return np.zeros((0, 4), dtype=np.int64)
        return np.concatenate(self.filtered_parts)

    def intensity(self) -> IntensityGrid:
        """IntensityGrid of numpy arrays from the running sums and counts."""
        return grid_from_sums_np(self._sums, self._counts)

    def render(self, angle_lut: np.ndarray, render_cfg: Optional[RenderConfig] = None
               ) -> RenderedHeatmap:
        """The heatmap raster of ``intensity()``'s grid, with K3's plain
        version on the CPU."""
        return render_grid(self.intensity(), angle_lut, _CPU, render_cfg)


def replay_log(raw: np.ndarray, chunk_bytes: int = 1 << 16,
               config: Optional[PipelineConfig] = None, render_every: int = 0,
               angle_lut: Optional[np.ndarray] = None, collect_paths=None) -> StreamingSession:
    """Replay one tokenized log through the host streaming session, rendering
    every ``render_every`` chunks when given an angle table."""
    s = StreamingSession(config, collect_paths=collect_paths)
    for n_chunks, chunk in enumerate(iter_chunks(raw, chunk_bytes), start=1):
        s.feed(chunk)
        if render_every and angle_lut is not None and n_chunks % render_every == 0:
            s.render(angle_lut)
    s.finalize()
    return s


def iter_chunks(raw: np.ndarray, chunk_bytes: int) -> Iterator[np.ndarray]:
    for off in range(0, len(raw), chunk_bytes):
        yield raw[off:off + chunk_bytes]
