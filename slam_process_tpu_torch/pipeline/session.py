"""Session orchestration: one capture session, decoded, corrected and
estimated per sweep.

The port of ``slam_process_tpu/pipeline/session.py``'s ``Session`` for the
single-session paths:

  * ``from_log(engine="device")`` runs the on-device pipeline (kernels K1,
    K2); when the corrector's default bounds (256 groups, 256 baselines in
    a group) overflow, it reruns it on the same device with bounds sized to
    the log's own counts, where the JAX package falls back to its host
    engine.  ``engine="host"`` is the numpy decode, corrected by
    ``correct()``.
  * ``sweep_intensity`` / ``sweep_paths`` build the per-sweep [S, 64, 64]
    grids (kernel K4) and run the per-sweep NN-OMP estimator on a device.

Every method that touches a device takes ``device=None``, meaning CUDA;
``device="cpu"`` runs the plain PyTorch versions.  Not ported yet: the
``pad_to`` / ``sweep_paths_dataset`` batched form and the ``mesh`` form.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from slam_process_tpu_torch.config import PipelineConfig, SceneConfig
from slam_process_tpu_torch.io import read_hex_log
from slam_process_tpu_torch.io.angles import load_angle_lut
from slam_process_tpu_torch.models.dictionary import dictionary_to_device
from slam_process_tpu_torch.models.nn_omp import OmpPaths
from slam_process_tpu_torch.models.sweep_estimation import (
    sweep_estimator_body, sweep_estimator_setup)
from slam_process_tpu_torch.ops.correct import (
    correct_bounds, correct_frames_np, detect_groups_np)
from slam_process_tpu_torch.ops.decode import decode_frames_np
from slam_process_tpu_torch.ops.scene import intensity_grid_np, intensity_per_sweep
from slam_process_tpu_torch.pipeline.device import resolve_device, run_session_on_device
from slam_process_tpu_torch.utils.timestamps import extract_timestamp, unwrap_clk_anchors

MAX_GROUPS = 256
MAX_BASELINES_PER_GROUP = 256


class Session:
    """One serial-debug capture session: decode -> correct -> per sweep."""

    def __init__(self, name: str = "session", config: Optional[PipelineConfig] = None):
        self.name = name
        self.config = config or PipelineConfig()
        self.logger = logging.getLogger(f"slam_process_tpu_torch.{name}")
        self.frames: Optional[np.ndarray] = None         # [F, 5] int64
        self.corrected_bs: Optional[np.ndarray] = None   # [F] int64
        self._filtered: Optional[np.ndarray] = None      # [K, 4] int64
        self._filtered_gen = 0
        self._sweep_prep_memo: dict = {}

    @property
    def filtered(self) -> Optional[np.ndarray]:
        return self._filtered

    @filtered.setter
    def filtered(self, value: Optional[np.ndarray]) -> None:
        # Every rebind bumps the generation that the sweep memo keys on and
        # drops the memo.
        self._filtered = value
        self._filtered_gen += 1
        self._sweep_prep_memo = {}

    # -- construction -------------------------------------------------------

    @classmethod
    def from_log(cls, path: Union[str, Path], config: Optional[PipelineConfig] = None,
                 engine: str = "device", device=None) -> "Session":
        """Load and decode a raw log; ``engine="device"`` also corrects it on
        ``device`` (None: CUDA), whatever its group and baseline counts,
        ``engine="host"`` decodes with numpy."""
        if engine not in ("device", "host"):
            raise ValueError(f"unknown engine {engine!r}; use 'device' or 'host'")
        s = cls(name=extract_timestamp(str(path)) or Path(path).stem, config=config)
        raw = read_hex_log(path)
        if engine == "host":
            s.frames = decode_frames_np(raw, s.config.decode).frames
            return s
        kw = dict(device=device, decode_cfg=s.config.decode, correct_cfg=s.config.correct)
        out = run_session_on_device(raw, max_groups=MAX_GROUPS,
                                    max_baselines_per_group=MAX_BASELINES_PER_GROUP, **kw)
        if bool(out.correct_overflow):
            n_groups, n_baselines = correct_bounds(out.frames, out.frame_valid)
            s.logger.info("%d sweep groups, up to %d baselines in one: rerunning the "
                          "corrector with bounds sized to them", n_groups, n_baselines)
            out = run_session_on_device(
                raw, max_groups=max(n_groups, MAX_GROUPS),
                max_baselines_per_group=max(n_baselines, MAX_BASELINES_PER_GROUP), **kw)
        valid = out.frame_valid.cpu().numpy()
        s.frames = out.frames.cpu().numpy()[valid].astype(np.int64)
        corrected = out.corrected_bs.cpu().numpy()[valid].astype(np.int64)
        keep = out.keep.cpu().numpy()[valid]
        if len(s.frames) != int(out.n_frames) or bool(out.correct_overflow):
            raise RuntimeError("device pipeline: frame count or corrector bounds disagree")
        s.corrected_bs = corrected
        s.filtered = np.stack([s.frames[keep, 1], corrected[keep], s.frames[keep, 3],
                               s.frames[keep, 4]], axis=1)
        return s

    # -- stages --------------------------------------------------------------

    def correct(self) -> np.ndarray:
        """Host correct + filter of the decoded frames."""
        if self.frames is None:
            raise ValueError("no decoded frames; load a log first")
        res = correct_frames_np(self.frames, self.config.correct)
        self.filtered = res.filtered   # the setter drops the sweep memo
        self.corrected_bs = res.corrected_bs
        return self.filtered

    def _sweep_ids(self, max_sweeps: Optional[int]):
        if self.filtered is None:
            self.correct()
        gid = detect_groups_np(self.filtered[:, 0])
        return gid, max_sweeps or int(gid.max()) + 1

    def sweep_intensity(self, max_sweeps: Optional[int] = None, device=None):
        """Per-sweep (mean [S, 64, 64] f32 with NaN empties, counts i32), as
        numpy, built on ``device`` (None: CUDA) by kernel K4."""
        dev = resolve_device(device)
        gid, n_sweeps = self._sweep_ids(max_sweeps)
        mean, counts = self._sweep_grids(gid, n_sweeps, dev)
        return mean.cpu().numpy(), counts.cpu().numpy()

    def _sweep_grids(self, gid: np.ndarray, n_sweeps: int, dev: torch.device):
        cols = [torch.from_numpy(np.asarray(c)).to(dev, torch.int32)
                for c in (self.filtered[:, 0], self.filtered[:, 1], self.filtered[:, 2], gid)]
        valid = torch.ones(len(self.filtered), dtype=torch.bool, device=dev)
        return intensity_per_sweep(*cols, valid, n_sweeps)

    def sweep_times(self, max_sweeps: Optional[int] = None) -> np.ndarray:
        """Per-sweep CLK anchors (the first kept frame's CLK), unwrapped
        across 30-bit counter wraps; -1 for sweeps with no rows."""
        gid, n_sweeps = self._sweep_ids(max_sweeps)
        times = np.full(n_sweeps, -1, dtype=np.int64)
        first_gid, first_row = np.unique(gid, return_index=True)
        inside = first_gid < n_sweeps
        times[first_gid[inside]] = self.filtered[first_row[inside], 3]
        return unwrap_clk_anchors(times, self.logger)

    def _sweep_host_prep(self, angle_file: Union[str, Path], estimator: str = "nn_omp",
                         max_sweeps: Optional[int] = None, **overrides):
        """Host prep for per-sweep estimation, memoized per (angle file,
        estimator, max_sweeps, overrides, filtered generation): sweep ids,
        the session's compact beam ids (observed and mapped), the float64
        dictionary and the estimator key."""
        if self.filtered is None:
            self.correct()
        memo_key = (str(angle_file), estimator, max_sweeps,
                    tuple(sorted(overrides.items())), self._filtered_gen)
        if memo_key in self._sweep_prep_memo:
            return self._sweep_prep_memo[memo_key]
        gid, n_sweeps = self._sweep_ids(max_sweeps)
        lut = load_angle_lut(angle_file)
        grid = intensity_grid_np(self.filtered[:, 0], self.filtered[:, 1],
                                 self.filtered[:, 2], cfg=SceneConfig())
        ue_ids = np.nonzero(np.asarray(grid.row_mask) & np.isfinite(lut))[0]
        bs_ids = np.nonzero(np.asarray(grid.col_mask) & np.isfinite(lut))[0]
        d, est_key = sweep_estimator_setup(estimator, lut[ue_ids], lut[bs_ids], **overrides)
        result = (gid, n_sweeps, ue_ids, bs_ids, d, est_key)
        self._sweep_prep_memo[memo_key] = result
        return result

    def _sweep_estimation_inputs(self, angle_file: Union[str, Path], estimator: str,
                                 max_sweeps: Optional[int], dev: torch.device, **overrides):
        """(sub [S, U, B] f32 on ``dev``, NaN where unobserved; the session
        dictionary as float32 tensors on ``dev``; est_key; n_sweeps),
        memoized beside the host prep."""
        gid, n_sweeps, ue_ids, bs_ids, d, est_key = self._sweep_host_prep(
            angle_file, estimator, max_sweeps, **overrides)
        memo_key = ("inputs", str(dev), str(angle_file), estimator, max_sweeps,
                    tuple(sorted(overrides.items())), self._filtered_gen)
        if memo_key in self._sweep_prep_memo:
            return self._sweep_prep_memo[memo_key]
        mean, _ = self._sweep_grids(gid, n_sweeps, dev)
        sub = mean[:, torch.from_numpy(ue_ids).to(dev)][:, :, torch.from_numpy(bs_ids).to(dev)]
        result = (sub, dictionary_to_device(d, dev), est_key, n_sweeps)
        self._sweep_prep_memo[memo_key] = result
        return result

    def sweep_paths(self, angle_file: Union[str, Path], estimator: str = "nn_omp",
                    max_sweeps: Optional[int] = None, device=None, **overrides):
        """Per-sweep multipath estimation on ``device`` (None: CUDA).

        Returns (paths, sweep_valid) as numpy: ``paths`` an OmpPaths of [S,
        K] arrays (f32 angles and power, bool valid, i32 indices; n_iters
        [S] i32), ``sweep_valid[s]`` False for sweeps with no observed cell
        in the session's compact submatrix.
        """
        dev = resolve_device(device)
        sub, d, est_key, n_sweeps = self._sweep_estimation_inputs(
            angle_file, estimator, max_sweeps, dev, **overrides)
        out, valid = sweep_estimator_body(est_key)(sub, d.phi_rx, d.phi_tx, d.aoa_grid,
                                                   d.aod_grid)
        paths = OmpPaths(*(x.cpu().numpy()[:n_sweeps] for x in out))
        return paths, valid.cpu().numpy()[:n_sweeps]
