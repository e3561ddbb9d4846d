"""Session orchestration: one capture session, decoded, corrected and
estimated per sweep.

The port of ``slam_process_tpu/pipeline/session.py``'s ``Session`` for the
single-session paths:

  * ``from_log(engine="device")`` runs the on-device pipeline (kernels K1,
    K2, K3); ``engine="host"`` is the numpy decode.  ``from_parsed_xlsx`` /
    ``from_filtered_xlsx`` / ``load_npz`` load the stage artifacts, and
    ``export_parsed`` / ``export_filtered`` / ``export_corrected`` /
    ``save_npz`` write them.
  * ``correct(engine="device")`` corrects the decoded frames on a device
    (kernel K2); ``engine="host"`` is the numpy host engine.  When the
    device corrector's default bounds (256 groups, 256 baselines in a
    group) overflow, ``from_log`` and ``correct`` rerun it on the same
    device with bounds sized to the data (``_run_with_sized_bounds``),
    where the JAX package falls back to its host engine.
  * ``intensity`` builds the mean-RSS grid and ``render_heatmap`` its
    raster (kernel K3) and PNG.
  * ``sweep_intensity`` / ``sweep_paths`` build the per-sweep [S, 64, 64]
    grids (kernel K4) and run the per-sweep estimator (NN-OMP or SM-SIC)
    on a device; ``path_tracks`` associates the paths into CLK-anchored
    tracks (kernel K6 by default; ``engine="host"`` is the numpy
    association), and ``scene_changes`` turns the tracks into change
    events.
  * ``sweep_paths_dataset`` runs the per-sweep estimator over many
    sessions padded to common shapes and reads all results back once.

Every method that touches a device takes ``device=None``, meaning CUDA;
``device="cpu"`` runs the plain PyTorch versions.  ``counters`` holds each
stage's health counters (the JAX package's keys per engine) and
``timings`` its host seconds.  ``sweep_paths`` and ``sweep_paths_dataset``
also take a ``mesh`` (``parallel/mesh.py``): sweeps over ``data``, NN-OMP's
AoA grid over ``model``.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np
import torch

from slam_process_tpu_torch.config import PipelineConfig, RenderConfig, SceneConfig
from slam_process_tpu_torch.io import read_hex_log
from slam_process_tpu_torch.io.angles import load_angle_lut
from slam_process_tpu_torch.io.schemas import (
    PARSED_COLUMNS, read_filtered_table, read_parsed_table, write_filtered_table,
    write_parsed_table)
from slam_process_tpu_torch.io.xlsx import write_xlsx_table
from slam_process_tpu_torch.models.dictionary import BeamDictionary
from slam_process_tpu_torch.models.sweep_estimation import (
    estimator_dictionary, path_power, sweep_estimator_body, sweep_estimator_setup,
    sweep_program)
from slam_process_tpu_torch.models.tracking import (
    Tracks, track_paths_np, track_program, track_velocities)
from slam_process_tpu_torch.ops.correct import (
    correct_bounds, correct_frames_np, correct_rows, detect_groups_np, group_counts)
from slam_process_tpu_torch.ops.decode import decode_frames_np
from slam_process_tpu_torch.ops.scene import (
    IntensityGrid, intensity_grid, intensity_grid_np, intensity_per_sweep)
from slam_process_tpu_torch.parallel.mesh import placement, read_per_device, shard_rows
from slam_process_tpu_torch.pipeline.device import resolve_device, run_session_on_device
from slam_process_tpu_torch.render.heatmap import RenderedHeatmap, render_intensity, save_heatmap
from slam_process_tpu_torch.utils.logging import StageCounters
from slam_process_tpu_torch.utils.timestamps import extract_timestamp, unwrap_clk_anchors

MAX_GROUPS = 256
MAX_BASELINES_PER_GROUP = 256


def sweep_bucket(n: int, quantum: int = 8) -> int:
    """A session's sweep count rounded up to a bucket, as the JAX package's
    ``_sweep_bucket`` rounds it: a multiple of 8, at least 8.  Sessions of
    one bucket share one shape, so ``sweep_paths_dataset`` runs a few
    compiled programs where each session's own count would make one each."""
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


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
        self.n_discarded: Optional[int] = None           # the decoder's discard counter
        self.counters: list[StageCounters] = []
        self.timings: dict[str, float] = {}

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
                 engine: str = "device", device=None,
                 count_discards: bool = False) -> "Session":
        """Load and decode a raw log; ``engine="device"`` also corrects it on
        ``device`` (None: CUDA), whatever its group and baseline counts,
        ``engine="host"`` decodes with numpy.  ``n_discarded`` is the
        decoder's discard counter: the host engine always counts it, the
        device engine with ``count_discards`` (on the device)."""
        if engine not in ("device", "host"):
            raise ValueError(f"unknown engine {engine!r}; use 'device' or 'host'")
        s = cls(name=extract_timestamp(str(path)) or Path(path).stem, config=config)
        t0 = time.perf_counter()
        raw = read_hex_log(path)
        if engine == "host":
            res = decode_frames_np(raw, s.config.decode)
            s.timings["decode"] = time.perf_counter() - t0
            s.frames, s.n_discarded = res.frames, res.discarded
            s._count("decode", bytes=len(raw), valid=res.valid, discarded=res.discarded)
            return s
        kw = dict(device=device, decode_cfg=s.config.decode, correct_cfg=s.config.correct,
                  count_discards=count_discards)

        def run(max_groups, max_baselines):
            out = run_session_on_device(raw, max_groups=max_groups,
                                        max_baselines_per_group=max_baselines, **kw)
            return out, out.correct_overflow, out.frames, out.frame_valid

        out = s._run_with_sized_bounds(run)
        valid = out.frame_valid.cpu().numpy()
        s.frames = out.frames.cpu().numpy()[valid].astype(np.int64)
        corrected = out.corrected_bs.cpu().numpy()[valid].astype(np.int64)
        keep = out.keep.cpu().numpy()[valid]
        if len(s.frames) != int(out.n_frames) or bool(out.correct_overflow):
            raise RuntimeError("device pipeline: frame count or corrector bounds disagree")
        s.corrected_bs = corrected
        s.filtered = np.stack([s.frames[keep, 1], corrected[keep], s.frames[keep, 3],
                               s.frames[keep, 4]], axis=1)
        if count_discards:
            s.n_discarded = int(out.n_discarded)
        s.timings["device_pipeline"] = time.perf_counter() - t0
        s._count("decode+correct(device)", bytes=len(raw), valid=len(s.frames),
                 corrected=int(keep.sum()))
        return s

    @classmethod
    def from_parsed_xlsx(cls, path: Union[str, Path],
                         config: Optional[PipelineConfig] = None) -> "Session":
        """A session of the decoded frames of a Parsed xlsx (any header
        variant; see ``io/schemas.read_parsed_table``)."""
        s = cls(name=extract_timestamp(str(path)) or Path(path).stem, config=config)
        s.frames = read_parsed_table(path)
        return s

    @classmethod
    def from_filtered_xlsx(cls, path: Union[str, Path],
                           config: Optional[PipelineConfig] = None) -> "Session":
        """A session of the filtered rows of a filtered xlsx (any header
        variant; see ``io/schemas.read_filtered_table``)."""
        s = cls(name=extract_timestamp(str(path)) or Path(path).stem, config=config)
        s.filtered = read_filtered_table(path)
        return s

    def _count(self, stage: str, **counts) -> None:
        c = StageCounters(stage, {k: int(v) for k, v in counts.items()})
        self.counters.append(c)
        c.log(self.logger)

    def _run_with_sized_bounds(self, run: Callable):
        """``run(max_groups, max_baselines)`` -> (result, overflow, frames,
        valid): run with the corrector's default bounds and, when they
        overflow, once more on the same device with bounds sized to the
        masked rows' own counts (``correct_bounds``).  Returns the result."""
        result, overflow, frames, valid = run(MAX_GROUPS, MAX_BASELINES_PER_GROUP)
        if bool(overflow):
            n_groups, n_baselines = correct_bounds(frames, valid)
            self.logger.info("%d sweep groups, up to %d baselines in one: rerunning the "
                             "corrector with bounds sized to them", n_groups, n_baselines)
            result, overflow, _, _ = run(max(n_groups, MAX_GROUPS),
                                         max(n_baselines, MAX_BASELINES_PER_GROUP))
            if bool(overflow):
                raise RuntimeError("the corrector overflowed bounds sized to the data")
        return result

    # -- stages --------------------------------------------------------------

    def correct(self, engine: str = "device", device=None) -> np.ndarray:
        """Correct + filter the decoded frames: ``engine="device"`` with
        ``correct_rows`` on ``device`` (None: CUDA, kernel K2), whatever the
        group and baseline counts; ``engine="host"`` with the numpy host
        engine.  Both give the same ``corrected_bs`` for every row and the
        same ``filtered``."""
        if engine not in ("device", "host"):
            raise ValueError(f"unknown engine {engine!r}; use 'device' or 'host'")
        if self.frames is None:
            raise ValueError("no decoded frames; load a log or Parsed xlsx first")
        t0 = time.perf_counter()
        if engine == "host":
            res = correct_frames_np(self.frames, self.config.correct)
            self.timings["correct"] = time.perf_counter() - t0
            self.filtered = res.filtered   # the setter drops the sweep memo
            self.corrected_bs = res.corrected_bs
            self._count("correct", groups=res.n_groups, baselines=res.n_baselines,
                        corrected=res.keep.sum(), rows=len(self.frames))
            return self.filtered
        dev = resolve_device(device)
        host = np.asarray(self.frames, dtype=np.int64)
        if host.size and (host.min() < -(1 << 31) or host.max() >= 1 << 31):
            raise ValueError("frame values outside int32; use correct(engine='host')")
        frames = torch.from_numpy(host).to(dev, torch.int32)
        valid = torch.ones(len(host), dtype=torch.bool, device=dev)

        def run(max_groups, max_baselines):
            corrected, keep, overflow = correct_rows(frames, valid, max_groups, max_baselines,
                                                     self.config.correct)
            return (corrected, keep), overflow, frames, valid

        corrected, keep = self._run_with_sized_bounds(run)
        n_groups, n_baselines = group_counts(frames, valid)
        corrected = corrected.cpu().numpy().astype(np.int64)
        keep = keep.cpu().numpy()
        self.timings["correct"] = time.perf_counter() - t0
        self.filtered = np.stack([host[keep, 1], corrected[keep], host[keep, 3], host[keep, 4]],
                                 axis=1)
        self.corrected_bs = corrected
        self._count("correct", groups=n_groups, baselines=n_baselines, corrected=keep.sum(),
                    rows=len(host))
        return self.filtered

    def _grid(self, scene_cfg: SceneConfig, source: str, dev: torch.device) -> IntensityGrid:
        """The mean-RSS grid of the filtered rows (correcting first where
        there are none) or of the decoded frames, as tensors on ``dev``."""
        if source == "filtered":
            if self.filtered is None:
                self.correct(device=dev)
            cols, flag = self.filtered[:, :3], None
        elif source == "parsed":
            if self.frames is None:
                raise ValueError("no decoded frames")
            cols, flag = self.frames[:, 1:4], torch.from_numpy(self.frames[:, 0]).to(dev)
        else:
            raise ValueError(f"unknown source {source!r}")
        ue, bs, rss = (torch.from_numpy(np.ascontiguousarray(cols[:, i])).to(dev)
                       for i in range(3))
        valid = torch.ones(len(cols), dtype=torch.bool, device=dev)
        return intensity_grid(ue, bs, rss, valid, flag, cfg=scene_cfg)

    def intensity(self, scene_cfg: Optional[SceneConfig] = None, source: str = "filtered",
                  device=None) -> IntensityGrid:
        """The mean-RSS grid of the filtered rows (``source="filtered"``) or
        of the decoded frames (``"parsed"``, with ``scene_cfg.flag_filter``
        read against FLAG), built on ``device`` (None: CUDA) and returned
        as numpy: f32 means with NaN empties, i32 counts, the row / column
        masks and the min observed mean."""
        dev = resolve_device(device)
        t0 = time.perf_counter()
        grid = self._grid(scene_cfg or self.config.scene, source, dev)
        out = IntensityGrid(*(x.cpu().numpy() for x in grid))
        self.timings["scene"] = time.perf_counter() - t0
        return out

    def render_heatmap(self, angle_file: Union[str, Path],
                       output_path: Optional[Union[str, Path]] = None,
                       scene_cfg: Optional[SceneConfig] = None,
                       render_cfg: Optional[RenderConfig] = None, source: str = "filtered",
                       title: Optional[str] = None, axes_rect=None,
                       device=None) -> RenderedHeatmap:
        """The AoD x AoA heatmap raster of ``intensity``'s grid, on
        ``device`` (None: CUDA, kernel K3), and with ``output_path`` its PNG
        (which needs matplotlib)."""
        dev = resolve_device(device)
        scene_cfg = scene_cfg or SceneConfig(keep_nan=True, fill_with_min=False)
        render_cfg = render_cfg or self.config.render
        lut = load_angle_lut(angle_file)
        t0 = time.perf_counter()
        grid = self._grid(scene_cfg, source, dev)
        self.timings["scene"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rendered = render_intensity(grid, lut, scene_cfg, render_cfg)
        self.timings["render"] = time.perf_counter() - t0
        if output_path is not None:
            save_heatmap(rendered, output_path,
                         title=title or f"BS-UE 波束对平均RSSI热力图 ({self.name})",
                         render_cfg=render_cfg, axes_rect=axes_rect)
            self.logger.info("heatmap saved: %s", output_path)
        return rendered

    def _sweep_ids(self, max_sweeps: Optional[int], device=None):
        if self.filtered is None:
            self.correct(device=device)
        gid = detect_groups_np(self.filtered[:, 0])
        return gid, max_sweeps or int(gid.max()) + 1

    def sweep_intensity(self, max_sweeps: Optional[int] = None, device=None):
        """Per-sweep (mean [S, 64, 64] f32 with NaN empties, counts i32), as
        numpy, built on ``device`` (None: CUDA) by kernel K4."""
        dev = resolve_device(device)
        gid, n_sweeps = self._sweep_ids(max_sweeps, dev)
        mean, counts = self._sweep_grids(gid, n_sweeps, dev)
        return mean.cpu().numpy(), counts.cpu().numpy()

    def _sweep_grids(self, gid: np.ndarray, n_sweeps: int, dev: torch.device):
        cols = [torch.from_numpy(np.asarray(c)).to(dev, torch.int32)
                for c in (self.filtered[:, 0], self.filtered[:, 1], self.filtered[:, 2], gid)]
        valid = torch.ones(len(self.filtered), dtype=torch.bool, device=dev)
        return intensity_per_sweep(*cols, valid, n_sweeps)

    def sweep_times(self, max_sweeps: Optional[int] = None, device=None) -> np.ndarray:
        """Per-sweep CLK anchors (the first kept frame's CLK), unwrapped
        across 30-bit counter wraps; -1 for sweeps with no rows.  Frames not
        yet corrected are corrected on ``device`` (None: CUDA)."""
        gid, n_sweeps = self._sweep_ids(max_sweeps, device)
        times = np.full(n_sweeps, -1, dtype=np.int64)
        first_gid, first_row = np.unique(gid, return_index=True)
        inside = first_gid < n_sweeps
        times[first_gid[inside]] = self.filtered[first_row[inside], 3]
        return unwrap_clk_anchors(times, self.logger)

    def _sweep_host_prep(self, angle_file: Union[str, Path], estimator: str = "nn_omp",
                         max_sweeps: Optional[int] = None, beam_ids=None, device=None,
                         **overrides):
        """Host prep for per-sweep estimation, memoized per (angle file,
        estimator, max_sweeps, beam ids, overrides, filtered generation):
        sweep ids, the compact beam ids, the float64 dictionary and the
        estimator key.  The beam ids are the session's observed and mapped
        beams, or ``beam_ids = (ue_ids, bs_ids)`` used verbatim for the
        submatrix and the dictionary (how a stream that fixed its beam set
        up front is compared with the offline result).  Frames not yet
        corrected are corrected on ``device``."""
        if self.filtered is None:
            self.correct(device=device)
        if beam_ids is not None:
            beam_ids = tuple(tuple(int(i) for i in ids) for ids in beam_ids)
        memo_key = (str(angle_file), estimator, max_sweeps, beam_ids,
                    tuple(sorted(overrides.items())), self._filtered_gen)
        if memo_key in self._sweep_prep_memo:
            return self._sweep_prep_memo[memo_key]
        gid, n_sweeps = self._sweep_ids(max_sweeps, device)
        lut = load_angle_lut(angle_file)
        if beam_ids is not None:
            ue_ids = np.asarray(beam_ids[0], dtype=np.int64)
            bs_ids = np.asarray(beam_ids[1], dtype=np.int64)
        else:
            grid = intensity_grid_np(self.filtered[:, 0], self.filtered[:, 1],
                                     self.filtered[:, 2], cfg=SceneConfig())
            ue_ids = np.nonzero(np.asarray(grid.row_mask) & np.isfinite(lut))[0]
            bs_ids = np.nonzero(np.asarray(grid.col_mask) & np.isfinite(lut))[0]
        d, est_key = sweep_estimator_setup(estimator, lut[ue_ids], lut[bs_ids], **overrides)
        result = (gid, n_sweeps, ue_ids, bs_ids, d, est_key)
        self._sweep_prep_memo[memo_key] = result
        return result

    def _sweep_estimation_inputs(self, angle_file: Union[str, Path], estimator: str,
                                 max_sweeps: Optional[int], dev: torch.device, beam_ids=None,
                                 pad_to=None, **overrides):
        """(sub [S, U, B] f32 on ``dev``, NaN where unobserved; the session
        dictionary as tensors on ``dev`` (``estimator_dictionary``'s
        dtypes); est_key; n_sweeps), memoized beside the host prep.

        With ``pad_to = (S, U, B, Ga, Gd)`` every axis is padded to that
        common shape: NaN measurement cells (sweeps past the session's and
        beams past its own), zero phi rows (beams) and columns (atoms), and
        the grids' last angle repeated.  Padded beams add exact zeros to
        every correlation, Gram entry and right-hand side, and padded atoms
        have a correlation of exactly 0 (``models/batch_estimation``'s
        argument), so the real sweeps' paths are those of the unpadded
        inputs.  One corner: with ``stop_nonpositive=False`` (the per-sweep
        default) a padded atom could win NN-OMP's argmax where every real
        correlation is negative; its coefficient refits to 0, so it is
        never a valid path, but ``n_iters`` counts it.
        """
        gid, n_sweeps, ue_ids, bs_ids, d, est_key = self._sweep_host_prep(
            angle_file, estimator, max_sweeps, beam_ids, dev, **overrides)
        memo_key = ("inputs", str(dev), str(angle_file), estimator, max_sweeps,
                    tuple(ue_ids.tolist()), tuple(bs_ids.tolist()), pad_to,
                    tuple(sorted(overrides.items())), self._filtered_gen)
        if memo_key in self._sweep_prep_memo:
            return self._sweep_prep_memo[memo_key]
        d = estimator_dictionary(est_key, d)
        ue_idx, bs_idx = ue_ids, bs_ids
        s_alloc = n_sweeps
        if pad_to is not None:
            s_alloc, u_max, b_max, ga_max, gd_max = pad_to
            nb = self.config.scene.n_beams
            # Index nb is a NaN row / column appended below.
            ue_idx = np.pad(ue_ids, (0, u_max - len(ue_ids)), constant_values=nb)
            bs_idx = np.pad(bs_ids, (0, b_max - len(bs_ids)), constant_values=nb)
            ga, gd = len(d.aoa_grid), len(d.aod_grid)
            d = BeamDictionary(
                aoa_grid=np.pad(d.aoa_grid, (0, ga_max - ga), mode="edge"),
                aod_grid=np.pad(d.aod_grid, (0, gd_max - gd), mode="edge"),
                phi_rx=np.pad(d.phi_rx, ((0, u_max - len(ue_ids)), (0, ga_max - ga))),
                phi_tx=np.pad(d.phi_tx, ((0, b_max - len(bs_ids)), (0, gd_max - gd))))
        mean, _ = self._sweep_grids(gid, s_alloc, dev)
        if pad_to is not None:
            mean = torch.nn.functional.pad(mean, (0, 1, 0, 1), value=float("nan"))
        sub = (mean.index_select(1, torch.from_numpy(ue_idx).to(dev))
               .index_select(2, torch.from_numpy(bs_idx).to(dev)))
        result = (sub, BeamDictionary(*(torch.from_numpy(x).to(dev) for x in d)), est_key,
                  n_sweeps)
        self._sweep_prep_memo[memo_key] = result
        return result

    def _sweep_estimate_shards(self, angle_file, estimator, max_sweeps, rows, beam_ids=None,
                               pad_to=None, **overrides):
        """([(paths, sweep_valid) per data shard], n_sweeps): the per-sweep
        grids and the compact tensor on the first row's device, the sweeps
        padded with all-NaN sweeps (valid False, dropped by the callers) to
        a multiple of the row count, and each shard's estimator on its row's
        first device: a row of one device runs ``sweep_program`` (a CUDA
        graph per shape on the card; each call's outputs its own), a row of
        several NN-OMP's AoA grid over them, eagerly
        (``sweep_estimator_body``'s ``model_devices``: every iteration
        crosses the row's devices)."""
        sub, d, est_key, n_sweeps = self._sweep_estimation_inputs(
            angle_file, estimator, max_sweeps, rows[0][0], beam_ids, pad_to, **overrides)
        s_pad, per = shard_rows(sub.shape[0], len(rows))
        if s_pad > sub.shape[0]:
            sub = torch.cat([sub, sub.new_full((s_pad - sub.shape[0],) + sub.shape[1:],
                                               float("nan"))])
        outs = []
        for r, devs in enumerate(rows):
            args = (sub[r * per:(r + 1) * per].to(devs[0]),
                    *(x.to(devs[0]) for x in (d.phi_rx, d.phi_tx, d.aoa_grid, d.aod_grid)))
            if len(devs) == 1:
                outs.append(sweep_program(est_key, devs[0])(*args))
            else:
                outs.append(sweep_estimator_body(est_key)(*args, model_devices=devs))
        return outs, n_sweeps

    def sweep_paths(self, angle_file: Union[str, Path], estimator: str = "nn_omp",
                    max_sweeps: Optional[int] = None, device=None, beam_ids=None, mesh=None,
                    **overrides):
        """Per-sweep multipath estimation on ``device`` (None: CUDA) or over
        ``mesh``, with ``estimator`` "nn_omp" or "sm_sic".

        Returns (paths, sweep_valid) as numpy: ``paths`` an OmpPaths of [S,
        K] arrays (f32 angles and power, bool valid, i32 indices; n_iters
        [S] i32) or an SmSicPaths (f32 angles and metric, bool valid and
        is_los), ``sweep_valid[s]`` False for sweeps with no observed cell
        in the compact submatrix.  ``beam_ids = (ue_ids, bs_ids)`` fixes the
        beam set (see ``_sweep_host_prep``).  With ``mesh`` the sweeps shard
        over ``data`` and NN-OMP's AoA grid over ``model``
        (``_sweep_estimate_shards``); each shard is read back once, and the
        results equal ``mesh=None``'s.
        """
        shards, n_sweeps = self._sweep_estimate_shards(angle_file, estimator, max_sweeps,
                                                       placement(mesh, device), beam_ids,
                                                       **overrides)
        host = read_per_device([(*out, valid) for out, valid in shards])
        fields = [np.concatenate(fs)[:n_sweeps] for fs in zip(*host)]
        return type(shards[0][0])(*fields[:-1]), fields[-1]

    def path_tracks(self, angle_file: Union[str, Path], estimator: str = "nn_omp",
                    max_tracks: int = 8, gate_deg: float = 10.0, engine: str = "device",
                    device=None, **overrides):
        """CLK-anchored multipath tracks: ``sweep_paths`` on ``device``
        (None: CUDA), each sweep anchored on its first kept frame's CLK
        (``sweep_times``), paths associated across sweeps into tracks with
        per-track angular-velocity fits (deg per CLK tick).  A path's power
        is NN-OMP's coefficient or SM-SIC's metric.

        ``engine`` picks the association: "device" (the default:
        ``models/tracking.track_program`` on ``device``, read back once; a
        CUDA graph around kernel K6 on the card) or
        "host" (``track_paths_np``, numpy); both give the same tracks.  Returns (tracks, times,
        (vel_aoa, vel_aod, vel_ok)) as numpy.
        """
        if engine not in ("host", "device"):
            raise ValueError(f"unknown engine {engine!r}; use 'host' or 'device'")
        paths, sweep_valid = self.sweep_paths(angle_file, estimator=estimator, device=device,
                                              **overrides)
        times = self.sweep_times(len(sweep_valid), device)
        valid = np.asarray(paths.valid, bool) & sweep_valid[:, None] & (times >= 0)[:, None]
        power = path_power(paths)
        if engine == "device":
            t = track_program(max_tracks, gate_deg, device).host(paths.aoa, paths.aod, power,
                                                                 valid)
            tracks = Tracks(*t[:5], int(t.n_tracks))
        else:
            tracks = track_paths_np(paths.aoa, paths.aod, power, valid,
                                    max_tracks=max_tracks, gate_deg=gate_deg)
        return tracks, times, track_velocities(tracks, times)

    def scene_changes(self, angle_file: Union[str, Path], min_persist: int = 3,
                      min_gone: int = 3, jump_deg: float = 5.0, **track_kwargs):
        """Scene change events from the CLK-anchored tracks
        (``models/change_detection.py``): path births and deaths, angular
        jumps and LoS handovers, each stamped with its sweep's CLK time.
        ``track_kwargs`` go to ``path_tracks`` (``device`` among them,
        None: CUDA).  Returns (events [N, 7] float64, tracks, times)."""
        from slam_process_tpu_torch.models.change_detection import (
            detect_scene_changes_np, scene_change_events)

        tracks, times, _vel = self.path_tracks(angle_file, **track_kwargs)
        changes = detect_scene_changes_np(tracks, min_persist=min_persist, min_gone=min_gone,
                                          jump_deg=jump_deg)
        return scene_change_events(changes, tracks, times), tracks, times

    # -- export --------------------------------------------------------------

    def export_parsed(self, path: Union[str, Path]) -> Path:
        """Write the decoded frames in the v3 Parsed schema."""
        return write_parsed_table(path, self.frames)

    def export_filtered(self, path: Union[str, Path], device=None) -> Path:
        """Write the filtered rows (corrected on ``device`` first where there
        are none) in the filtered schema."""
        if self.filtered is None:
            self.correct(device=device)
        return write_filtered_table(path, self.filtered)

    def export_corrected(self, path: Union[str, Path], device=None) -> Path:
        """The in-place export: the five Parsed columns plus a
        Corrected_BS_Beam column for every row (corrected on ``device``
        first where it is not yet)."""
        if self.corrected_bs is None:
            self.correct(device=device)
        table = np.concatenate([self.frames, self.corrected_bs[:, None]], axis=1)
        return write_xlsx_table(path, PARSED_COLUMNS + ["Corrected_BS_Beam"], table)

    def save_npz(self, path: Union[str, Path]) -> Path:
        """The frames and filtered rows, where present, as a compressed npz."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        arrays = {}
        if self.frames is not None:
            arrays["frames"] = self.frames
        if self.filtered is not None:
            arrays["filtered"] = self.filtered
        np.savez_compressed(path, **arrays)
        return path

    @classmethod
    def load_npz(cls, path: Union[str, Path]) -> "Session":
        """A session of the arrays ``save_npz`` wrote."""
        s = cls(name=Path(path).stem)
        with np.load(path) as z:
            if "frames" in z:
                s.frames = z["frames"]
            if "filtered" in z:
                s.filtered = z["filtered"]
        return s


def sweep_paths_dataset(sessions, angle_file: Union[str, Path], estimator: str = "nn_omp",
                        mesh=None, device=None, **overrides):
    """Per-sweep estimation for many sessions on ``device`` (None: CUDA) or
    over ``mesh``.

    Every session's per-sweep tensor and dictionary is padded to the
    dataset-common (U, B, Ga, Gd) (``Session._sweep_estimation_inputs``'s
    ``pad_to``, whose argument keeps each real sweep's paths those of the
    session alone), and its sweep axis to its ``sweep_bucket`` (all-NaN
    sweeps, dropped), so the sessions of one bucket replay one compiled
    program.  The estimators are queued session after session, each
    call's outputs its own, and the results of all of them cross to the
    host in one read per device.  With ``mesh`` each
    session's sweeps shard over ``data`` (padded to a multiple of it) and
    NN-OMP's AoA grid over ``model``, as in ``Session.sweep_paths``.
    Returns a list of (paths, sweep_valid) per session, equal to each
    session's ``sweep_paths`` (and to ``mesh=None``).
    """
    rows = placement(mesh, device)
    dev = rows[0][0]
    preps = [s._sweep_host_prep(angle_file, estimator, device=dev, **overrides)
             for s in sessions]
    if not preps:
        return []
    u_max = max(len(p[2]) for p in preps)
    b_max = max(len(p[3]) for p in preps)
    ga_max = max(len(p[4].aoa_grid) for p in preps)
    gd_max = max(len(p[4].aod_grid) for p in preps)
    est_key = preps[0][5]
    outs, counts = [], []
    for s, prep in zip(sessions, preps):
        if prep[5] != est_key:
            raise ValueError("the sessions' estimator settings differ")
        pad_to = (sweep_bucket(prep[1]), u_max, b_max, ga_max, gd_max)
        shards, n_sweeps = s._sweep_estimate_shards(angle_file, estimator, None, rows,
                                                    pad_to=pad_to, **overrides)
        outs += [(*out, valid) for out, valid in shards]
        counts.append((len(shards), n_sweeps, type(shards[0][0])))
    host = read_per_device(outs)
    results, at = [], 0
    for n_shards, n_sweeps, paths_t in counts:
        fields = [np.concatenate(fs)[:n_sweeps] for fs in zip(*host[at:at + n_shards])]
        results.append((paths_t(*fields[:-1]), fields[-1]))
        at += n_shards
    return results
