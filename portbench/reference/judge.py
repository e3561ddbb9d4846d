"""The comparison that decides ``correct``, and the work the reference counts.

Each function returns ``[(name, value, limit), ...]``: a run is correct
where every value is at most its limit.  Exact comparisons count what
differs and have the limit 0.  The limits of the float comparisons are
the workload's (``limits`` in ``portbench/workloads/<cell>.json``), set
from the readings ``PERF.md`` gives.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import paths as P
from portbench.reference.pipeline import LogRef, mean_grid, raster


def _gap(a: np.ndarray, b: np.ndarray, rel: bool) -> float:
    """Widest gap of ``a`` from ``b`` over the cells finite in ``b``
    (relative to |b| with ``rel``); inf where the two disagree on which
    cells are finite."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    fa, fb = np.isfinite(a), np.isfinite(b)
    if not np.array_equal(fa, fb):
        return math.inf
    if not fb.any():
        return 0.0
    d = np.abs(a[fb] - b[fb])
    if rel:
        d = d / np.maximum(np.abs(b[fb]), 1e-300)
    return float(d.max())


def raster_refs(refs: Sequence[LogRef], sigma: float, dtype=torch.float64):
    """(mean [L, 64, 64] UE-major, rgba [L, 64, 64, 4], norm_t [L, 64, 64])
    of the logs, every float step in ``dtype``; the raster is in AoD x AoA
    orientation (BS rows)."""
    means = torch.stack([mean_grid(r.sums, r.counts, dtype) for r in refs])
    rgba, norm_t, _ = raster(means.transpose(-1, -2), sigma, dtype)
    return means.double().numpy(), rgba.double().numpy(), norm_t.double().numpy()


def offline(cfg: dict, limits: dict, refs: List[List[LogRef]], outs) -> list:
    """``outs``: [(campaign, [per-log summaries with numpy fields n_frames,
    correct_overflow, n_kept, mean_grid, counts, rgba, norm_t])]."""
    sigma = cfg["pipeline"]["blur_sigma"]
    ras = [raster_refs(r, sigma) for r in refs]
    frames_off = kept_off = cells_off = rgba_off = cells = 0
    mean_gap = norm_gap = 0.0
    for c, job in outs:
        means, rgba, norm_t = ras[c]
        for i, (o, r) in enumerate(zip(job, refs[c])):
            frames_off += int(o.n_frames) != r.n_frames
            kept_off += int(o.n_kept) != r.n_kept or bool(o.correct_overflow) != r.overflow
            cells_off += int((np.asarray(o.counts) != r.counts).sum())
            mean_gap = max(mean_gap, _gap(o.mean_grid, means[i], rel=True))
            norm_gap = max(norm_gap, _gap(o.norm_t, norm_t[i], rel=False))
            ref_rgba = rgba[i].astype(np.float32)
            rgba_off += int(np.any(np.asarray(o.rgba) != ref_rgba, axis=-1).sum())
            cells += ref_rgba.shape[0] * ref_rgba.shape[1]
    return [("logs_frames_off", frames_off, 0), ("logs_kept_off", kept_off, 0),
            ("cells_counts_off", cells_off, 0),
            ("mean_rel_gap", mean_gap, limits["mean_rel_gap"]),
            ("norm_t_gap", norm_gap, limits["norm_t_gap"]),
            ("rgba_cells_off_share", rgba_off / max(cells, 1), limits["rgba_cells_off_share"])]


def _variants(records: list) -> Dict[int, list]:
    """{log: [(record, [records equal to it]), ...]}: the distinct outputs
    of each log, each judged once."""
    out: Dict[int, list] = {}
    for rec in records:
        groups = out.setdefault(rec["log"], [])
        for first, same in groups:
            if _equal(first, rec):
                same.append(rec)
                break
        else:
            groups.append((rec, [rec]))
    return out


def _equal(a: dict, b: dict) -> bool:
    for k, v in a.items():
        w = b.get(k)
        if isinstance(v, np.ndarray) or isinstance(w, np.ndarray):
            if not np.array_equal(np.asarray(v), np.asarray(w), equal_nan=True):
                return False
        elif v != w:
            return False
    return True


def live(cfg: dict, limits: dict, refs: List[LogRef], records: list, device="cpu") -> list:
    """``records``: one dict per completed log replay: ``log``, ``n_frames``,
    ``n_kept``, ``n_groups``, ``overflow``, ``sums``, ``counts`` and, with
    the paths, ``aoa``, ``aod``, ``power``, ``valid``, ``n_iters``,
    ``aoa_idx``, ``aod_idx`` [n, K], ``sweep_valid`` [n], ``trk_*`` and
    ``times``.  Returns (checks, {log: (NNLS outer steps, solves) of its
    sweeps' refits}), the latter for K7's count."""
    logs_off = cells_off = sweeps_off = tracks_off = 0
    corr_gap = power_gap = angle_gap = 0.0
    paths_on = bool(records) and "aoa" in records[0]
    pc = cfg["paths"]
    d = sweeps = None
    if paths_on:
        d = P.dictionary(np.linspace(*cfg["angles_deg"]), pc["grid_res"], pc["beam_width"],
                         device=device)
        sweeps = {}
    work = {}
    for log, groups in sorted(_variants(records).items()):
        r = refs[log]
        for rec, same in groups:
            n = len(same)
            logs_off += n * (rec["n_frames"] != r.n_frames or rec["n_kept"] != r.n_kept
                             or rec["n_groups"] != r.corr.n_groups
                             or bool(rec["overflow"]) != r.overflow)
            cells_off += n * int((rec["sums"] != r.sums).sum() + (rec["counts"] != r.counts).sum())
            if not paths_on:
                continue
            if log not in sweeps:
                sweeps[log] = P.sweeps_of(r)
            sw = sweeps[log]
            m = len(sw.times)
            if (len(rec["n_iters"]) != m or not np.all(rec["sweep_valid"])
                    or not np.array_equal(rec["times"], P.unwrap_clk(sw.times))):
                sweeps_off += n
                continue
            scenes = P.filled_scenes(sw.sums, sw.counts, torch.float64, device)
            j = P.judge_sweeps(d, scenes, rec["aoa_idx"], rec["aod_idx"], rec["n_iters"],
                               rec["power"], rec["aoa"], rec["aod"], pc["max_paths"])
            corr_gap = max(corr_gap, j.corr_gap)
            power_gap = max(power_gap, j.power_gap)
            angle_gap = max(angle_gap, j.angle_gap)
            work.setdefault(log, (j.outer, j.solves))
            t = P.track(rec["aoa"], rec["aod"], rec["power"],
                        np.asarray(rec["valid"]) & np.asarray(rec["sweep_valid"])[:, None],
                        pc["max_tracks"], pc["gate_deg"])
            ok = (np.array_equal(t.aoa, rec["trk_aoa"]) and np.array_equal(t.aod, rec["trk_aod"])
                  and np.array_equal(t.power, rec["trk_pow"])
                  and np.array_equal(t.observed, rec["trk_obs"])
                  and np.array_equal(t.created, rec["trk_created"])
                  and t.count == rec["trk_count"])
            tracks_off += n * (not ok)
    out = [("logs_off", logs_off, 0), ("cells_off", cells_off, 0)]
    if paths_on:
        out += [("sweeps_off", sweeps_off, 0), ("tracks_off", tracks_off, 0),
                ("corr_gap", corr_gap, limits["corr_gap"]),
                ("power_gap", power_gap, limits["power_gap"]),
                ("angle_gap", angle_gap, limits["angle_gap"])]
    return out, work


def log_work(refs: Sequence[LogRef]) -> dict:
    """The work a campaign's logs need, summed: what the kernels' counts
    (``portbench/counts``) read."""
    tot = dict(bytes=0, flags=0, frames=0, kept=0, k2_candidates=0, k2_steps=0, baselines=0)
    for r in refs:
        tot["bytes"] += r.n_bytes
        tot["flags"] += r.n_flags
        tot["frames"] += r.n_frames
        tot["kept"] += r.n_kept
        tot["k2_candidates"] += int(r.corr.candidates.sum())
        tot["k2_steps"] += int(search_steps(r.corr.group_baselines).sum())
        tot["baselines"] += r.corr.n_baselines
    return tot


def search_steps(group_baselines: np.ndarray) -> np.ndarray:
    """Per row, 2 ceil(log2(n + 1)) compares to find its arc's two ends
    among its group's n sorted baseline residues."""
    return 2 * np.ceil(np.log2(np.asarray(group_baselines, np.float64) + 1)).astype(np.int64)
