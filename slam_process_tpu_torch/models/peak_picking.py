"""Peak-picking estimator.

The port of ``slam_process_tpu/models/peak_picking.py``.  The pair means
(UE, BS), their angles from the table (pairs with an unmapped beam dropped
after the mean), a separable bicubic spline onto a 1.4 deg grid with the
holes filled by the nearest sample and the cells outside the samples' hull
zeroed (``build_heatmap_grid``, host float64), then the 3 x 3 local maxima
above the 90th percentile: the strongest is the LoS, up to three more
within 8 dB are NLoS.

``engine="device"`` takes the percentile and the local-max mask on the
card (``ops/peaks``, float64; ``peak_program``, a CUDA graph per shape) and
reads back only the mask; the peaks'
values come from the host grid, as in the JAX package's device engine.
``engine="host"`` is numpy / scipy.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_process_tpu_torch.io.angles import load_angle_lut
from slam_process_tpu_torch.models.registry import Table, pair_means, session_rows
from slam_process_tpu_torch.ops.interp import bicubic_spline_resample
from slam_process_tpu_torch.ops.peaks import local_max_mask, percentile
from slam_process_tpu_torch.utils.graphs import GraphProgram, program_cache


def mapped_pair_means(session, angle_file, device=None):
    """(AoA, AoD, mean RSS) of the session's (UE, BS) pairs in pandas'
    group order, the pairs with an unmapped beam dropped after the mean;
    the angles are the table's float32."""
    ue_k, bs_k, means = pair_means(*session_rows(session, device))
    lut = load_angle_lut(angle_file)
    aoa, aod = lut[ue_k], lut[bs_k]
    keep = ~(np.isnan(aoa) | np.isnan(aod))
    return aoa[keep], aod[keep], means[keep]


def build_heatmap_grid(aoa, aod, rss, resolution: float = 1.4):
    """Aggregated samples -> (aod_grid, aoa_grid, heat [len(aoa_grid),
    len(aod_grid)]) on the host."""
    aod_grid = np.arange(aod.min(), aod.max() + resolution, resolution)
    aoa_grid = np.arange(aoa.min(), aoa.max() + resolution, resolution)
    ua = np.unique(aoa)
    ub = np.unique(aod)
    mat = np.full((len(ua), len(ub)), np.nan)
    mat[np.searchsorted(ua, aoa), np.searchsorted(ub, aod)] = rss
    if np.isnan(mat).any():   # holes: the nearest finite sample
        from scipy.interpolate import griddata

        yy, xx = np.meshgrid(ua, ub, indexing="ij")
        pts = np.stack([yy[~np.isnan(mat)], xx[~np.isnan(mat)]], axis=1)
        mat = griddata(pts, mat[~np.isnan(mat)], (yy, xx), method="nearest")
    heat = np.asarray(bicubic_spline_resample(mat, ub, ua, aod_grid, aoa_grid))
    # The reference's griddata leaves NaN (then 0) outside the samples'
    # hull, where the spline would extrapolate.
    outside = ((aoa_grid[:, None] < ua.min()) | (aoa_grid[:, None] > ua.max())
               | (aod_grid[None, :] < ub.min()) | (aod_grid[None, :] > ub.max()))
    heat = np.where(outside, 0.0, heat)
    return aod_grid, aoa_grid, np.nan_to_num(heat, nan=0.0)


def detect_peaks(heat, aod_grid, aoa_grid, threshold):
    """(aod, aoa, power) of the 3 x 3 local maxima above ``threshold``, in
    row-major order."""
    mask = local_max_mask(heat, 3) & (heat > threshold)
    return [(float(aod_grid[j]), float(aoa_grid[i]), float(heat[i, j]))
            for i, j in np.argwhere(mask)]


def peak_mask_torch(heat: torch.Tensor, q: float) -> torch.Tensor:
    """The 3 x 3 local maxima above the q-th percentile, on ``heat``'s
    device."""
    return local_max_mask(heat, 3) & (heat > percentile(heat, q))


@program_cache(8)
def peak_program(q: float, device=None) -> GraphProgram:
    """``peak_mask_torch`` at one percentile as one compiled program on
    ``device`` (None: CUDA), the JAX package's jitted mask (peak_picking's
    device engine), called as ``fn(heat)``: on CUDA one graph per shape.
    JAX builds a fresh jitted function per call; the port keeps 8 programs
    of 8 shapes."""
    return GraphProgram(lambda heat: peak_mask_torch(heat, q), device, 8)


def run_peak_picking(session, angle_file, output_path=None, **overrides) -> Table:
    """The ``peak_picking`` entry: the table (AoD, AoA, Power, Type) of the
    LoS and its NLoS, no columns where no peak is found; with
    ``output_path`` the figure (needs matplotlib)."""
    engine = overrides.get("engine", "device")
    device = overrides.get("device")
    aoa, aod, rss = mapped_pair_means(session, angle_file, device)
    aod_grid, aoa_grid, heat = build_heatmap_grid(aoa, aod, rss,
                                                  resolution=overrides.get("resolution", 1.4))
    q = float(overrides.get("percentile", 90))
    if engine == "device":
        mask = peak_program(q, device).host(heat)
        peaks = [(float(aod_grid[j]), float(aoa_grid[i]), float(heat[i, j]))
                 for i, j in np.argwhere(mask)]
    elif engine == "host":
        peaks = detect_peaks(heat, aod_grid, aoa_grid, np.percentile(heat, q))
    else:
        raise ValueError(f"unknown engine {engine!r}; use 'device' or 'host'")
    peaks.sort(key=lambda p: -p[2])

    rows = []
    if peaks:
        los = peaks[0]
        rows.append((los[0], los[1], los[2], "LoS"))
        power_gap = overrides.get("power_gap", 8.0)
        max_nlos = overrides.get("max_nlos", 3)
        for aod_p, aoa_p, p in peaks[1:]:
            if p < los[2] - power_gap or len(rows) > max_nlos:
                break
            rows.append((aod_p, aoa_p, p, "NLoS"))
    out = Table({c: [r[k] for r in rows] if c == "Type" else np.array([r[k] for r in rows])
                 for k, c in enumerate(("AoD", "AoA", "Power", "Type"))} if rows else {})
    if output_path is not None:
        from slam_process_tpu_torch.render.estimators import plot_peak_picking

        plot_peak_picking(heat, aod_grid, aoa_grid, out, output_path)
    return out
