"""Geometric-LoS estimator (host only, as in the JAX package).

The port of ``slam_process_tpu/models/geometric.py``.  The rows' angles
from the table and their RSS in dB, each (AoA, AoD) pair's first row (in
row order, its own RSS, not a mean), the pairs with an unmapped beam
dropped; a bicubic spline onto a 0.1 deg grid padded by 5 deg (clamped to
the samples' hull), normalised to its maximum; ``scipy.signal.find_peaks``
over the flattened grid (height -20 dB, distance 10).  A peak is the LoS
where it holds the global maximum and lies within 5 deg of the geometric
angle ``atan2(ue - bs)`` when node positions are given (the shipped angle
table has none; without them the maximum is the LoS).

There is no device engine in either package: the work is a few scipy calls
over the grid.  ``engine="device"`` gives the JAX package's
``RuntimeWarning`` and runs the host body, as the reference does.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np

from slam_process_tpu_torch.io.angles import load_angle_lut
from slam_process_tpu_torch.models.registry import Table, session_rows
from slam_process_tpu_torch.ops.interp import bicubic_spline_resample


def geometric_los_angle(bs_xy: Tuple[float, float], ue_xy: Tuple[float, float]) -> float:
    return float(np.degrees(np.arctan2(ue_xy[1] - bs_xy[1], ue_xy[0] - bs_xy[0])))


def identify_paths(rss_grid, AOA, AOD, los_aoa: Optional[float], los_aod: Optional[float],
                   thresh: float = -20.0) -> Table:
    """find_peaks over the flattened grid and the geometric match: the
    table (AoA, AoD, Power_dB, Type), no columns where there is no peak."""
    from scipy.signal import find_peaks

    flat = np.nan_to_num(rss_grid.ravel(), nan=-1e9)
    peaks, _ = find_peaks(flat, height=thresh, distance=10)
    if len(peaks) == 0:
        return Table({})
    i, j = np.unravel_index(peaks, rss_grid.shape)
    aoa, aod, power = AOA[i, 0], AOD[0, j], rss_grid[i, j]
    if los_aoa is None:
        geo_ok = np.ones(len(peaks), dtype=bool)
    else:
        geo_ok = (np.abs(aoa - los_aoa) < 5) & (np.abs(aod - los_aod) < 5)
    is_los = (power == np.nanmax(rss_grid)) & geo_ok
    return Table({"AoA": aoa.astype(np.float64), "AoD": aod.astype(np.float64),
                  "Power_dB": power.astype(np.float64),
                  "Type": np.where(is_los, "LoS", "NLoS").tolist()})


def run_geometric(session, angle_file, output_path=None, bs_xy=None, ue_xy=None,
                  **overrides) -> Table:
    """The ``geometric`` entry (host numpy / scipy): the peaks table; with
    ``output_path`` the figure (needs matplotlib)."""
    if overrides.get("engine", "device") != "host":
        # The JAX package's warning, word for word: the caller asked for a
        # device run that neither package has.
        warnings.warn(
            "geometric estimator has no device engine (microsecond-scale "
            "scipy find_peaks work); running on host", RuntimeWarning,
            stacklevel=2)
    ue, bs, rss = session_rows(session, overrides.get("device"))
    lut = load_angle_lut(angle_file)
    aoa_r = lut[np.asarray(ue, dtype=np.int64)]
    aod_r = lut[np.asarray(bs, dtype=np.int64)]
    rss_db = 10 * np.log10(np.asarray(rss) * 1.0 + 1e-6)
    # drop_duplicates(subset=["AoA", "AoD"]) then dropna: each mapped
    # pair's first row, in row order.
    mapped = np.nonzero(~(np.isnan(aoa_r) | np.isnan(aod_r)))[0]
    _, first = np.unique(np.stack([aoa_r[mapped], aod_r[mapped]], axis=1), axis=0,
                         return_index=True)
    rows = mapped[np.sort(first)]
    aoa, aod, rss_db = aoa_r[rows], aod_r[rows], rss_db[rows]

    res = overrides.get("resolution", 0.1)
    aoa_grid = np.arange(aoa.min() - 5, aoa.max() + 5, res)
    aod_grid = np.arange(aod.min() - 5, aod.max() + 5, res)
    ua = np.unique(aoa)
    ub = np.unique(aod)
    mat = np.full((len(ua), len(ub)), np.nan)
    mat[np.searchsorted(ua, aoa), np.searchsorted(ub, aod)] = rss_db
    if np.isnan(mat).any():
        from scipy.interpolate import griddata

        yy, xx = np.meshgrid(ua, ub, indexing="ij")
        fin = ~np.isnan(mat)
        mat = griddata(np.stack([yy[fin], xx[fin]], 1), mat[fin], (yy, xx), method="nearest")
    # The padded (+-5 deg) region clamped to the samples' hull.
    aoa_q = np.clip(aoa_grid, ua.min(), ua.max())
    aod_q = np.clip(aod_grid, ub.min(), ub.max())
    grid = np.asarray(bicubic_spline_resample(mat, ub, ua, aod_q, aoa_q))
    grid -= np.nanmax(grid)

    AOA, AOD = np.meshgrid(aoa_grid, aod_grid, indexing="ij")
    if bs_xy is not None and ue_xy is not None:
        los_aoa = los_aod = geometric_los_angle(bs_xy, ue_xy)
    else:
        los_aoa = los_aod = None
    paths = identify_paths(grid, AOA, AOD, los_aoa, los_aod, overrides.get("thresh", -20.0))
    if output_path is not None:
        from slam_process_tpu_torch.render.estimators import plot_geometric

        plot_geometric(AOA, AOD, grid, paths, output_path)
    return paths
