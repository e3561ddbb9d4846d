"""Scene assembly: frames -> per-session mean-RSS intensity grid.

A (UE, BS) cell mean is a segment mean over frames.  The sums are taken in
int64 with ``index_add_`` over the n_beams^2 cells (integer atomics on the
card, so the result does not depend on the order of the adds) and turned
into float32 at the end.  The JAX package's float32 one-hot einsum is exact
while cell sums stay below 2^24, so there the two agree bit for bit.

The pre-log scene (``SceneConfig.log_transform``: rows with RSS <= 0
dropped, ln(RSS) summed) cannot be summed in integers.  ln is taken in
float64 and summed in float64, and each mean is rounded to float32 once;
the counts stay integer.  On the card the float64 ``index_add_`` is an
atomic add in no fixed order, and the card's and the CPU's float64 ln may
differ in the last bit, so a cell's float64 sum may differ between them by
a few float64 ulps of the cell's sum (relative 2^-53 times the rows in the
cell, at most ~1e-10 here).  The float32 mean then differs between the card
and the CPU by at most one float32 ulp, and only where the two float64
means straddle a float32 rounding boundary.  The JAX package sums float32
logs (``intensity_sums_jax``): within rtol 3e-5 of the float64 oracle.

Per-sweep grids [S, U, B] (``intensity_per_sweep_sums``) go through kernel
K4 (``ops/cuda_sweep_sums.py``) on CUDA tensors and its plain version
``sweep_sums_plain`` on CPU tensors; both are exact integer sums, equal to
the JAX package's scan form and Pallas kernel while cell sums stay below
2^24.  K4 takes integer RSS only (as ``pallas_sweep_sums`` does); the
pre-log per-sweep sums are the float64 ``index_add_`` above (the JAX
package's scan engine).  The numpy host pivot (``intensity_grid_np``)
gives a session's observed-beam masks and, with ``fill_grid`` and
``compact_grid`` on its numpy arrays, the estimator's float64 scene (the
pre-log scene too); ``compact_grid`` cuts a grid to its observed and
mapped beams for the heatmap.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from slam_process_tpu_torch.config import SceneConfig
from slam_process_tpu_torch.ops import cuda_sweep_sums

_DEFAULT = SceneConfig()


class IntensityGrid(NamedTuple):
    """Dense [n_beams, n_beams] intensity statistics, UE-major (tensors;
    numpy arrays from ``intensity_grid_np``)."""

    mean: torch.Tensor        # [U, B] f32, NaN where count == 0
    counts: torch.Tensor      # [U, B] i32
    row_mask: torch.Tensor    # [U] bool, UE id observed
    col_mask: torch.Tensor    # [B] bool, BS id observed
    fill_value: torch.Tensor  # scalar f32: min of observed cell means


def _kept_values(ue, bs, rss, valid, flag, cfg: SceneConfig):
    """(keep [F] bool, values [F]): the rows that count and what each adds:
    integer RSS as int64, or under ``cfg.log_transform`` ln(RSS) in
    float64 with rows of RSS <= 0 dropped."""
    nb = cfg.n_beams
    keep = valid.to(torch.bool) & (ue >= 0) & (ue < nb) & (bs >= 0) & (bs < nb)
    if cfg.flag_filter is not None and flag is not None:
        keep &= flag == cfg.flag_filter
    if cfg.log_transform:
        keep &= rss > 0
        return keep, torch.where(keep, rss.double().clamp(min=1e-300).log(), 0.0)
    if rss.is_floating_point():
        raise ValueError(f"intensity sums take integer RSS, got {rss.dtype}")
    return keep, torch.where(keep, rss, 0).long()


def intensity_cell_sums(ue: torch.Tensor, bs: torch.Tensor, rss: torch.Tensor,
                        valid: torch.Tensor, flag: Optional[torch.Tensor] = None,
                        cfg: SceneConfig = _DEFAULT):
    """(sums [U, B], counts [U, B] int64) over the kept rows; rows [S, F]
    give [S, U, B], each session's or stream's own grid, from one
    ``index_add_``.

    ``rss`` holds integer RSS values.  The sums are int64, exact at any
    size, so running totals over a stream stay exact too; under
    ``cfg.log_transform`` they are float64 sums of ln(RSS) over the rows
    with RSS > 0 (the module docstring bounds them between the card and
    the CPU).
    """
    nb = cfg.n_beams
    keep, val = _kept_values(ue, bs, rss, valid, flag, cfg)
    lead = tuple(ue.shape[:-1])        # S sessions or streams: rows [S, F]
    n_grids = int(np.prod(lead))
    cell = ue * nb + bs
    if n_grids > 1:
        cell = cell + torch.arange(0, n_grids * nb * nb, nb * nb,
                                   device=ue.device).view(lead + (1,))
    dump = n_grids * nb * nb                                     # the dropped rows' bin
    cell = torch.where(keep, cell, dump).long().flatten()
    sums = torch.zeros(dump + 1, dtype=val.dtype, device=ue.device)
    counts = torch.zeros(dump + 1, dtype=torch.int64, device=ue.device)
    sums.index_add_(0, cell, val.flatten())
    counts.index_add_(0, cell, keep.long().flatten())
    return sums[:-1].view(lead + (nb, nb)), counts[:-1].view(lead + (nb, nb))


def cell_means(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """float32 means, NaN where the count is 0: integer sums as float32
    sums over float32 counts (the JAX package's arithmetic); float64 sums
    divided in float64 and rounded once."""
    observed = counts > 0
    if sums.dtype == torch.float64:
        return torch.where(observed, sums / counts.clamp(min=1), float("nan")).float()
    mean = sums.to(torch.float32) / counts.to(torch.float32).clamp(min=1.0)
    return torch.where(observed, mean, float("nan"))


def intensity_grid(ue: torch.Tensor, bs: torch.Tensor, rss: torch.Tensor,
                   valid: torch.Tensor, flag: Optional[torch.Tensor] = None,
                   cfg: SceneConfig = _DEFAULT) -> IntensityGrid:
    """IntensityGrid with NaN in empty cells (``intensity_grid_jax``)."""
    sums, counts = intensity_cell_sums(ue, bs, rss, valid, flag, cfg)
    observed = counts > 0
    mean = cell_means(sums, counts)
    fill = torch.where(observed, mean, float("inf")).min()
    return IntensityGrid(mean, counts.to(torch.int32), observed.any(dim=1),
                         observed.any(dim=0), fill)


def fill_grid(grid: IntensityGrid, cfg: SceneConfig = _DEFAULT):
    """Apply the fill policy: empty cells inside the observed rows x cols
    take the global min; unobserved rows / cols stay NaN.  A grid of numpy
    arrays (``intensity_grid_np``) is filled with numpy, as the JAX
    package fills it."""
    if not cfg.fill_with_min or cfg.keep_nan:
        return grid.mean
    inside = grid.row_mask[:, None] & grid.col_mask[None, :]
    if isinstance(grid.mean, np.ndarray):
        return np.where(inside & np.isnan(grid.mean), grid.fill_value, grid.mean)
    return torch.where(inside & torch.isnan(grid.mean), grid.fill_value, grid.mean)


def compact_grid(grid: IntensityGrid, filled: torch.Tensor, angle_lut: np.ndarray):
    """The observed and mapped submatrix and its angle vectors, as the
    reference pivots it: rows the sorted observed UE ids with a finite
    angle, columns the sorted observed BS ids likewise.

    The masks come to the host; the submatrix is an index select on
    ``filled``'s device, or a numpy one where ``filled`` is numpy.
    Returns (matrix [U', B'], ue_angles, bs_angles, ue_ids, bs_ids), the
    last four numpy (``slam_process_tpu/ops/scene.py::compact_grid``).
    """
    mapped = np.isfinite(angle_lut)
    if isinstance(filled, np.ndarray):
        ue_ids = np.nonzero(np.asarray(grid.row_mask) & mapped)[0]
        bs_ids = np.nonzero(np.asarray(grid.col_mask) & mapped)[0]
        return (filled[np.ix_(ue_ids, bs_ids)], angle_lut[ue_ids], angle_lut[bs_ids], ue_ids,
                bs_ids)
    ue_ids = np.nonzero(grid.row_mask.cpu().numpy() & mapped)[0]
    bs_ids = np.nonzero(grid.col_mask.cpu().numpy() & mapped)[0]
    rows = torch.from_numpy(ue_ids).to(filled.device)
    cols = torch.from_numpy(bs_ids).to(filled.device)
    matrix = filled.index_select(0, rows).index_select(1, cols)
    return matrix, angle_lut[ue_ids], angle_lut[bs_ids], ue_ids, bs_ids


def sweep_sums_plain(p: torch.Tensor, bs: torch.Tensor, val: torch.Tensor, max_sweeps: int,
                     n_beams: int = 64):
    """Plain PyTorch per-sweep (sums, counts) [S, n, n] f32 from the row
    streams of kernel K4: p = gid * n + ue (-1: dropped), bs, integer val.
    int64 ``index_add_`` over S n^2 + 1 bins, the last one for dropped rows
    (p outside [0, S n) or bs outside [0, n))."""
    width = max_sweeps * n_beams
    keep = (p >= 0) & (p < width) & (bs >= 0) & (bs < n_beams)
    cell = torch.where(keep, p.long() * n_beams + bs.long(), width * n_beams)
    sums = torch.zeros(width * n_beams + 1, dtype=torch.int64, device=p.device)
    counts = torch.zeros_like(sums)
    sums.index_add_(0, cell, torch.where(keep, val.long(), 0))
    counts.index_add_(0, cell, keep.long())
    shape = (max_sweeps, n_beams, n_beams)
    return (sums[:-1].view(shape).to(torch.float32),
            counts[:-1].view(shape).to(torch.float32))


def intensity_per_sweep_sums(ue: torch.Tensor, bs: torch.Tensor, rss: torch.Tensor,
                             gid: torch.Tensor, valid: torch.Tensor, max_sweeps: int,
                             cfg: SceneConfig = _DEFAULT):
    """Per-sweep (sums [S, U, B], counts [S, U, B]) over the kept rows
    (``intensity_per_sweep_sums_jax``).

    A row counts when it is valid, its UE and BS ids lie in [0, n_beams)
    and its sweep id in [0, max_sweeps).  ``rss`` holds integer RSS:
    kernel K4 on CUDA tensors, the plain version on CPU tensors, both
    float32 and exact while a cell's sum stays below 2^24.  Under
    ``cfg.log_transform`` both are float64 (ln(RSS) summed by
    ``index_add_``, rows of RSS <= 0 dropped) and K4 is not used.
    """
    nb = cfg.n_beams
    in_sweep = valid.to(torch.bool) & (gid >= 0) & (gid < max_sweeps)
    if cfg.log_transform:
        keep, val = _kept_values(ue, bs, rss, in_sweep, None, cfg)
        cell = torch.where(keep, (gid.long() * nb + ue) * nb + bs, max_sweeps * nb * nb).long()
        sums = torch.zeros(max_sweeps * nb * nb + 1, dtype=torch.float64, device=ue.device)
        counts = torch.zeros_like(sums)
        sums.index_add_(0, cell, val)
        counts.index_add_(0, cell, keep.double())
        shape = (max_sweeps, nb, nb)
        return sums[:-1].view(shape), counts[:-1].view(shape)
    if rss.is_floating_point():
        raise ValueError(f"per-sweep sums take integer RSS, got {rss.dtype}")
    keep = in_sweep & (ue >= 0) & (ue < nb) & (bs >= 0) & (bs < nb)
    p = torch.where(keep, gid * nb + ue, -1).to(torch.int32)
    if p.is_cuda:
        return cuda_sweep_sums.sweep_sums_cuda(p.contiguous(), bs.to(torch.int32).contiguous(),
                                               rss.to(torch.int32).contiguous(), max_sweeps,
                                               nb)
    if p.device.type != "cpu":
        raise ValueError(f"per-sweep sums run on CUDA or CPU tensors, got {p.device}")
    return sweep_sums_plain(p, bs, rss, max_sweeps, nb)


def intensity_per_sweep(ue: torch.Tensor, bs: torch.Tensor, rss: torch.Tensor,
                        gid: torch.Tensor, valid: torch.Tensor, max_sweeps: int,
                        cfg: SceneConfig = _DEFAULT):
    """(mean [S, U, B] f32 with NaN empties, counts [S, U, B] i32)
    (``intensity_per_sweep_jax``)."""
    sums, counts = intensity_per_sweep_sums(ue, bs, rss, gid, valid, max_sweeps, cfg)
    return cell_means(sums, counts), counts.to(torch.int32)


# ---------------------------------------------------------------------------
# numpy host pivot
# ---------------------------------------------------------------------------


def intensity_grid_np(ue: np.ndarray, bs: np.ndarray, rss: np.ndarray,
                      flag: Optional[np.ndarray] = None,
                      cfg: SceneConfig = _DEFAULT) -> IntensityGrid:
    """Float64 host pivot: per-(UE, BS) mean over the kept rows, as numpy."""
    ue = np.asarray(ue, dtype=np.int64)
    bs = np.asarray(bs, dtype=np.int64)
    val = np.asarray(rss, dtype=np.float64)

    keep = (ue >= 0) & (ue < cfg.n_beams) & (bs >= 0) & (bs < cfg.n_beams)
    if cfg.flag_filter is not None and flag is not None:
        keep &= np.asarray(flag) == cfg.flag_filter
    if cfg.log_transform:
        keep &= val > 0
        val = np.where(keep, np.log(np.maximum(val, 1e-300)), 0.0)

    u, b, v = ue[keep], bs[keep], val[keep]
    sums = np.zeros((cfg.n_beams, cfg.n_beams), dtype=np.float64)
    counts = np.zeros((cfg.n_beams, cfg.n_beams), dtype=np.int64)
    np.add.at(sums, (u, b), v)
    np.add.at(counts, (u, b), 1)
    return grid_from_sums_np(sums, counts)


def grid_from_sums_np(sums: np.ndarray, counts: np.ndarray) -> IntensityGrid:
    """(sums, counts) accumulators -> IntensityGrid of numpy arrays: NaN
    empty means, observed-row / -column masks, the min observed mean."""
    with np.errstate(invalid="ignore"):
        mean = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)
    row_mask = counts.sum(axis=1) > 0
    col_mask = counts.sum(axis=0) > 0
    observed = counts > 0
    fill = mean[observed].min() if observed.any() else np.nan
    return IntensityGrid(mean, counts.astype(np.int32), row_mask, col_mask, np.float64(fill))


def grid_to_device(grid: IntensityGrid, device) -> IntensityGrid:
    """A grid of numpy arrays (``grid_from_sums_np``) as tensors on
    ``device``: float32 means and fill value (the raster's input dtype),
    int32 counts, bool masks."""
    mean, counts, row_mask, col_mask, fill = grid
    return IntensityGrid(torch.as_tensor(np.asarray(mean, np.float32), device=device),
                         torch.as_tensor(np.asarray(counts, np.int32), device=device),
                         torch.as_tensor(np.asarray(row_mask, bool), device=device),
                         torch.as_tensor(np.asarray(col_mask, bool), device=device),
                         torch.tensor(float(fill), dtype=torch.float32, device=device))
