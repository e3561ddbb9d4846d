"""Scene assembly: frames -> per-session mean-RSS intensity grid.

A (UE, BS) cell mean is a segment mean over frames.  The sums are taken in
int64 with ``index_add_`` over the n_beams^2 cells (integer atomics on the
card, so the result does not depend on the order of the adds) and turned
into float32 at the end.  The JAX package's float32 one-hot einsum is exact
while cell sums stay below 2^24, so there the two agree bit for bit.

Per-sweep grids [S, U, B] (``intensity_per_sweep_sums``) go through kernel
K4 (``ops/cuda_sweep_sums.py``) on CUDA tensors and its plain version
``sweep_sums_plain`` on CPU tensors; both are exact integer sums, equal to
the JAX package's scan form and Pallas kernel while cell sums stay below
2^24.  The numpy host pivot (``intensity_grid_np``) gives a session's
observed-beam masks.
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


def intensity_sums(ue: torch.Tensor, bs: torch.Tensor, rss: torch.Tensor,
                   valid: torch.Tensor, flag: Optional[torch.Tensor] = None,
                   cfg: SceneConfig = _DEFAULT):
    """(sums [U, B] f32, counts [U, B] f32) over the kept rows.

    ``rss`` holds integer RSS values.  The pre-log transform
    (``cfg.log_transform``) needs float sums and is not ported yet.
    """
    if cfg.log_transform:
        raise NotImplementedError("log_transform scenes need float sums; only the "
                                  "integer-exact form is ported")
    if rss.is_floating_point():
        raise ValueError(f"intensity sums take integer RSS, got {rss.dtype}")
    nb = cfg.n_beams
    keep = valid.to(torch.bool) & (ue >= 0) & (ue < nb) & (bs >= 0) & (bs < nb)
    if cfg.flag_filter is not None and flag is not None:
        keep &= flag == cfg.flag_filter
    cell = torch.where(keep, ue * nb + bs, nb * nb).long()       # bin nb^2: dropped
    sums = torch.zeros(nb * nb + 1, dtype=torch.int64, device=ue.device)
    counts = torch.zeros_like(sums)
    sums.index_add_(0, cell, torch.where(keep, rss, 0).long())
    counts.index_add_(0, cell, keep.long())
    return (sums[:-1].view(nb, nb).to(torch.float32),
            counts[:-1].view(nb, nb).to(torch.float32))


def intensity_grid(ue: torch.Tensor, bs: torch.Tensor, rss: torch.Tensor,
                   valid: torch.Tensor, flag: Optional[torch.Tensor] = None,
                   cfg: SceneConfig = _DEFAULT) -> IntensityGrid:
    """IntensityGrid with NaN in empty cells (``intensity_grid_jax``)."""
    sums, counts = intensity_sums(ue, bs, rss, valid, flag, cfg)
    observed = counts > 0
    mean = torch.where(observed, sums / counts.clamp(min=1.0), float("nan"))
    fill = torch.where(observed, mean, float("inf")).min()
    return IntensityGrid(mean, counts.to(torch.int32), observed.any(dim=1),
                         observed.any(dim=0), fill)


def fill_grid(grid: IntensityGrid, cfg: SceneConfig = _DEFAULT) -> torch.Tensor:
    """Apply the fill policy: empty cells inside the observed rows x cols
    take the global min; unobserved rows / cols stay NaN."""
    if not cfg.fill_with_min or cfg.keep_nan:
        return grid.mean
    inside = grid.row_mask[:, None] & grid.col_mask[None, :]
    return torch.where(inside & torch.isnan(grid.mean), grid.fill_value, grid.mean)


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
    """Per-sweep (sums [S, U, B] f32, counts [S, U, B] f32) over the kept
    rows (``intensity_per_sweep_sums_jax``).

    A row counts when it is valid, its UE and BS ids lie in [0, n_beams)
    and its sweep id in [0, max_sweeps).  Kernel K4 on CUDA tensors, the
    plain version on CPU tensors.  ``rss`` holds integer RSS; the sums
    are exact in float32 while a cell's sum stays below 2^24.
    """
    if cfg.log_transform:
        raise NotImplementedError("log_transform scenes need float sums; only the "
                                  "integer-exact form is ported")
    if rss.is_floating_point():
        raise ValueError(f"per-sweep sums take integer RSS, got {rss.dtype}")
    nb = cfg.n_beams
    keep = (valid.to(torch.bool) & (ue >= 0) & (ue < nb) & (bs >= 0) & (bs < nb)
            & (gid >= 0) & (gid < max_sweeps))
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
    mean = torch.where(counts > 0, sums / counts.clamp(min=1.0), float("nan"))
    return mean, counts.to(torch.int32)


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
