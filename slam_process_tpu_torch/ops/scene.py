"""Scene assembly: frames -> per-session mean-RSS intensity grid.

A (UE, BS) cell mean is a segment mean over frames.  The sums are taken in
int64 with ``index_add_`` over the n_beams^2 cells (integer atomics on the
card, so the result does not depend on the order of the adds) and turned
into float32 at the end.  The JAX package's float32 one-hot einsum is exact
while cell sums stay below 2^24, so there the two agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from slam_process_tpu_torch.config import SceneConfig

_DEFAULT = SceneConfig()


class IntensityGrid(NamedTuple):
    """Dense [n_beams, n_beams] intensity statistics, UE-major."""

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
