"""SM-SIC: spatial-masking successive interference cancellation.

The port of ``slam_process_tpu/models/sm_sic.py``.  One matched-filter
correlation ``Phi_rx^T @ RSS @ Phi_tx`` over an inclusive-arange grid, then
up to ``max_paths`` peak extractions: after the LoS peak a circular
proximity mask and a cross mask (the sidelobe ridges along both angle axes)
are applied, each NLoS peak gets a small circular mask, and the search
stops when a peak falls below ``stop_ratio`` times the LoS metric.

  * ``sm_sic_np``: a copy of the float64 host oracle, with the reference's
    control flow (slots after the stop stay zero).
  * ``sm_sic``: the same on tensors, for one scene [U, B] or S scenes [S,
    U, B] that share the dictionary, on their device.  The correlation
    chain is taken in float64 from the float32 operands and rounded once to
    float32, so the card and the CPU see the same surface (the rule of the
    NN-OMP estimators).  The peak is the first flat index of the maximum
    (``torch.argmax``, like ``jnp.argmax`` and ``np.argmax``).  The masks
    are products of bools, their geometry taken in float64 from the grids
    as given: float64 grids (``run_estimator``, the per-sweep paths) give
    the oracle's masks exactly, where the grid points sit exactly on the
    masks' radii (0.5 deg steps against radii of 1, 2 and 2.5 deg) and
    float32 grids would move them.  The stop test compares the float32
    peak with ``stop_ratio`` times the LoS metric in float64.  As in
    ``sm_sic_jax``, the slots after the stop hold the last masked surface's
    peak with ``valid`` False.

The reference's parameters: beam_width 10 deg, grid 0.5 deg, max_paths 3,
proximity 2 deg, cross width 5 deg.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_process_tpu_torch.config import SmSicConfig
from slam_process_tpu_torch.utils.graphs import GraphProgram, program_cache


class SmSicPaths(NamedTuple):
    """Peaks of the masked correlation surface: [K] per scene, [S, K] for S
    scenes (tensors or numpy arrays)."""

    aoa: torch.Tensor      # [.., K]
    aod: torch.Tensor
    metric: torch.Tensor   # correlation peak value
    valid: torch.Tensor    # [.., K] bool
    is_los: torch.Tensor   # [.., K] bool (slot 0 when valid)


def sm_sic_np(dictionary, rss_matrix: np.ndarray, cfg: SmSicConfig) -> SmSicPaths:
    """Float64 host oracle with the reference's control flow."""
    corr = dictionary.phi_rx.T @ rss_matrix.astype(np.float64) @ dictionary.phi_tx
    aoa_g, aod_g = dictionary.aoa_grid, dictionary.aod_grid
    AOA, AOD = np.meshgrid(aoa_g, aod_g, indexing="ij")
    mask = np.ones_like(corr)

    K = cfg.max_paths
    aoa = np.zeros(K)
    aod = np.zeros(K)
    metric = np.zeros(K)
    valid = np.zeros(K, dtype=bool)
    los_metric = None
    for k in range(K):
        masked = corr * mask
        idx = np.unravel_index(np.argmax(masked), masked.shape)
        peak = masked[idx]
        a, d = aoa_g[idx[0]], aod_g[idx[1]]
        if k > 0 and los_metric is not None and peak < cfg.stop_ratio * los_metric:
            break
        aoa[k], aod[k], metric[k], valid[k] = a, d, peak, True
        if k == 0:
            los_metric = peak
            dist_sq = (AOA - a) ** 2 + (AOD - d) ** 2
            mask *= dist_sq > cfg.proximity_mask_radius**2
            mask *= np.abs(AOD - d) > (cfg.cross_mask_width / 2)
            mask *= np.abs(AOA - a) > (cfg.cross_mask_width / 2)
        else:
            dist_sq = (AOA - a) ** 2 + (AOD - d) ** 2
            mask *= dist_sq > cfg.nlos_mask_radius**2
    is_los = np.zeros(K, dtype=bool)
    if valid[0]:
        is_los[0] = True
    return SmSicPaths(aoa, aod, metric, valid, is_los)


def correlation_surface(phi_rx: torch.Tensor, phi_tx: torch.Tensor,
                        mats: torch.Tensor) -> torch.Tensor:
    """[S, Ga, Gd] float32: Phi_rx^T @ mats[s] @ Phi_tx in float64 from the
    float32 operands, rounded once."""
    t = torch.matmul(phi_rx.T.to(torch.float32).double(), mats.to(torch.float32).double())
    return torch.matmul(t, phi_tx.to(torch.float32).double()).to(torch.float32)


def sm_sic(phi_rx: torch.Tensor, phi_tx: torch.Tensor, aoa_grid: torch.Tensor,
           aod_grid: torch.Tensor, mats: torch.Tensor, cfg: SmSicConfig) -> SmSicPaths:
    """SM-SIC on ``mats`` [U, B] (one scene) or [S, U, B] (S scenes sharing
    the dictionary phi_rx [U, Ga], phi_tx [B, Gd]), on their device.
    Returns SmSicPaths of [K] or [S, K] tensors: angles in the grids'
    dtype, float32 metric."""
    single = mats.dim() == 2
    corr = correlation_surface(phi_rx, phi_tx, mats[None] if single else mats)
    S, Ga, Gd = corr.shape
    dev = corr.device
    ga64, gd64 = aoa_grid.double(), aod_grid.double()
    lanes = torch.arange(S, device=dev)
    mask = torch.ones((S, Ga, Gd), dtype=torch.bool, device=dev)
    stopped = torch.zeros(S, dtype=torch.bool, device=dev)
    los = torch.zeros(S, dtype=torch.float64, device=dev)
    out = []
    for k in range(cfg.max_paths):
        masked = corr * mask
        flat = masked.reshape(S, -1).argmax(dim=1)
        i, j = flat // Gd, flat % Gd
        peak = masked.reshape(S, -1)[lanes, flat]
        if k > 0:
            stopped = stopped | (peak.double() < cfg.stop_ratio * los)
        da = ga64[None, :, None] - ga64[i][:, None, None]       # [S, Ga, 1]
        dd = gd64[None, None, :] - gd64[j][:, None, None]       # [S, 1, Gd]
        dist_sq = da * da + dd * dd
        if k == 0:
            los = peak.double()
            new = ((dist_sq > cfg.proximity_mask_radius ** 2)
                   & (dd.abs() > cfg.cross_mask_width / 2)
                   & (da.abs() > cfg.cross_mask_width / 2))
        else:
            new = dist_sq > cfg.nlos_mask_radius ** 2
        mask = mask & (new | stopped[:, None, None])
        out.append((aoa_grid[i], aod_grid[j], peak, ~stopped, ~stopped & (k == 0)))
    paths = SmSicPaths(*(torch.stack(col, dim=1) for col in zip(*out)))
    return SmSicPaths(*(x[0] for x in paths)) if single else paths


@program_cache(8)
def sm_sic_program(cfg: SmSicConfig, device=None):
    """``sm_sic`` of one config as one compiled program on ``device`` (None:
    CUDA), the JAX package's ``jit_highest(sm_sic_jax)`` (``run_sm_sic``),
    called as ``fn(phi_rx, phi_tx, aoa_grid, aod_grid, mat)``: on CUDA one
    graph per shape.  JAX builds a fresh jitted function per call; the port
    keeps 8 programs of 8 shapes."""
    return GraphProgram(lambda phi_rx, phi_tx, aoa_grid, aod_grid, mat: sm_sic(
        phi_rx, phi_tx, aoa_grid, aod_grid, mat, cfg), device, 8)


def run_sm_sic(dictionary, rss_matrix: np.ndarray, cfg: SmSicConfig, engine: str = "device",
               device=None) -> SmSicPaths:
    """One scene: ``engine="device"`` runs ``sm_sic_program`` on ``device``
    (None: CUDA) with the phi matrices and the scene rounded once to
    float32 and the float64 grids, read back once as numpy;
    ``engine="host"`` is ``sm_sic_np``."""
    if engine == "host":
        return sm_sic_np(dictionary, rss_matrix, cfg)
    if engine != "device":
        raise ValueError(f"unknown engine {engine!r}; use 'device' or 'host'")
    f32, f64 = np.float32, np.float64
    return sm_sic_program(cfg, device).host(
        np.asarray(dictionary.phi_rx, f32), np.asarray(dictionary.phi_tx, f32),
        np.asarray(dictionary.aoa_grid, f64), np.asarray(dictionary.aod_grid, f64),
        np.asarray(rss_matrix, f32))
