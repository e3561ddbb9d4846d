"""Gaussian-beam response dictionaries for the sparse estimators.

A copy of ``slam_process_tpu/models/dictionary.py``: the beam response is
a Gaussian with sigma = FWHM / 2.355, on linspace (>= ``min_grid_points``
points) or arange grids.  The dictionary is built in float64 numpy on the
host; ``dictionary_to_device`` moves it to a device as float32 tensors,
where the JAX package moves it with ``jnp.asarray(..., float32)``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from slam_process_tpu_torch.config import DictionaryConfig


def gaussian_beam(x: np.ndarray, center, width: float) -> np.ndarray:
    """exp(-(x - c)^2 / (2 sigma^2)), sigma = width / 2.355 (FWHM)."""
    sigma = width / 2.355
    d = x - center
    return np.exp(-(d * d) / (2.0 * sigma * sigma))


class BeamDictionary(NamedTuple):
    aoa_grid: np.ndarray   # [Ga]
    aod_grid: np.ndarray   # [Gd]
    phi_rx: np.ndarray     # [U, Ga] response of UE beam u to AoA grid angle
    phi_tx: np.ndarray     # [B, Gd]


def make_grids(ue_angles: np.ndarray, bs_angles: np.ndarray,
               cfg: DictionaryConfig) -> Tuple[np.ndarray, np.ndarray]:
    ue_min, ue_max = float(np.min(ue_angles)), float(np.max(ue_angles))
    bs_min, bs_max = float(np.min(bs_angles)), float(np.max(bs_angles))
    if cfg.grid_kind == "linspace":
        n_aoa = max(int((ue_max - ue_min) / cfg.grid_res) + 1, cfg.min_grid_points)
        n_aod = max(int((bs_max - bs_min) / cfg.grid_res) + 1, cfg.min_grid_points)
        return np.linspace(ue_min, ue_max, n_aoa), np.linspace(bs_min, bs_max, n_aod)
    if cfg.grid_kind == "arange":
        return (np.arange(ue_min, ue_max, cfg.grid_res),
                np.arange(bs_min, bs_max, cfg.grid_res))
    if cfg.grid_kind == "arange_inclusive":
        return (np.arange(ue_min, ue_max + cfg.grid_res, cfg.grid_res),
                np.arange(bs_min, bs_max + cfg.grid_res, cfg.grid_res))
    raise ValueError(f"unknown grid_kind {cfg.grid_kind!r}")


def make_dictionary(ue_angles: np.ndarray, bs_angles: np.ndarray,
                    cfg: DictionaryConfig = DictionaryConfig()) -> BeamDictionary:
    """float64 grids and responses phi_rx [U, Ga], phi_tx [B, Gd]."""
    aoa_grid, aod_grid = make_grids(ue_angles, bs_angles, cfg)
    phi_rx = gaussian_beam(np.asarray(ue_angles, np.float64)[:, None], aoa_grid[None, :],
                           cfg.beam_width)
    phi_tx = gaussian_beam(np.asarray(bs_angles, np.float64)[:, None], aod_grid[None, :],
                           cfg.beam_width)
    return BeamDictionary(aoa_grid, aod_grid, phi_rx, phi_tx)


def dictionary_to_device(d: BeamDictionary, device) -> BeamDictionary:
    """The same dictionary as float32 tensors on ``device`` (each array
    rounded once from float64, as ``jnp.asarray(x, float32)`` rounds)."""
    return BeamDictionary(*(torch.from_numpy(np.asarray(x, dtype=np.float32)).to(device)
                            for x in d))
