"""Typed configuration of the session pipeline's stages.

A copy of the stage configs of ``slam_process_tpu/config.py``
(``DecodeConfig``, ``CorrectConfig``, ``SceneConfig``, ``DictionaryConfig``,
``OmpConfig``) with the same fields and defaults, and a ``PipelineConfig``
holding the ones ``Session`` reads; ``convert.configs_from_reference`` builds
these from any objects that carry the same field names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Wire-format constants for the 11-byte v3 frame format.

    The frame is [FLAG 0xCC/0x33][UE 00xxxxxx][BS 11xxxxxx][CLK x5
    01xxxxxx little-endian 6-bit limbs][RSS x3 10xxxxxx -> 18-bit].
    """

    frame_len: int = 11
    flag_true: int = 0xCC   # FLAG column value 1 (baseline marker)
    flag_false: int = 0x33  # FLAG column value 0 (normal frame)


@dataclasses.dataclass(frozen=True)
class CorrectConfig:
    """CLK-based BS-beam reconstruction constants.

    corrected = (bs_b + round(d / cycle)) % mod_base, accepted iff
    |d - round(d / cycle) * cycle| <= tol, min-residual baseline.
    """

    cycle: int = 61_000
    tol: int = 500
    mod_base: int = 64


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Intensity-matrix assembly (per-(UE, BS) mean RSS)."""

    n_beams: int = 64
    log_transform: bool = False       # pre-log: drop RSS<=0, RSS := ln(RSS)
    fill_with_min: bool = True        # fillna(global min of cell means)
    keep_nan: bool = False            # keep NaN for empty cells
    flag_filter: Optional[int] = None  # keep only rows with this FLAG


@dataclasses.dataclass(frozen=True)
class DictionaryConfig:
    """Gaussian-beam dictionary for the sparse estimators: sigma =
    beam_width / 2.355 (FWHM), grid step grid_res with a floor of
    min_grid_points per axis; grid_kind "linspace", "arange" or
    "arange_inclusive"."""

    grid_res: float = 0.1
    beam_width: float = 1.4
    min_grid_points: int = 10
    grid_kind: str = "linspace"


@dataclasses.dataclass(frozen=True)
class OmpConfig:
    """NN-OMP estimation loop."""

    max_paths: int = 20
    min_power_ratio: float = 3e-4
    # Bounded outer iterations of the NNLS active-set solve.
    nnls_max_iter: int = 64


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The session's decode and correct stages: the fields of the JAX
    package's ``PipelineConfig`` that ``Session`` reads.  The per-sweep
    estimator takes its dictionary and NN-OMP settings as keyword overrides
    of ``sweep_paths``, as the JAX package's does."""

    decode: DecodeConfig = dataclasses.field(default_factory=DecodeConfig)
    correct: CorrectConfig = dataclasses.field(default_factory=CorrectConfig)
