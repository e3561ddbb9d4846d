"""Typed configuration of the session pipeline's stages.

A copy of the stage configs of ``slam_process_tpu/config.py``
(``DecodeConfig``, ``CorrectConfig``, ``SceneConfig``, ``DictionaryConfig``,
``OmpConfig``, ``SmSicConfig``, ``ClassifierConfig``, ``RenderConfig``) with the same fields
and defaults, and a ``PipelineConfig`` holding the ones ``Session`` reads;
``convert.configs_from_reference``, ``convert.classifier_config_from_reference``
and ``convert.render_config_from_reference`` build these from any objects
that carry the same field names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
class SmSicConfig:
    """SM-SIC masked successive cancellation (``models/sm_sic.py``)."""

    max_paths: int = 3
    proximity_mask_radius: float = 2.0
    cross_mask_width: float = 5.0
    nlos_mask_radius: float = 1.0
    stop_ratio: float = 0.1
    beam_width: float = 10.0
    grid_res: float = 0.5


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    """AdvancedPathClassifier thresholds (the v1-6 / v1-7 classifier of
    ``models/classifiers.classify_advanced``)."""

    sidelobe_width_aoa: float = 5.0
    sidelobe_width_aod: float = 5.0
    nlos_power_thresh_db: float = 0.01
    nlos_angle_separation: float = 15.0
    sidelobe_power_ratio_db: float = 0.15


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Heatmap raster and figure settings: blur sigma, shifted-log or
    linear norm with optional explicit bounds, colormap, figure dpi; the
    RBF background fields are kept for the estimation figure."""

    colormap: str = "viridis"
    use_log: bool = True
    blur_sigma: float = 1.0
    vmin: Optional[float] = None
    vmax: Optional[float] = None
    grid_size: Tuple[int, int] = (100, 100)   # RBF background resample
    contour_levels: int = 50
    dpi: int = 150
    rbf_smooth: float = 0.1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The session's decode, correct, scene and render stages: the fields
    of the JAX package's ``PipelineConfig`` that ``Session`` and the device
    streaming session read (the stream reads ``scene``'s ``n_beams`` and
    ``flag_filter``).  The per-sweep estimator takes its dictionary and
    NN-OMP settings as keyword overrides of ``sweep_paths``, as the JAX
    package's does."""

    decode: DecodeConfig = dataclasses.field(default_factory=DecodeConfig)
    correct: CorrectConfig = dataclasses.field(default_factory=CorrectConfig)
    scene: SceneConfig = dataclasses.field(default_factory=SceneConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
