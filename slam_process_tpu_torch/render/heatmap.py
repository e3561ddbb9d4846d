"""Heatmap rendering: intensity grid -> raster on the device -> PNG.

The port of ``slam_process_tpu/render/heatmap.py``.  The three heatmap
variants share this path (v1: Parsed rows; v2: Parsed rows with FLAG 1;
v3: filtered rows).  On the grid's device: the fill policy, the observed
and mapped submatrix (``ops/scene.compact_grid``), the transpose to AoD
rows x AoA columns, and the blur / norm / colormap of kernel K3 (the plain
version on the CPU); then ``to_u8``.  The PNG's chrome is matplotlib's
(``render/figures.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Union

import numpy as np

from slam_process_tpu_torch.config import RenderConfig, SceneConfig
from slam_process_tpu_torch.ops.raster import rasterize_tiles, to_u8
from slam_process_tpu_torch.ops.scene import IntensityGrid, compact_grid, fill_grid
from slam_process_tpu_torch.pipeline.device import device_lut
from slam_process_tpu_torch.render.figures import save_heatmap_figure


class RenderedHeatmap(NamedTuple):
    rgba: np.ndarray          # [AoD, AoA, 4] raster (u8, or f32 with as_u8=False)
    blurred: np.ndarray       # [AoD, AoA] f32 blurred matrix (the figure's input)
    aod_angles: np.ndarray
    aoa_angles: np.ndarray
    norm_t: np.ndarray        # [AoD, AoA] f32 normalised raster, NaN where transparent


def render_intensity(grid: IntensityGrid, angle_lut: np.ndarray,
                     scene_cfg: SceneConfig = SceneConfig(keep_nan=True, fill_with_min=False),
                     render_cfg: RenderConfig = RenderConfig(),
                     as_u8: bool = True) -> RenderedHeatmap:
    """Intensity grid (tensors on one device) -> raster in AoD x AoA
    orientation, computed on the grid's device and returned as numpy."""
    filled = fill_grid(grid, scene_cfg)
    matrix, ue_ang, bs_ang, _, _ = compact_grid(grid, filled, angle_lut)
    if matrix.numel() == 0:
        raise ValueError("no observed beam has a mapped angle; nothing to render")
    lut = device_lut(matrix.device, render_cfg.colormap)
    rgba, norm_t, blurred = rasterize_tiles(
        matrix.T.contiguous()[None], lut, render_cfg.blur_sigma, render_cfg.use_log,
        render_cfg.vmin, render_cfg.vmax)
    rgba = to_u8(rgba[0]) if as_u8 else rgba[0]
    return RenderedHeatmap(rgba.cpu().numpy(), blurred[0].cpu().numpy(), bs_ang, ue_ang,
                           norm_t[0].cpu().numpy())


def save_heatmap(rendered: RenderedHeatmap, output_path: Union[str, Path], title: str = "",
                 render_cfg: RenderConfig = RenderConfig(), axes_rect=None) -> Path:
    """Write the heatmap PNG (matplotlib chrome around the device blur)."""
    return save_heatmap_figure(
        rendered.blurred, aod_list=rendered.aod_angles, aoa_list=rendered.aoa_angles,
        output_path=output_path, title=title, colormap=render_cfg.colormap,
        use_log=render_cfg.use_log, vmin=render_cfg.vmin, vmax=render_cfg.vmax,
        dpi=render_cfg.dpi, axes_rect=axes_rect)
