"""matplotlib figure chrome around a raster computed on the device (a copy
of ``slam_process_tpu/render/figures.py``'s ``angle_edges``,
``save_heatmap_figure`` and ``save_raster_png``), and the colormap tables
of names the package does not ship.

matplotlib draws the axes, colorbar, title and grid of the heatmap PNG
around the device's blurred matrix, with the norm's parameters recomputed
as ``ops/raster.py`` computes them, so the drawn cells carry the device
raster's colors.  matplotlib is imported inside the functions: the card's
machine has none, and importing this module must not need it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np


def colormap_table(name: str, n: int = 256) -> np.ndarray:
    """[n, 4] float32 RGBA table of the matplotlib colormap ``name``."""
    import matplotlib

    return matplotlib.colormaps[name](np.linspace(0.0, 1.0, n)).astype(np.float32)


def angle_edges(vals: Sequence[float]) -> np.ndarray:
    """Midpoint bin edges of sorted angles for pcolormesh; the end bins
    extend by half the neighbouring step, a single angle by 0.5."""
    vals = np.asarray(vals, dtype=np.float64)
    if len(vals) == 1:
        return np.array([vals[0] - 0.5, vals[0] + 0.5])
    steps = np.diff(vals)
    edges = np.empty(len(vals) + 1)
    edges[1:-1] = (vals[:-1] + vals[1:]) / 2.0
    edges[0] = vals[0] - steps[0] / 2.0
    edges[-1] = vals[-1] + steps[-1] / 2.0
    return edges


def save_heatmap_figure(
    blurred_matrix: np.ndarray,      # [AoD, AoA] device-blurred values
    aod_list: Sequence[float],
    aoa_list: Sequence[float],
    output_path: Union[str, Path],
    title: str = "",
    colormap: str = "viridis",
    use_log: bool = True,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    dpi: int = 150,
    xlabel: str = "AoA（UE侧，度）",
    ylabel: str = "AoD（BS侧，度）",
    cbar_label: Optional[str] = None,
    axes_rect: Optional[Sequence[float]] = None,
) -> Path:
    """Draw the pcolormesh heatmap PNG of a device-blurred matrix.

    The shifted LogNorm (or linear norm) takes the same parameters as
    ``ops/raster.py``, so each cell's color is the device raster's.
    ``axes_rect`` pins the axes to a figure-fraction rect (x0, y0, w, h)
    instead of ``tight_layout``, with the colorbar beside it.
    """
    import matplotlib

    matplotlib.use("Agg")
    from slam_process_tpu_torch.render.fonts import setup_cjk_font

    setup_cjk_font()
    import matplotlib.pyplot as plt
    from matplotlib.colors import LogNorm

    mat = np.asarray(blurred_matrix, dtype=np.float64)
    finite = np.isfinite(mat)
    if not finite.any():
        raise ValueError("matrix is all-NaN; nothing to render")
    if use_log:
        data_min = np.nanmin(mat[finite])
        plot_data = mat - data_min + 1e-6
        lo = (vmin - data_min + 1e-6) if vmin is not None else np.nanmin(plot_data[finite])
        hi = (vmax - data_min + 1e-6) if vmax is not None else np.nanmax(plot_data[finite])
        norm = LogNorm(vmin=lo, vmax=hi)
    else:
        plot_data = mat
        norm = None

    if axes_rect is not None:
        fig = plt.figure(figsize=(10, 8), dpi=120)
        ax = fig.add_axes(list(axes_rect))
    else:
        fig, ax = plt.subplots(figsize=(10, 8), dpi=120)
    cmap = plt.get_cmap(colormap).copy()
    cmap.set_bad(color=(1, 1, 1, 0))
    im = ax.pcolormesh(angle_edges(aoa_list), angle_edges(aod_list),
                       np.ma.masked_invalid(plot_data), cmap=cmap, norm=norm,
                       vmin=None if use_log else vmin, vmax=None if use_log else vmax,
                       shading="auto")
    if axes_rect is not None:
        x0, y0, w, h = axes_rect
        cbar = fig.colorbar(im, cax=fig.add_axes([min(x0 + w + 0.02, 0.96), y0, 0.025, h]))
    else:
        cbar = fig.colorbar(im, ax=ax)
    cbar.set_label(cbar_label if cbar_label is not None
                   else "RSSI强度" + ("（对数刻度）" if use_log else "（线性刻度）"))
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(True, linestyle="--", alpha=0.2)

    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    if axes_rect is None:
        fig.tight_layout()
    fig.savefig(output_path, dpi=dpi)
    plt.close(fig)
    return output_path


def save_raster_png(rgba_u8: np.ndarray, output_path: Union[str, Path]) -> Path:
    """Encode a bare device raster (no chrome) as PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    plt.imsave(output_path, np.asarray(rgba_u8))
    return output_path
