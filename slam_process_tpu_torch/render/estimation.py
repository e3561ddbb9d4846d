"""Estimation-result figures: an RBF-interpolated background and the
paths' markers.

The port of ``slam_process_tpu/render/estimation.py``: ``rbf_background``,
``estimation_plot`` and the fusion estimator's ``fusion_plot``.  The 100 x 100 background (``ops/interp``'s
linear RBF, scipy ``Rbf`` equivalent) is computed on a device, None
meaning CUDA, in the JAX package's numpy types: the kernel matrix from the
float32 beam angles in float32, the 4,096-centre solve (at the full 64 x
64 scene) and the evaluation in float64.  A
singular system gives a zero background, as the JAX package's fallback
does; any other failure (a CUDA error, a wrong device or shape) propagates.
matplotlib draws the contour, markers and labels, imported inside the
function: the card's machine has none.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from slam_process_tpu_torch.models.classifiers import LOS, NLOS, ClassifiedPaths
from slam_process_tpu_torch.ops.interp import rbf_interpolate_grid
from slam_process_tpu_torch.pipeline.device import resolve_device


def rbf_background(rss_matrix: np.ndarray, ue_angles: np.ndarray, bs_angles: np.ndarray,
                   grid_n: int = 100, smooth: float = 0.0, device=None):
    """(grid_x [AoD], grid_y [AoA], heatmap [grid_n, grid_n]) as numpy, the
    RBF over ``rss_matrix`` [U, B] (UE-major) solved in float64 on
    ``device`` (None: CUDA), the distances in the angles' own dtype; zeros
    where the system is singular."""
    dev = resolve_device(device)
    grid_x = np.linspace(float(np.min(bs_angles)), float(np.max(bs_angles)), grid_n)
    grid_y = np.linspace(float(np.min(ue_angles)), float(np.max(ue_angles)), grid_n)
    values = torch.as_tensor(np.asarray(rss_matrix, dtype=np.float64), device=dev)
    try:
        heat = rbf_interpolate_grid(bs_angles, ue_angles, values, grid_x, grid_y,
                                    smooth=smooth).cpu().numpy()
    except torch.linalg.LinAlgError:   # singular system: the reference's fallback
        heat = np.zeros((grid_n, grid_n))
    return grid_x, grid_y, heat


def estimation_plot(
    rss_matrix: np.ndarray,
    ue_angles: np.ndarray,
    bs_angles: np.ndarray,
    classified: ClassifiedPaths,
    output_path: Union[str, Path],
    style: str = "v1-7",       # "v1" (golden pic/ style) | "v1-7" (improved)
    grid_n: int = 100,
    rbf_smooth: Optional[float] = None,
    contour_levels: int = 50,
    dpi: int = 300,
    title: Optional[str] = None,
    device=None,
) -> Path:
    """The estimation figure: the ``rbf_background`` contour (computed on
    ``device``, None meaning CUDA) with the classified paths' markers, in
    the v1 (golden) or v1-7 (improved) style; needs matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    from slam_process_tpu_torch.render.fonts import setup_cjk_font

    setup_cjk_font()
    import matplotlib.pyplot as plt

    if rbf_smooth is None:
        rbf_smooth = 0.1 if style == "v1-7" else 0.0
    grid_x, grid_y, heat = rbf_background(rss_matrix, ue_angles, bs_angles, grid_n,
                                          rbf_smooth, device=device)
    gx, gy = np.meshgrid(grid_x, grid_y)

    figsize = (15, 12) if style == "v1-7" else (12, 10)
    fig, ax = plt.subplots(figsize=figsize)
    contour = ax.contourf(gx, gy, heat, levels=contour_levels, cmap="viridis",
                          alpha=0.8 if style == "v1-7" else 1.0)
    fig.colorbar(
        contour, ax=ax,
        label="Log(RSS) Power Distribution" if style == "v1-7"
        else "Interpolated RSS Power",
    )

    lab = np.asarray(classified.label)
    los_idx = np.nonzero(lab == LOS)[0]
    nlos_idx = np.nonzero(lab == NLOS)[0]

    if style == "v1-7":
        if los_idx.size:
            ax.scatter(classified.aod[los_idx], classified.aoa[los_idx],
                       c="red", marker="*", s=600, edgecolors="black",
                       linewidth=2.5, label="LoS径", zorder=9)
            for i in los_idx:
                ax.text(classified.aod[i] + 1.5, classified.aoa[i] + 2,
                        f"LoS\n({classified.aod[i]:.1f}°, {classified.aoa[i]:.1f}°)",
                        color="white", fontweight="bold", fontsize=12,
                        bbox=dict(boxstyle="round,pad=0.6", facecolor="red",
                                  alpha=0.85), zorder=11)
        for n, i in enumerate(nlos_idx, 1):
            ax.scatter(classified.aod[i], classified.aoa[i], c="lime",
                       marker="D", s=250, edgecolors="black", linewidth=2.5,
                       zorder=9)
            ax.text(classified.aod[i] + 1.5, classified.aoa[i] - 2,
                    f"NLoS{n}\n({classified.aod[i]:.1f}°, {classified.aoa[i]:.1f}°)",
                    color="white", fontweight="bold", fontsize=10,
                    bbox=dict(boxstyle="round,pad=0.5", facecolor="green",
                              alpha=0.8), zorder=9)
        if nlos_idx.size:
            ax.scatter([], [], c="lime", marker="D", s=250,
                       edgecolors="darkgreen", linewidth=2.5, label="NLoS径")
        ax.set_xlabel("出发角 (AoD) [度]", fontsize=14, fontweight="bold")
        ax.set_ylabel("到达角 (AoA) [度]", fontsize=14, fontweight="bold")
        ax.set_title(title or "mmWave Multipath Heatmap (Log Scale) & "
                     "Estimation Results\n", fontsize=20, fontweight="bold",
                     pad=3)
        ax.legend(loc="upper right", fontsize=12, framealpha=0.95,
                  markerscale=0.8, handletextpad=0.5, borderpad=1.2,
                  labelspacing=1.0, handlelength=2.0, borderaxespad=1.0,
                  fancybox=True, shadow=True)
    else:  # v1 golden style
        if los_idx.size:
            ax.scatter(classified.aod[los_idx], classified.aoa[los_idx],
                       c="red", marker="o", s=150, edgecolors="black",
                       label="LoS Path", linewidth=2)
            for i in los_idx:
                ax.text(classified.aod[i] + 1, classified.aoa[i] + 1,
                        f"LoS\n({classified.aod[i]:.1f}, {classified.aoa[i]:.1f})",
                        color="white", fontweight="bold")
        ax.set_xlabel("Angle of Departure (AoD) [deg]")
        ax.set_ylabel("Angle of Arrival (AoA) [deg]")
        ax.set_title(title or "mmWave Multipath Heatmap & Estimation Results")
        ax.legend()
    ax.grid(alpha=0.3, linestyle="--" if style == "v1-7" else "-")

    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    if style == "v1-7":
        fig.tight_layout()
    fig.savefig(output_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return output_path


def fusion_plot(rss_matrix: np.ndarray, ue_angles: np.ndarray, bs_angles: np.ndarray,
                los_paths, nlos_paths, output_path: Union[str, Path], grid_n: int = 100,
                dpi: int = 300, device=None) -> Path:
    """The fusion estimator's figure: a 100-level viridis contour over the
    linear-RBF background (on ``device``, None meaning CUDA); the LoS
    paths ((aod, aoa) pairs) as red circles with dashed cross lines, the
    NLoS paths as white crosses, one legend entry each; needs
    matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    from slam_process_tpu_torch.render.fonts import setup_cjk_font

    setup_cjk_font()
    import matplotlib.pyplot as plt

    grid_x, grid_y, heat = rbf_background(rss_matrix, ue_angles, bs_angles, grid_n,
                                          smooth=0.0, device=device)
    gx, gy = np.meshgrid(grid_x, grid_y)
    fig, ax = plt.subplots(figsize=(12, 10))
    contour = ax.contourf(gx, gy, heat, levels=100, cmap="viridis")
    fig.colorbar(contour, ax=ax, label="Received Signal Strength (RSS)")
    for aod, aoa in los_paths:
        ax.scatter(aod, aoa, s=200, c="red", marker="o", edgecolors="white", linewidth=2,
                   label="LoS Path (v1)", zorder=10)
        ax.text(aod + 1, aoa + 1, f"LoS\n({aod:.1f}, {aoa:.1f})", color="white",
                fontweight="bold")
        ax.axvline(x=aod, color="red", linestyle="--", alpha=0.4)
        ax.axhline(y=aoa, color="red", linestyle="--", alpha=0.4)
    for aod, aoa in nlos_paths:
        ax.scatter(aod, aoa, s=150, c="white", marker="x", linewidth=3,
                   label="NLoS Path (v3)", zorder=10)
        ax.text(aod + 1, aoa + 1, f"NLoS\n({aod:.1f}, {aoa:.1f})", color="white", fontsize=9,
                fontweight="bold")
    ax.set_xlabel("Angle of Departure (AoD) [deg]", fontsize=12)
    ax.set_ylabel("Angle of Arrival (AoA) [deg]", fontsize=12)
    ax.set_title("mmWave Multipath Heatmap - Fusion: LoS (v1) + NLoS (v3)", fontsize=14)
    handles, labels = ax.get_legend_handles_labels()
    by_label = dict(zip(labels, handles))       # one entry per label
    if by_label:
        ax.legend(by_label.values(), by_label.keys(), loc="upper right", frameon=True,
                  facecolor="black", framealpha=0.6, labelcolor="white")
    ax.grid(True, alpha=0.3)
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return output_path
