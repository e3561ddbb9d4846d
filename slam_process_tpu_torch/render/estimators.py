"""The figures of the svd, omp_dense, lasso_refine, peak_picking, geometric
and nn_omp_v13 estimators.

The JAX package draws each in its model module (``_plot_svd``,
``_plot_comparison``, ``_plot``, ``_compare_plot``); the port keeps them
here, where matplotlib may be imported (inside the functions: the card's
machine has none).  The model modules call them only when an output path
is given.  Tables are ``models/registry.Table``; the v1-3 figure's
thin-plate RBF backgrounds are solved on ``device`` (None: CUDA).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, plt, output_path, **kw) -> Path:
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, **kw)
    plt.close(fig)
    return output_path


def plot_svd(heat, grid_ue, grid_bs, paths, output_path) -> Path:
    """The dB heatmap, the LoS star and the NLoS crosses (the svd
    estimator's figure)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(12, 9))
    heat_db = 10 * np.log10(np.maximum(heat, 0) + 1e-9)
    extent = [grid_bs.min(), grid_bs.max(), grid_ue.min(), grid_ue.max()]
    plt.imshow(heat_db, aspect="auto", origin="lower", extent=extent, cmap="viridis")
    plt.colorbar(label="RSS (dB)")
    keep = np.nonzero(paths.valid)[0]
    if keep.size:
        order = keep[np.argsort(-paths.singular[keep], kind="stable")]
        los = order[0]
        plt.scatter(paths.aod[los], paths.aoa[los], c="white", marker="*", s=300,
                    label=f"LoS (AoD:{paths.aod[los]:.1f}, AoA:{paths.aoa[los]:.1f})")
        for k in order[1:]:
            if paths.power[k] > paths.power[los] * 0.1:
                plt.scatter(paths.aod[k], paths.aoa[k], c="red", marker="x", s=150,
                            label=f"NLoS (Rank-{k})")
    plt.xlabel("Base Station AoD (Degree)")
    plt.ylabel("User Equipment AoA (Degree)")
    plt.title("AoA-AoD RSS Heatmap & Identified Multipath Components")
    plt.legend()
    plt.grid(True, alpha=0.3)
    return _save(fig, plt, output_path, dpi=300, bbox_inches="tight")


def plot_omp_dense(meas_aoa, meas_aod, meas_rss, aoa_grid, aod_grid, paths,
                   output_path) -> Path:
    """Before / after: the linear-interpolated samples against the sparse
    impulse map blurred at sigma 1 (the omp_dense estimator's figure)."""
    from scipy.interpolate import griddata
    from scipy.ndimage import gaussian_filter

    plt = _pyplot()
    rows = paths.to_dict("records")
    gx, gy = np.meshgrid(aod_grid, aoa_grid)
    grid_z0 = griddata(np.stack([meas_aod, meas_aoa], axis=1), meas_rss, (gx, gy),
                       method="linear", fill_value=0)
    clean = np.zeros((len(aoa_grid), len(aod_grid)))
    for row in rows:
        i = int(np.abs(aoa_grid - row["AoA"]).argmin())
        j = int(np.abs(aod_grid - row["AoD"]).argmin())
        clean[i, j] = row["Power"]
    if rows:
        clean = gaussian_filter(clean, sigma=1.0)

    fig, axes = plt.subplots(1, 2, figsize=(18, 8))
    ext = [aod_grid.min(), aod_grid.max(), aoa_grid.min(), aoa_grid.max()]
    im1 = axes[0].imshow(grid_z0, extent=ext, origin="lower", aspect="auto", cmap="viridis")
    axes[0].set_title("1. 原始插值热力图 (含旁瓣干扰)", fontsize=14, fontweight="bold")
    axes[0].set_xlabel("AoD (出发角)", fontsize=12)
    axes[0].set_ylabel("AoA (到达角)", fontsize=12)
    fig.colorbar(im1, ax=axes[0], label="RSS (Linear Power)")
    axes[0].grid(alpha=0.3)

    im2 = axes[1].imshow(clean, extent=ext, origin="lower", aspect="auto", cmap="inferno")
    axes[1].set_title(f"2. 稀疏重构热力图 (去噪与锐化)\n发现 {len(rows)} 条显著路径",
                      fontsize=14, fontweight="bold")
    axes[1].set_xlabel("AoD (出发角)", fontsize=12)
    axes[1].set_ylabel("AoA (到达角)", fontsize=12)
    fig.colorbar(im2, ax=axes[1], label="RSS (Linear Power)")
    for label, color, marker, s in (("LoS", "red", "o", 200), ("NLoS", "cyan", "x", 100)):
        sub = [r for r in rows if r.get("Type") == label]
        if sub:
            axes[1].scatter([r["AoD"] for r in sub], [r["AoA"] for r in sub], s=s, c=color,
                            marker=marker, linewidth=2, label=label)
    for row in rows:
        axes[1].text(row["AoD"] + 2, row["AoA"] + 2,
                     f"{row.get('Type', '?')}\n({row['AoD']:.1f}, {row['AoA']:.1f})",
                     color="white", fontsize=9, fontweight="bold")
    axes[1].legend(loc="upper right")
    axes[1].grid(alpha=0.2)
    fig.tight_layout()
    return _save(fig, plt, output_path, dpi=300, bbox_inches="tight")


def plot_lasso_refine(aoa_grid, aod_grid, heat, classification, output_path) -> Path:
    """The refined map with the classified peaks (the lasso_refine
    estimator's figure)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(12, 9))
    im = plt.imshow(heat, extent=[aoa_grid.min(), aoa_grid.max(), aod_grid.min(),
                                  aod_grid.max()],
                    origin="lower", aspect="auto", cmap="hot", interpolation="bilinear")
    plt.colorbar(im, label="RSS (dBm)")
    plt.xlabel("AoA (deg)", fontsize=12)
    plt.ylabel("AoD (deg)", fontsize=12)
    plt.title("AoA-AoD Heatmap with Multipath Components", fontsize=14, fontweight="bold")
    colors = {"Likely LoS": "lime", "Likely NLoS": "cyan", "Candidate LoS": "yellow",
              "Candidate NLoS": "orange"}
    for peak in classification:
        i, j = peak["idx"]
        aoa_v, aod_v = aoa_grid[j], aod_grid[i]
        plt.plot(aoa_v, aod_v, "o", color=colors.get(peak["type"], "white"), markersize=10,
                 markeredgecolor="black", markeredgewidth=1.5)
        plt.text(aoa_v, aod_v + 2, f"{peak['type']}\n{peak['power']:.1f}dBm", color="white",
                 fontsize=9, ha="center",
                 bbox=dict(boxstyle="round,pad=0.3", facecolor="black", alpha=0.6))
    plt.grid(True, alpha=0.3, linestyle="--")
    plt.tight_layout()
    return _save(fig, plt, output_path, dpi=300, bbox_inches="tight")


def plot_peak_picking(heat, aod_grid, aoa_grid, paths, output_path) -> Path:
    """The heatmap with the LoS and NLoS peaks and the y = x guide (the
    peak_picking estimator's figure)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(9, 7))
    im = ax.imshow(heat, origin="lower", aspect="auto",
                   extent=[aod_grid.min(), aod_grid.max(), aoa_grid.min(), aoa_grid.max()])
    fig.colorbar(im, ax=ax).set_label("RSS (dB)")
    ax.set_xlabel("AoD (deg)")
    ax.set_ylabel("AoA (deg)")
    ax.set_title("AoA–AoD RSS Heatmap with Dominant Paths")
    for row in paths.to_dict("records"):
        if row["Type"] == "LoS":
            ax.scatter(row["AoD"], row["AoA"], s=160, marker="*", edgecolors="k", label="LoS")
            ax.annotate(f"LoS\n({row['AoD']:.1f}°, {row['AoA']:.1f}°)",
                        xy=(row["AoD"], row["AoA"]), xytext=(row["AoD"] + 4, row["AoA"] + 4),
                        arrowprops=dict(arrowstyle="->"), fontsize=10)
        else:
            ax.scatter(row["AoD"], row["AoA"], s=80, marker="o", edgecolors="k")
            ax.annotate(f"NLoS\n({row['AoD']:.1f}°, {row['AoA']:.1f}°)",
                        xy=(row["AoD"], row["AoA"]), xytext=(row["AoD"] + 3, row["AoA"] - 5),
                        arrowprops=dict(arrowstyle="->"), fontsize=9)
    lo = max(aod_grid.min(), aoa_grid.min())
    hi = min(aod_grid.max(), aoa_grid.max())
    ax.plot([lo, hi], [lo, hi], linestyle="--", linewidth=1)
    ax.legend()
    fig.tight_layout()
    return _save(fig, plt, output_path, dpi=150)


def plot_geometric(AOA, AOD, rss_grid, paths, output_path, max_annotations: int = 50) -> Path:
    """The normalised grid with the strongest ``max_annotations`` peaks
    annotated (the geometric estimator's figure; the reference annotates
    every peak, tens of thousands on a real session)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(10, 8))
    plt.pcolormesh(AOA, AOD, rss_grid, shading="gouraud", cmap="hot")
    plt.colorbar(label="Normalized RSS (dB)")
    plt.xlabel("AoA (degrees)")
    plt.ylabel("AoD (degrees)")
    plt.title("AoA-AoD Heatmap")
    rows = paths.to_dict("records")
    order = np.argsort([-r["Power_dB"] for r in rows], kind="stable")[:max_annotations]
    for k in order:
        path = rows[k]
        plt.scatter(path["AoA"], path["AoD"], color="blue" if path["Type"] == "LoS" else "green")
        plt.text(path["AoA"], path["AoD"], f"{path['Type']} {path['Power_dB']:.1f}dB")
    return _save(fig, plt, output_path)


def plot_v13_comparison(original, processed, ue_ang, bs_ang, classified, output_path,
                        method: str, device=None) -> Path:
    """The v1-3 original-against-optimised panels: 150 x 150 thin-plate RBF
    backgrounds (``ops/interp`` on ``device``, a zero background where the
    system is singular), the optimised one with PowerNorm(0.5) on "hot",
    the LoS a red circle on both (the nn_omp_v13 estimator's figure)."""
    import torch
    from matplotlib.colors import PowerNorm

    from slam_process_tpu_torch.models.classifiers import LOS
    from slam_process_tpu_torch.ops.interp import rbf_interpolate_grid
    from slam_process_tpu_torch.pipeline.device import resolve_device

    plt = _pyplot()
    dev = resolve_device(device)
    grid_x = np.linspace(float(np.min(bs_ang)), float(np.max(bs_ang)), 150)
    grid_y = np.linspace(float(np.min(ue_ang)), float(np.max(ue_ang)), 150)
    mx, my = np.meshgrid(grid_x, grid_y)
    fig, axes = plt.subplots(1, 2, figsize=(20, 8))
    for ax, mat, use_processed, suffix in ((axes[0], original, False, "Original"),
                                           (axes[1], processed, True, "Optimized")):
        values = torch.as_tensor(np.asarray(mat, dtype=np.float64), device=dev)
        try:
            heat = rbf_interpolate_grid(bs_ang, ue_ang, values, grid_x, grid_y, smooth=0.0,
                                        kernel="thin_plate").cpu().numpy()
        except torch.linalg.LinAlgError:   # the v1 lineage's fallback
            heat = np.zeros((150, 150))
        cf = ax.contourf(mx, my, heat, levels=80, cmap="hot" if use_processed else "viridis",
                         norm=PowerNorm(gamma=0.5) if use_processed else None)
        fig.colorbar(cf, ax=ax, label="RSS Power")
        los = np.nonzero(np.asarray(classified.label) == LOS)[0]
        if los.size:
            ax.scatter(classified.aod[los], classified.aoa[los], c="red", marker="o", s=200,
                       edgecolors="white", linewidth=2, label="LoS", zorder=5)
            ax.legend()
        ax.set_xlabel("AoD [deg]", fontsize=11)
        ax.set_ylabel("AoA [deg]", fontsize=11)
        ax.set_title(f"Heatmap - {suffix} Data", fontsize=13, fontweight="bold")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    return _save(fig, plt, output_path, dpi=300, bbox_inches="tight")
