"""LASSO-refined heatmap estimator.

The port of ``slam_process_tpu/models/lasso_refine.py``.  The pair means
of the mapped rows (rows with an unmapped beam dropped before the mean),
linear interpolation onto a 1 deg grid with the nearest sample outside the
hull, Savitzky-Golay rows (window 7, order 2); the 65th-percentile
local-max regions (``ops/peaks.peak_regions_np``); around each of up to 20
peaks a +-3-cell patch deconvolved by positive LASSO against a Gaussian
beam-gain design (beam width 10 deg, alpha 0.1, unit-norm columns); the
final map 0.6 refined + 0.4 initial, its peaks again, classified by the
strongest against the second (ratio 1.5).

  * ``refine_patches``: the host engine, one ``lasso_positive_np`` per
    patch (tol-stopped), the design in the table angles' float32 as the
    JAX package's numpy computes it.
  * ``refine_patches_device``: every patch padded to 7 x 7 (the columns
    outside the clamped bounds zero, which the descent leaves at zero) and
    solved in one batched call on the card in float64 (a fixed 200 sweeps:
    ``lasso_program``, JAX's jitted vmapped solve, a set-up graph and a
    one-sweep graph replayed 200 times), with only the [P, 49]
    coefficients read back.  The interpolation, the regions and the table
    stay on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_process_tpu_torch.io.angles import load_angle_lut
from slam_process_tpu_torch.models.registry import Table, pair_means, session_rows
from slam_process_tpu_torch.ops.lasso import lasso_gram, lasso_positive_np, lasso_sweep_
from slam_process_tpu_torch.ops.peaks import peak_regions_np, savgol_rows
from slam_process_tpu_torch.pipeline.device import resolve_device
from slam_process_tpu_torch.utils.graphs import GraphProgram, GraphRunner, program_cache

N_SWEEPS = 200   # the device engine's fixed sweep count (JAX's lasso_positive_jax)


def beam_gain(angle_deg, center_deg, beamwidth_deg: float = 10.0):
    sigma = beamwidth_deg / 2.355
    return np.exp(-0.5 * ((angle_deg - center_deg) / sigma) ** 2)


def mapped_row_means(session, angle_file, device=None):
    """(AoA, AoD, mean RSS) of the (UE, BS) pairs of the rows whose beams
    are both mapped (unmapped rows dropped before the mean), in pandas'
    group order; the angles are the table's float32."""
    ue, bs, rss = session_rows(session, device)
    lut = load_angle_lut(angle_file)
    ue = np.asarray(ue, dtype=np.int64)
    bs = np.asarray(bs, dtype=np.int64)
    keep = ~(np.isnan(lut[ue]) | np.isnan(lut[bs]))
    ue_k, bs_k, means = pair_means(ue[keep], bs[keep], np.asarray(rss)[keep] * 1.0)
    return lut[ue_k], lut[bs_k], means


def make_heatmap_interpolated(aoa, aod, rss, grid_res: float = 1.0, smooth: bool = True):
    """Linear griddata, the nearest sample outside the hull, savgol rows
    (host).  Rows are AoD, columns AoA."""
    from scipy.interpolate import griddata

    aoa_grid = np.arange(aoa.min(), aoa.max() + grid_res, grid_res)
    aod_grid = np.arange(aod.min(), aod.max() + grid_res, grid_res)
    AOA, AOD = np.meshgrid(aoa_grid, aod_grid, indexing="xy")
    pts = np.stack([aoa, aod], axis=1)
    gp = np.stack([AOA.ravel(), AOD.ravel()], axis=1)
    lin = griddata(pts, rss, gp, method="linear", fill_value=np.nan)
    near = griddata(pts, rss, gp, method="nearest")
    heat = np.where(np.isnan(lin), near, lin).reshape(AOA.shape)
    if smooth and heat.shape[1] >= 3:
        win = 7 if heat.shape[1] >= 7 else (heat.shape[1] // 2 * 2 + 1)
        if win >= 3:
            heat = savgol_rows(heat, win, min(2, win - 1))
    return aoa_grid, aod_grid, heat


def refine_patches(meas_aoa, meas_aod, meas_rss, aoa_grid, aod_grid, heat_init, peaks,
                   patch_half: int = 3, beamwidth: float = 10.0, alpha: float = 0.1,
                   max_peaks: int = 20):
    """Host engine: a positive LASSO over each peak's clamped patch."""
    refined = np.zeros_like(heat_init)
    for pk in peaks[:max_peaks]:
        r0, c0 = pk["idx"]
        r1, r2 = max(0, r0 - patch_half), min(heat_init.shape[0] - 1, r0 + patch_half)
        c1, c2 = max(0, c0 - patch_half), min(heat_init.shape[1] - 1, c0 + patch_half)
        g_aod = aod_grid[r1:r2 + 1]
        g_aoa = aoa_grid[c1:c2 + 1]
        cols = [beam_gain(meas_aoa, aoa, beamwidth) * beam_gain(meas_aod, aod, beamwidth)
                for aod in g_aod for aoa in g_aoa]
        G = np.column_stack(cols)
        norms = np.linalg.norm(G, axis=0) + 1e-8
        coef = lasso_positive_np(G / norms, meas_rss, alpha) / norms
        refined[r1:r2 + 1, c1:c2 + 1] += coef.reshape(len(g_aod), len(g_aoa))
    return refined


def patch_layout(heat_shape, peaks, patch_half: int = 3, max_peaks: int = 20):
    """The padded patches of up to ``max_peaks`` peaks: (rows [P, s], cols
    [P, s], row_ok [P, s], col_ok [P, s]) with s = 2 patch_half + 1."""
    H, W = heat_shape
    P = min(len(peaks), max_peaks)
    s = 2 * patch_half + 1
    r0 = np.array([p["idx"][0] for p in peaks[:P]], dtype=np.int64).reshape(P)
    c0 = np.array([p["idx"][1] for p in peaks[:P]], dtype=np.int64).reshape(P)
    r1, r2 = np.maximum(0, r0 - patch_half), np.minimum(H - 1, r0 + patch_half)
    c1, c2 = np.maximum(0, c0 - patch_half), np.minimum(W - 1, c0 + patch_half)
    rows = r1[:, None] + np.arange(s)[None, :]
    cols = c1[:, None] + np.arange(s)[None, :]
    return rows, cols, rows <= r2[:, None], cols <= c2[:, None]


def patch_setup(meas_aoa: torch.Tensor, meas_aod: torch.Tensor, meas_rss: torch.Tensor,
                aoa_cent: torch.Tensor, aod_cent: torch.Tensor, ok: torch.Tensor,
                beamwidth: float = 10.0):
    """The padded patches' LASSO set-up: the Gaussian design [P, M, 49]
    (columns where ``ok`` is False zero), its unit-norm columns and
    ``ops/lasso.lasso_gram`` of them; returns (G, b, diag, live, safe,
    norms [P, 49]) on the inputs' device in float64."""
    sigma = beamwidth / 2.355
    da = (meas_aoa[None, :, None] - aoa_cent[:, None, :]) / sigma
    dd = (meas_aod[None, :, None] - aod_cent[:, None, :]) / sigma
    G = torch.exp(-0.5 * (da * da + dd * dd)) * ok[:, None, :]
    norms = torch.linalg.vector_norm(G, dim=1) + 1e-8           # [P, 49]
    y = meas_rss[None, :].expand(G.shape[0], -1)
    return (*lasso_gram(G / norms[:, None, :], y), norms)


def patch_lasso_torch(meas_aoa: torch.Tensor, meas_aod: torch.Tensor, meas_rss: torch.Tensor,
                      aoa_cent: torch.Tensor, aod_cent: torch.Tensor, ok: torch.Tensor,
                      beamwidth: float = 10.0, alpha: float = 0.1) -> torch.Tensor:
    """[P, 49] coefficients of the padded patches, eagerly: ``patch_setup``,
    ``N_SWEEPS`` of ``ops/lasso.lasso_sweep_``, rescaled by the norms
    (``lasso_positive_torch`` on the unit-norm design, divided by the
    norms); on the inputs' device in float64.  ``LassoProgram``'s eager
    body."""
    *gram, norms = patch_setup(meas_aoa, meas_aod, meas_rss, aoa_cent, aod_cent, ok, beamwidth)
    w = torch.zeros_like(gram[1])
    for _ in range(N_SWEEPS):
        lasso_sweep_(w, *gram, alpha)
    return w / norms


class LassoProgram(GraphProgram):
    """``patch_lasso_torch`` as two compiled programs per input signature
    (the JAX package's ``jit_highest(vmap(solve))``), through
    ``utils/graphs.GraphProgram``: on a CUDA device the set-up
    (``patch_setup``, which writes the fixed terms into buffers the program
    owns and zeroes w) is one CUDA graph and one full sweep
    (``lasso_sweep_`` on those buffers, w in place) another, replayed
    ``N_SWEEPS`` times, so a solve is 1 + ``N_SWEEPS`` graph launches, not
    ~``N_SWEEPS`` x 49 x 10 operations issued one by one.  A call returns
    the coefficients w / norms after the last sweep as a tensor of its own.
    On the CPU a call runs ``patch_lasso_torch``."""

    def __init__(self, beamwidth: float, alpha: float, device, max_graphs: int):
        super().__init__(lambda *x: patch_lasso_torch(*x, beamwidth, alpha), device, max_graphs)
        self.beamwidth, self.alpha = beamwidth, alpha

    def compile(self, xs: list):
        """(set-up runner, sweep runner, w, norms) of one signature."""
        p, k = xs[3].shape
        dev, f64 = self.device, torch.float64
        state = [torch.empty((p, k, k), dtype=f64, device=dev),
                 *(torch.empty((p, k), dtype=d, device=dev)
                   for d in (f64, f64, torch.bool, f64, f64))]
        w = torch.empty((p, k), dtype=f64, device=dev)
        beamwidth, alpha = self.beamwidth, self.alpha

        def setup(*inputs):
            for dst, src in zip(state, patch_setup(*inputs, beamwidth)):
                dst.copy_(src)
            w.zero_()

        return (GraphRunner(setup, xs),
                GraphRunner(lambda: lasso_sweep_(w, *state[:5], alpha), device=dev), w, state[5])

    def replay(self, compiled, xs):
        setup, sweep, w, norms = compiled
        setup(*xs)
        for _ in range(N_SWEEPS):
            sweep.run()
        return w / norms, None


@program_cache(8)
def lasso_program(beamwidth: float, alpha: float, device=None) -> LassoProgram:
    """The LASSO program of one (beam width, alpha) on ``device`` (None:
    CUDA).  The JAX package builds a fresh jitted solve per call; the port
    keeps 8 programs of 8 signatures each."""
    return LassoProgram(beamwidth, alpha, device, 8)


def patch_inputs(meas_aoa, meas_aod, meas_rss, aoa_grid, aod_grid, heat_shape, peaks,
                 patch_half: int = 3, max_peaks: int = 20):
    """The device engine's inputs of up to ``max_peaks`` peaks' padded
    patches: (meas_aoa, meas_aod, meas_rss [M], aoa_cent, aod_cent, ok [P,
    s * s]) as float64 CPU tensors, cells in row-major (aod, aoa) order (the
    host's cyclic-descent order), and ``patch_layout``'s (rows, cols,
    row_ok, col_ok); None for no peak."""
    layout = patch_layout(heat_shape, peaks, patch_half, max_peaks)
    rows, cols, row_ok, col_ok = layout
    P, s = rows.shape
    if P == 0:
        return None, layout
    H, W = heat_shape
    valid = (row_ok[:, :, None] & col_ok[:, None, :]).reshape(P, s * s)
    aod_c = np.broadcast_to(aod_grid[np.minimum(rows, H - 1)][:, :, None], (P, s, s))
    aoa_c = np.broadcast_to(aoa_grid[np.minimum(cols, W - 1)][:, None, :], (P, s, s))
    return [torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64)) for x in (
        meas_aoa, meas_aod, meas_rss, aoa_c.reshape(P, s * s), aod_c.reshape(P, s * s),
        valid)], layout


def refine_patches_device(meas_aoa, meas_aod, meas_rss, aoa_grid, aod_grid, heat_shape, peaks,
                          patch_half: int = 3, beamwidth: float = 10.0, alpha: float = 0.1,
                          max_peaks: int = 20, device=None):
    """Device engine of ``refine_patches``: the padded patches
    (``patch_inputs``) solved in one call of ``lasso_program`` on ``device``
    (None: CUDA), the [P, 49] coefficients read back and added into the
    refined map on the host."""
    dev = resolve_device(device)
    refined = np.zeros(heat_shape)
    inputs, (rows, cols, row_ok, col_ok) = patch_inputs(
        meas_aoa, meas_aod, meas_rss, aoa_grid, aod_grid, heat_shape, peaks, patch_half,
        max_peaks)
    if inputs is None:
        return refined
    coefs = lasso_program(beamwidth, alpha, device=dev)(*inputs).cpu().numpy()
    s = rows.shape[1]
    for p in range(rows.shape[0]):
        w = coefs[p].reshape(s, s)
        for i in np.nonzero(row_ok[p])[0]:
            for j in np.nonzero(col_ok[p])[0]:
                refined[rows[p, i], cols[p, j]] += w[i, j]
    return refined


def classify_peaks(peaks_sorted, ratio_thresh: float = 1.5):
    """The strongest peak against the second: Likely LoS / NLoS when it
    leads by ``ratio_thresh``, else Candidate LoS / NLoS (up to 6)."""
    out = []
    if not peaks_sorted:
        return out
    top = peaks_sorted[0]
    second = peaks_sorted[1]["power"] if len(peaks_sorted) > 1 else -np.inf
    if top["power"] > ratio_thresh * second:
        out.append({**top, "type": "Likely LoS"})
        out.extend({**p, "type": "Likely NLoS"} for p in peaks_sorted[1:6])
    else:
        for i, p in enumerate(peaks_sorted[:6]):
            out.append({**p, "type": "Candidate LoS" if i == 0 else "Candidate NLoS"})
    return out


def run_lasso_refine(session, angle_file, output_path=None, **overrides) -> Table:
    """The ``lasso_refine`` entry: the table (AoA, AoD, Power, Type) of the
    classified peaks of the refined map, no columns where there is none;
    with ``output_path`` the figure (needs matplotlib)."""
    engine = overrides.get("engine", "device")
    device = overrides.get("device")
    aoa, aod, rss = mapped_row_means(session, angle_file, device)
    aoa_grid, aod_grid, heat_init = make_heatmap_interpolated(
        aoa, aod, rss, grid_res=overrides.get("grid_res", 1.0))
    q = overrides.get("percentile", 65.0)
    peaks = peak_regions_np(heat_init, q)
    kw = dict(beamwidth=overrides.get("beam_width", 10.0), alpha=overrides.get("alpha", 0.1))
    if engine == "device":
        refined = refine_patches_device(aoa, aod, rss, aoa_grid, aod_grid, heat_init.shape,
                                        peaks, device=device, **kw)
    elif engine == "host":
        refined = refine_patches(aoa, aod, rss, aoa_grid, aod_grid, heat_init, peaks, **kw)
    else:
        raise ValueError(f"unknown engine {engine!r}; use 'device' or 'host'")
    heat_final = 0.6 * refined + 0.4 * heat_init
    classification = classify_peaks(peak_regions_np(heat_final, q),
                                    overrides.get("ratio_thresh", 1.5))
    if output_path is not None:
        from slam_process_tpu_torch.render.estimators import plot_lasso_refine

        plot_lasso_refine(aoa_grid, aod_grid, heat_final, classification, output_path)
    if not classification:
        return Table({})
    return Table({"AoA": np.array([float(aoa_grid[p["idx"][1]]) for p in classification]),
                  "AoD": np.array([float(aod_grid[p["idx"][0]]) for p in classification]),
                  "Power": np.array([p["power"] for p in classification]),
                  "Type": [p["type"] for p in classification]})
