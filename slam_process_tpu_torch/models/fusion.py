"""Fusion estimator: the v1 NN-OMP LoS and SM-SIC NLoS.

The port of ``slam_process_tpu/models/fusion.py``.  The LoS is the v1
NN-OMP's strongest kept path (0.1 deg arange grid, beam 1.4 deg, 3 paths,
keep rule "positive"; ``models/nn_omp.run_nn_omp``).  The NLoS paths come
from an SM-SIC over an inclusive-arange 0.1 deg grid whose masks the LoS
seeds (proximity 10 deg, cross width 10 deg), a 1 deg mask around each
NLoS peak, up to 3, stopping below 0.1 of the FIRST NLoS metric from the
second peak on (the LoS metric is not in that list).

  * ``fusion_nlos_np``: the float64 numpy oracle, a ``Table`` (id, type,
    aoa, aod, metric).
  * ``fusion_nlos_torch``: the counterpart of ``fusion_nlos_jax``, on the
    inputs' device in float64 (JAX's is float32): the correlation
    ``phi_rx^T M phi_tx``, the LoS seed masks, and the K-step loop with
    the stop rule kept on the device as masks; [K] tensors.

With ``engine="device"`` the LoS's angles are the float64 grid's at the
NN-OMP's selected indices (the device NN-OMP returns its float32 grid), so
the seed masks are the host's.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_process_tpu_torch.config import DictionaryConfig, OmpConfig
from slam_process_tpu_torch.models.dictionary import make_dictionary
from slam_process_tpu_torch.models.nn_omp import run_nn_omp
from slam_process_tpu_torch.models.registry import Table, build_scene

def nlos_table(ids, aoa, aod, metric) -> Table:
    """The NLoS rows as a Table, no columns where there is none."""
    if len(ids) == 0:
        return Table({})
    return Table({"id": np.asarray(ids, dtype=np.int64), "type": ["NLoS"] * len(ids),
                  "aoa": np.asarray(aoa, dtype=np.float64),
                  "aod": np.asarray(aod, dtype=np.float64),
                  "metric": np.asarray(metric, dtype=np.float64)})


def fusion_nlos_np(dictionary, rss_matrix, los_aoa, los_aod, max_paths: int = 3,
                   proximity: float = 10.0, cross: float = 10.0, local: float = 1.0,
                   stop_ratio: float = 0.1) -> Table:
    """The NLoS SIC loop with the reference's control flow (float64)."""
    corr = dictionary.phi_rx.T @ rss_matrix.astype(np.float64) @ dictionary.phi_tx
    aoa_g, aod_g = dictionary.aoa_grid, dictionary.aod_grid
    AOA, AOD = np.meshgrid(aoa_g, aod_g, indexing="ij")
    mask = np.ones_like(corr)
    if los_aoa is not None:
        dist_sq = (AOA - los_aoa) ** 2 + (AOD - los_aod) ** 2
        mask *= dist_sq > proximity**2
        mask *= np.abs(AOD - los_aod) > cross / 2
        mask *= np.abs(AOA - los_aoa) > cross / 2

    rows = []
    for k in range(max_paths):
        masked = corr * mask
        i, j = np.unravel_index(np.argmax(masked), masked.shape)
        peak = masked[i, j]
        if k > 0 and rows and peak < stop_ratio * rows[0][3]:
            break
        rows.append((k + 1, aoa_g[i], aod_g[j], float(peak)))
        dist_sq = (AOA - aoa_g[i]) ** 2 + (AOD - aod_g[j]) ** 2
        mask *= dist_sq > local**2
    return nlos_table(*zip(*rows)) if rows else nlos_table([], [], [], [])


def fusion_nlos_torch(phi_rx: torch.Tensor, phi_tx: torch.Tensor, aoa_grid: torch.Tensor,
                      aod_grid: torch.Tensor, rss_matrix: torch.Tensor, los_aoa: float,
                      los_aod: float, has_los: bool, max_paths: int = 3,
                      proximity: float = 10.0, cross: float = 10.0, local: float = 1.0,
                      stop_ratio: float = 0.1):
    """(aoa [K], aod [K], metric [K], valid [K]) of the NLoS loop on the
    inputs' device in float64; the LoS seed masks apply when ``has_los``."""
    f64 = torch.float64
    corr = phi_rx.to(f64).T @ rss_matrix.to(f64) @ phi_tx.to(f64)
    Gd = corr.shape[1]
    AOA, AOD = aoa_grid.to(f64)[:, None], aod_grid.to(f64)[None, :]
    mask = torch.ones_like(corr)
    if has_los:
        dist_sq = (AOA - los_aoa) ** 2 + (AOD - los_aod) ** 2
        mask = mask * (dist_sq > proximity**2) * ((AOD - los_aod).abs() > cross / 2) \
            * ((AOA - los_aoa).abs() > cross / 2)
    stopped = torch.zeros(1, dtype=torch.bool, device=corr.device)
    first = torch.zeros(1, dtype=f64, device=corr.device)
    out = []
    for k in range(max_paths):
        masked = (corr * mask).reshape(-1)
        flat = torch.argmax(masked).reshape(1)        # [1] indices: no host read
        peak = masked[flat]
        a, d = AOA[flat // Gd, 0], AOD[0, flat % Gd]
        if k > 0:
            stopped = stopped | (peak < stop_ratio * first)
        else:
            first = peak
        local_mask = ((AOA - a) ** 2 + (AOD - d) ** 2) > local**2
        mask = torch.where(stopped, mask, mask * local_mask)
        out.append((a, d, peak, ~stopped))
    aoa, aod, metric, valid = (torch.cat(col) for col in zip(*out))
    return aoa, aod, metric, valid


def run_fusion(session, angle_file, output_path=None, **overrides) -> Table:
    """The ``fusion`` entry: the table (id, type, aoa, aod, metric) of the
    LoS (id 0) and the NLoS paths; with ``output_path`` the fused figure
    (needs matplotlib).  ``engine="device"`` (default) runs the NN-OMP and
    ``fusion_nlos_torch`` on ``device`` (None: CUDA)."""
    engine = overrides.get("engine", "device")
    device = overrides.get("device")
    if engine not in ("device", "host"):
        raise ValueError(f"unknown engine {engine!r}; use 'device' or 'host'")
    matrix, ue_ang, bs_ang = build_scene(session, angle_file, False, device=device)
    grid_res = overrides.get("grid_res", 0.1)
    beam_width = overrides.get("beam_width", 1.4)
    d_los = make_dictionary(ue_ang, bs_ang, DictionaryConfig(
        grid_res=grid_res, beam_width=beam_width, grid_kind="arange"))
    los = run_nn_omp(d_los, matrix, OmpConfig(max_paths=3), keep_rule="positive",
                     stop_nonpositive=False, engine=engine, device=device)
    kept = np.nonzero(los.valid)[0]
    if kept.size:
        k = kept[np.argmax(los.power[kept])]
        los_aoa = float(d_los.aoa_grid[los.aoa_idx[k]])
        los_aod = float(d_los.aod_grid[los.aod_idx[k]])
        los_power = float(los.power[k])
    else:
        los_aoa = los_aod = los_power = None

    d_nlos = make_dictionary(ue_ang, bs_ang, DictionaryConfig(
        grid_res=grid_res, beam_width=beam_width, grid_kind="arange_inclusive"))
    kw = dict(max_paths=overrides.get("max_paths", 3),
              proximity=overrides.get("proximity_mask_radius", 10.0),
              cross=overrides.get("cross_mask_width", 10.0))
    if engine == "device":
        from slam_process_tpu_torch.pipeline.device import resolve_device

        dev = resolve_device(device)
        res = fusion_nlos_torch(*(torch.from_numpy(np.asarray(x, dtype=np.float64)).to(dev)
                                  for x in (d_nlos.phi_rx, d_nlos.phi_tx, d_nlos.aoa_grid,
                                            d_nlos.aod_grid, matrix)),
                                0.0 if los_aoa is None else los_aoa,
                                0.0 if los_aod is None else los_aod, los_aoa is not None,
                                **kw)
        a, d, m, v = torch.stack([x.to(torch.float64) for x in res]).cpu().numpy()
        keep = np.nonzero(v > 0)[0]
        nlos = nlos_table(keep + 1, a[keep], d[keep], m[keep])
    else:
        nlos = fusion_nlos_np(d_nlos, matrix, los_aoa, los_aod, **kw)

    if output_path is not None:
        from slam_process_tpu_torch.render.estimation import fusion_plot

        los_pts = [(los_aod, los_aoa)] if los_aoa is not None else []
        nlos_pts = list(zip(nlos["aod"], nlos["aoa"])) if len(nlos) else []
        fusion_plot(matrix, ue_ang, bs_ang, los_pts, nlos_pts, output_path, device=device)
    if los_aoa is None:
        return nlos
    los_row = Table({"id": np.array([0]), "type": ["LoS"], "aoa": np.array([los_aoa]),
                     "aod": np.array([los_aod]), "metric": np.array([los_power])})
    return los_row.concat(nlos)
