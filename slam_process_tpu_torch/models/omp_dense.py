"""Dense-dictionary OMP sparse deconvolution.

The port of ``slam_process_tpu/models/omp_dense.py``.  The reference
builds a [M, Ga * Gd] dictionary of separable Gaussian atoms over the
pair samples, normalises its columns and runs sklearn's OMP with 5
nonzero coefficients.  The atoms are separable, so the dictionary is never
built: its column norms are sqrt((rx^2)^T tx^2) and each iteration's
correlations one [Ga, M] @ [M, Gd] chain ``(rx * r)^T tx / norms``.

  * ``omp_dense_np``: the float64 numpy oracle (sklearn's selection, an
    ``lstsq`` refit, coefficients in the normalised scale; the reference
    keeps the positive ones).
  * ``omp_dense_torch``: the counterpart of ``omp_dense_jax``, on the
    inputs' device in float64 (JAX's is float32): K iterations with no
    host read, the |corr| argmax (``torch.argmax``: the first flat
    maximum, as numpy) masked against reselection and restricted to the
    atoms JAX calls observable (norm > 1e-15), the refit on the masked [K,
    K] Gram of the selected unit-norm columns with an identity block on
    the slots not selected yet (their coefficients exactly 0).  The refit
    solves the normal equations where the oracle takes ``lstsq``.

Defaults from the reference: grid 0.5 deg, beam width 1.4 deg, 5 paths,
LoS where the power reaches 0.8 of the largest.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_process_tpu_torch.models.dictionary import gaussian_beam
from slam_process_tpu_torch.models.peak_picking import mapped_pair_means
from slam_process_tpu_torch.models.registry import Table


class DenseOmpPaths(NamedTuple):
    aoa: np.ndarray
    aod: np.ndarray
    power: np.ndarray       # coefficient in the reference's (normalised) scale
    valid: np.ndarray


def omp_dense_np(meas_aoa: np.ndarray, meas_aod: np.ndarray, y: np.ndarray,
                 aoa_grid: np.ndarray, aod_grid: np.ndarray, beam_width: float = 1.4,
                 n_paths: int = 5) -> DenseOmpPaths:
    """Separable OMP == sklearn's OMP on the normalised dense dictionary
    (float64 host oracle)."""
    rx = gaussian_beam(meas_aoa[:, None], aoa_grid[None, :], beam_width)
    tx = gaussian_beam(meas_aod[:, None], aod_grid[None, :], beam_width)
    norms = np.sqrt(np.einsum("mg,mh->gh", rx**2, tx**2))
    norms = np.maximum(norms, 1e-300)

    Gd = len(aod_grid)
    selected: list = []
    cols: list = []
    residual = y.astype(np.float64).copy()
    coefs = np.zeros(0)
    for _ in range(n_paths):
        corr = np.einsum("m,mg,mh->gh", residual, rx, tx) / norms
        corr_flat = np.abs(corr).ravel()
        for g, h in selected:          # sklearn never reselects a column
            corr_flat[g * Gd + h] = -np.inf
        j = int(np.argmax(corr_flat))
        g, h = j // Gd, j % Gd
        selected.append((g, h))
        cols.append(rx[:, g] * tx[:, h] / norms[g, h])
        A = np.stack(cols, axis=1)
        coefs, *_ = np.linalg.lstsq(A, y, rcond=None)
        residual = y - A @ coefs

    aoa = np.array([aoa_grid[g] for g, _ in selected])
    aod = np.array([aod_grid[h] for _, h in selected])
    return DenseOmpPaths(aoa, aod, coefs, coefs > 0)


def gaussian_beam_torch(x: torch.Tensor, center: torch.Tensor, width: float) -> torch.Tensor:
    """``dictionary.gaussian_beam`` on tensors."""
    sigma = width / 2.355
    d = x - center
    return torch.exp(-(d * d) / (2.0 * sigma * sigma))


def omp_dense_torch(rx: torch.Tensor, tx: torch.Tensor, y: torch.Tensor,
                    aoa_grid: torch.Tensor, aod_grid: torch.Tensor,
                    n_paths: int = 5) -> DenseOmpPaths:
    """Separable OMP on rx [M, Ga], tx [M, Gd] (the Gaussian responses)
    and y [M], on their device in float64: [K] tensors of the selected
    atoms' grid angles, their coefficients and ``coefficient > 0``."""
    rx, tx, yf = rx.to(torch.float64), tx.to(torch.float64), y.to(torch.float64)
    K = n_paths
    Ga, Gd = rx.shape[1], tx.shape[1]
    dev = rx.device
    norms = torch.sqrt((rx * rx).T @ (tx * tx))            # [Ga, Gd]
    observable = (norms > 1e-15).reshape(-1)
    norms = torch.clamp(norms, min=1e-30)
    taken = torch.zeros(Ga * Gd, dtype=torch.bool, device=dev)
    sel = torch.zeros(K, dtype=torch.int64, device=dev)
    slots = torch.arange(K, device=dev)
    residual = yf
    coeffs = torch.zeros(K, dtype=torch.float64, device=dev)
    for it in range(K):
        corr = ((rx * residual[:, None]).T @ tx) / norms
        acorr = torch.where(observable & ~taken, corr.abs().reshape(-1), -torch.inf)
        flat = torch.argmax(acorr)
        taken.index_fill_(0, flat[None], True)   # a tensor index: no host read
        sel[it] = flat
        g, h = sel // Gd, sel % Gd
        active = slots <= it
        A = (rx[:, g] * tx[:, h] / norms[g, h][None, :]) * active[None, :]   # [M, K]
        G = A.T @ A + torch.diag(1.0 - active.to(torch.float64))
        coeffs = torch.linalg.solve(G, A.T @ yf)
        residual = yf - A @ coeffs
    g, h = sel // Gd, sel % Gd
    return DenseOmpPaths(aoa_grid[g], aod_grid[h], coeffs, coeffs > 0)


def run_omp_dense(meas_aoa: np.ndarray, meas_aod: np.ndarray, y: np.ndarray,
                  aoa_grid: np.ndarray, aod_grid: np.ndarray, beam_width: float = 1.4,
                  n_paths: int = 5, engine: str = "device", device=None) -> DenseOmpPaths:
    """One entry point for both engines, numpy results: ``"device"`` builds
    the responses and runs ``omp_dense_torch`` on ``device`` (None: CUDA)
    in float64 and reads the four [K] results back in one copy;
    ``"host"`` is ``omp_dense_np``."""
    if engine == "host":
        return omp_dense_np(meas_aoa, meas_aod, y, aoa_grid, aod_grid, beam_width, n_paths)
    if engine != "device":
        raise ValueError(f"unknown engine {engine!r}; use 'device' or 'host'")
    from slam_process_tpu_torch.pipeline.device import resolve_device

    dev = resolve_device(device)
    ma, md, yt, ga, gd = (torch.from_numpy(np.asarray(x, dtype=np.float64)).to(dev)
                          for x in (meas_aoa, meas_aod, y, aoa_grid, aod_grid))
    rx = gaussian_beam_torch(ma[:, None], ga[None, :], beam_width)
    tx = gaussian_beam_torch(md[:, None], gd[None, :], beam_width)
    out = omp_dense_torch(rx, tx, yt, ga, gd, n_paths)
    host = torch.stack([out.aoa, out.aod, out.power, out.valid.to(torch.float64)]).cpu().numpy()
    return DenseOmpPaths(host[0], host[1], host[2], host[3] > 0)


def run_omp_dense_estimator(session, angle_file, output_path=None, **overrides) -> Table:
    """The ``omp_dense`` entry: the table (AoA, AoD, Power, Type) of the
    positive coefficients, Type (LoS at >= 0.8 of the largest, else NLoS)
    only where there is a row; with ``output_path`` the before / after
    figure (needs matplotlib)."""
    device = overrides.get("device")
    aoa, aod, rss = mapped_pair_means(session, angle_file, device)
    grid_res = overrides.get("grid_res", 0.5)
    beam_width = overrides.get("beam_width", 1.4)
    aoa_grid = np.arange(aoa.min(), aoa.max(), grid_res)
    aod_grid = np.arange(aod.min(), aod.max(), grid_res)
    paths = run_omp_dense(aoa, aod, rss, aoa_grid, aod_grid, beam_width,
                          overrides.get("max_paths", 5), engine=overrides.get("engine", "device"),
                          device=device)
    keep = paths.valid
    cols = {"AoA": paths.aoa[keep], "AoD": paths.aod[keep], "Power": paths.power[keep]}
    if keep.any():
        margin = overrides.get("los_power_margin", 0.8)
        cols["Type"] = np.where(cols["Power"] >= cols["Power"].max() * margin,
                                "LoS", "NLoS").tolist()
    out = Table(cols)
    if output_path is not None:
        from slam_process_tpu_torch.render.estimators import plot_omp_dense

        plot_omp_dense(aoa, aod, rss, aoa_grid, aod_grid, out, output_path)
    return out
