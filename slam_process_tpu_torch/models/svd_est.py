"""SVD rank-1 decomposition estimator.

The port of ``slam_process_tpu/models/svd_est.py``.  The raw [max_ue + 1,
max_bs + 1] matrix holds each (UE, BS) pair's mean RSS over the observed
minimum; BS angles come from the angle table (0 where unmapped), UE angles
are a linspace over the BS range.  A not-a-knot bicubic spline upsamples
it to 90 x 180 (``ops/interp``), then the SVD of max(grid, 0): the rank is
where the cumulative energy reaches 90 %, and each rank-1 component's
|max| cell is a path.  The first singular component is the LoS, later ones
NLoS within 10x of its power, "weak" below.

  * ``svd_paths``: the float64 numpy oracle.
  * ``svd_paths_torch``: the counterpart of ``svd_paths_jax``, on the
    heat tensor's device in float64 (``torch.linalg.svd``; the JAX engine
    is float32): the rank and the 16 components' |max| cells vectorised
    over k, with no host read.  The singular vectors' signs are free, and
    S[k] outer(U[:, k], Vt[k]) cancels them.

The matrix, the spline upsample and the table are host numpy in both
engines, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_process_tpu_torch.io.angles import load_angle_lut
from slam_process_tpu_torch.models.registry import Table, pair_means, session_rows
from slam_process_tpu_torch.ops.interp import bicubic_spline_resample


class SvdPaths(NamedTuple):
    aoa: np.ndarray
    aod: np.ndarray
    power: np.ndarray
    singular: np.ndarray
    valid: np.ndarray


def build_raw_matrix(ue, bs, rss, angle_lut: np.ndarray):
    """(raw [max_ue + 1, max_bs + 1], ue_angles, bs_angles, min_rss): the
    pair means over the observed minimum, the BS angles from the table (0
    where unmapped or out of it), the UE angles a linspace over their
    range."""
    ue_k, bs_k, means = pair_means(ue, bs, rss)
    max_ue, max_bs = int(ue_k.max()), int(bs_k.max())
    min_rss = float(means.min())
    raw = np.full((max_ue + 1, max_bs + 1), min_rss)
    raw[ue_k, bs_k] = means
    # The list keeps numpy's dtype rule: float32 where every beam is
    # mapped, float64 once a 0.0 joins.
    bs_angles = np.array([
        angle_lut[i] if i < len(angle_lut) and np.isfinite(angle_lut[i]) else 0.0
        for i in range(max_bs + 1)
    ])
    ue_angles = np.linspace(bs_angles.min(), bs_angles.max(), max_ue + 1)
    return raw, ue_angles, bs_angles, min_rss


def svd_upsample(raw, ue_angles, bs_angles, min_rss, n_ue: int = 90, n_bs: int = 180):
    """The spline upsample onto (n_ue, n_bs) linspace grids, floored at
    ``min_rss`` (host)."""
    grid_bs = np.linspace(bs_angles.min(), bs_angles.max(), n_bs)
    grid_ue = np.linspace(ue_angles.min(), ue_angles.max(), n_ue)
    su = np.argsort(ue_angles)
    sb = np.argsort(bs_angles)
    heat = np.asarray(bicubic_spline_resample(raw[su][:, sb], bs_angles[sb], ue_angles[su],
                                              grid_bs, grid_ue))
    heat[heat < min_rss] = min_rss
    return heat, grid_ue, grid_bs


def svd_paths(heat, grid_ue, grid_bs, energy_thresh: float = 0.90,
              max_rank: int = 16) -> SvdPaths:
    """The host oracle: one SVD, each rank-1 component's |max| cell."""
    h = np.maximum(np.asarray(heat), 0.0)
    U, S, Vt = np.linalg.svd(h, full_matrices=False)
    cum = np.cumsum(S**2) / np.sum(S**2)
    rank = int(np.searchsorted(cum, energy_thresh)) + 1
    rank = min(rank, max_rank, len(S))
    aoa = np.zeros(max_rank)
    aod = np.zeros(max_rank)
    power = np.zeros(max_rank)
    for k in range(rank):
        comp = S[k] * np.outer(U[:, k], Vt[k])
        i, j = np.unravel_index(np.argmax(np.abs(comp)), comp.shape)
        aoa[k], aod[k] = grid_ue[i], grid_bs[j]
        power[k] = abs(comp[i, j])
    valid = np.arange(max_rank) < rank
    return SvdPaths(aoa, aod, power, S[:max_rank] if len(S) >= max_rank
                    else np.pad(S, (0, max_rank - len(S))), valid)


def svd_paths_torch(heat: torch.Tensor, grid_ue: torch.Tensor, grid_bs: torch.Tensor,
                    energy_thresh: float = 0.90, max_rank: int = 16) -> SvdPaths:
    """``svd_paths`` on ``heat``'s device in float64, [max_rank] tensors;
    slots at or past the rank are 0 (``valid`` False), as in the oracle."""
    h = torch.clamp(heat.to(torch.float64), min=0.0)
    U, S, Vt = torch.linalg.svd(h, full_matrices=False)
    e = S * S
    cum = torch.cumsum(e, 0) / torch.sum(e)
    rank = torch.searchsorted(cum, cum.new_tensor([energy_thresh]))[0] + 1
    rank = torch.clamp(rank, max=min(max_rank, S.shape[0]))
    k = min(max_rank, S.shape[0])
    comps = (U[:, :k].T[:, :, None] * Vt[:k, None, :]) * S[:k, None, None]   # [k, n_ue, n_bs]
    flat = comps.abs().reshape(k, -1).argmax(dim=1)
    n_bs = h.shape[1]
    i, j = flat // n_bs, flat % n_bs
    valid = torch.arange(max_rank, device=h.device) < rank
    z = valid[:k].to(torch.float64)

    def slots(x):
        return torch.nn.functional.pad(x, (0, max_rank - k))

    power = comps.reshape(k, -1).gather(1, flat[:, None])[:, 0].abs()
    return SvdPaths(slots(grid_ue.to(torch.float64)[i] * z),
                    slots(grid_bs.to(torch.float64)[j] * z), slots(power * z), slots(S[:k]),
                    valid)


def run_svd(session, angle_file, output_path=None, **overrides) -> Table:
    """The ``svd`` entry: the table (id, AoA, AoD, Power, SingularValue,
    Type) of the components by singular value, and with ``output_path``
    the figure (needs matplotlib).  ``engine="device"`` (default) runs
    ``svd_paths_torch`` on ``device`` (None: CUDA) and reads the five
    [16] results back in one copy; ``"host"`` runs ``svd_paths``."""
    engine = overrides.get("engine", "device")
    device = overrides.get("device")
    ue, bs, rss = session_rows(session, device)
    raw, ue_ang, bs_ang, min_rss = build_raw_matrix(ue, bs, rss, load_angle_lut(angle_file))
    heat, grid_ue, grid_bs = svd_upsample(raw, ue_ang, bs_ang, min_rss)
    thresh = overrides.get("energy_thresh", 0.90)
    if engine == "device":
        from slam_process_tpu_torch.pipeline.device import resolve_device

        dev = resolve_device(device)
        out = svd_paths_torch(*(torch.from_numpy(np.asarray(x, dtype=np.float64)).to(dev)
                                for x in (heat, grid_ue, grid_bs)), energy_thresh=thresh)
        host = torch.stack([x.to(torch.float64) for x in out]).cpu().numpy()
        paths = SvdPaths(*host[:4], host[4] > 0)
    elif engine == "host":
        paths = svd_paths(heat, grid_ue, grid_bs, thresh)
    else:
        raise ValueError(f"unknown engine {engine!r}; use 'device' or 'host'")

    if output_path is not None:
        from slam_process_tpu_torch.render.estimators import plot_svd

        plot_svd(heat, grid_ue, grid_bs, paths, output_path)
    keep = paths.valid
    order = np.argsort(-paths.singular[keep], kind="stable")
    power = paths.power[keep][order]
    types = ["LoS"] + ["NLoS" if power[i] > 0.1 * power[0] else "weak"
                       for i in range(1, int(keep.sum()))]
    return Table({"id": np.arange(keep.sum()), "AoA": paths.aoa[keep][order],
                  "AoD": paths.aod[keep][order], "Power": power,
                  "SingularValue": paths.singular[keep][order], "Type": types})
