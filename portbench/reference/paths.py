"""The plain reference of the per-sweep paths: sweeps, NN-OMP, NNLS, tracks.

Written from the estimator's published semantics (heatmap_gemini_v1-7's
NN-OMP as the JAX package's float64 oracle ``nn_omp_np`` runs it, its
Gaussian-beam dictionary, ``track_sweep_step_np``'s greedy association),
in plain NumPy and PyTorch.  It imports nothing of the program.

A stream's sweeps are its kept rows cut where the UE beam decreases.  A
sweep's scene is its mean RSS per (UE, BS) cell, empty cells filled with
the sweep's smallest mean.  NN-OMP picks, K times, the dictionary atom of
largest correlation with the residual (``phi_rx^T R phi_tx``), stops at a
repeated atom, and refits the picked atoms by non-negative least squares;
a path is kept where its coefficient is positive.

``judge_sweeps`` follows the program's picks: at each step it computes
the residual of the program's earlier picks in float64 and reads how far
the correlation of the atom the program picked lies below the best one
(0 for the reference's own pick; a near tie costs a few ulps), then
refits by its own Lawson-Hanson NNLS and compares the program's powers.
``nn_omp`` is the reference's own run, in any dtype: the control.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.pipeline import LogRef, groups_of


class Sweeps(NamedTuple):
    sums: np.ndarray        # [n, 64, 64] int64 RSS per cell
    counts: np.ndarray      # [n, 64, 64] int64
    times: np.ndarray       # [n] int64 raw 30-bit CLK of each sweep's first kept row
    last_start: np.ndarray  # [n] byte offset of each sweep's last kept frame


def sweeps_of(ref: LogRef, n_beams: int = 64) -> Sweeps:
    k = ref.corr.keep
    ue, bs = ref.frames.ue[k], ref.corr.corrected[k]
    rss, clk, starts = ref.frames.rss[k], ref.frames.clk[k], ref.frames.starts[k]
    sid = groups_of(ue)
    n = int(sid[-1]) + 1 if len(sid) else 0
    cell = (sid * n_beams + ue) * n_beams + bs
    size = n * n_beams * n_beams
    counts = np.bincount(cell, minlength=size).astype(np.int64)
    sums = np.zeros(size, np.int64)
    np.add.at(sums, cell, rss)
    first = np.searchsorted(sid, np.arange(n), side="left")
    last = np.searchsorted(sid, np.arange(n), side="right") - 1
    shape = (n, n_beams, n_beams)
    return Sweeps(sums.reshape(shape), counts.reshape(shape), clk[first], starts[last])


def unwrap_clk(times: np.ndarray) -> np.ndarray:
    """30-bit CLK anchors on a monotone axis: a drop of more than half the
    2^30 period is a wrap."""
    t = np.asarray(times, np.int64).copy()
    if len(t) > 1:
        d = np.diff(t)
        wraps = np.cumsum(np.concatenate([[0], (d < 0) & (-d > (1 << 29))]))
        t = t + (wraps.astype(np.int64) << 30)
    return t


class Dictionary(NamedTuple):
    aoa_grid: torch.Tensor   # [Ga] float64
    aod_grid: torch.Tensor   # [Gd]
    phi_rx: torch.Tensor     # [U, Ga]: UE beam u's response to grid angle a
    phi_tx: torch.Tensor     # [B, Gd]


def dictionary(angles: np.ndarray, grid_res: float, beam_width: float, min_points: int = 10,
               device="cpu") -> Dictionary:
    """Gaussian beams (sigma = FWHM / 2.355) over a linspace grid of step
    ``grid_res`` spanning the beam angles."""
    lo, hi = float(np.min(angles)), float(np.max(angles))
    n = max(int((hi - lo) / grid_res) + 1, min_points)
    grid = np.linspace(lo, hi, n)
    sigma = beam_width / 2.355
    phi = np.exp(-(np.asarray(angles)[:, None] - grid[None]) ** 2 / (2.0 * sigma * sigma))
    g = torch.as_tensor(grid, dtype=torch.float64, device=device)
    p = torch.as_tensor(phi, dtype=torch.float64, device=device)
    return Dictionary(g, g, p, p)


def filled_scenes(sums: np.ndarray, counts: np.ndarray, dtype=torch.float64,
                  device="cpu") -> torch.Tensor:
    """[n, U, B] cell means, empty cells at the sweep's smallest mean (0
    where a sweep has none), computed in ``dtype``."""
    s = torch.as_tensor(sums, device=device).to(dtype)
    c = torch.as_tensor(counts, device=device)
    mean = torch.where(c > 0, s / c.clamp(min=1).to(dtype), float("inf"))
    fill = mean.amin(dim=(1, 2))
    fill = torch.where(torch.isfinite(fill), fill, 0.0)
    return torch.where(c > 0, mean, fill[:, None, None]).to(dtype)


class Nnls(NamedTuple):
    x: np.ndarray
    outer: int      # outer steps taken
    solves: int     # passive-set solves taken


def nnls_gram(G: np.ndarray, b: np.ndarray) -> Nnls:
    """Lawson-Hanson NNLS in the Gram form: min x^T G x - 2 b^T x, x >= 0,
    in float64, with its outer steps and passive solves counted."""
    k = len(b)
    x = np.zeros(k)
    passive = np.zeros(k, bool)
    tol = 1e-12 * max(1.0, float(np.abs(G).max()), float(np.abs(b).max()))
    outer = solves = 0
    while True:
        outer += 1
        w = b - G @ x
        if passive.all() or not np.any(w[~passive] > tol):
            break
        j = int(np.argmax(np.where(passive, -np.inf, w)))
        passive[j] = True
        while True:
            solves += 1
            idx = np.nonzero(passive)[0]
            z = np.zeros(k)
            z[idx] = np.linalg.solve(G[np.ix_(idx, idx)], b[idx])
            if np.all(z[idx] > 0):
                x = z
                break
            neg = idx[z[idx] <= 0]
            alpha = np.min(x[neg] / (x[neg] - z[neg]))
            x = x + alpha * (z - x)
            passive &= x > tol
            x[~passive] = 0.0
        if outer > 10 * k + 10:
            break
    return Nnls(x, outer, solves)


def _gram(d: Dictionary, r_idx, t_idx):
    prx, ptx = d.phi_rx[:, r_idx], d.phi_tx[:, t_idx]
    return ((prx.T @ prx) * (ptx.T @ ptx)).cpu().numpy()


def _atom_b(d: Dictionary, y: torch.Tensor, r_idx, t_idx) -> np.ndarray:
    return torch.einsum("uk,ub,bk->k", d.phi_rx[:, r_idx], y, d.phi_tx[:, t_idx]).cpu().numpy()


def _synth(d: Dictionary, r_idx, t_idx, coef) -> torch.Tensor:
    c = torch.as_tensor(coef, dtype=d.phi_rx.dtype, device=d.phi_rx.device)
    return torch.einsum("uk,k,bk->ub", d.phi_rx[:, r_idx], c, d.phi_tx[:, t_idx])


class SweepJudgement(NamedTuple):
    corr_gap: float      # widest relative gap of a program pick below the best atom
    power_gap: float     # widest gap of a program power from the refit's, over the sweep's largest
    angle_gap: float     # widest gap (deg) of a program angle from its grid index's angle
    outer: int           # NNLS outer steps / solves the refits took (K7's work)
    solves: int


def judge_sweeps(d: Dictionary, scenes: torch.Tensor, aoa_idx, aod_idx, n_iters, power,
                 aoa, aod, max_paths: int) -> SweepJudgement:
    """Judge the program's NN-OMP on ``scenes`` [n, U, B] (float64, filled)
    step by step from its own picks (module docstring).  ``aoa_idx``,
    ``aod_idx``, ``power``, ``aoa``, ``aod`` [n, K] and ``n_iters`` [n]
    are the program's."""
    corr_gap = power_gap = angle_gap = 0.0
    outer = solves = 0
    for s in range(scenes.shape[0]):
        y = scenes[s]
        m = int(n_iters[s])
        picks_r = [int(v) for v in aoa_idx[s][:m]]
        picks_t = [int(v) for v in aod_idx[s][:m]]
        coef = np.zeros(0)
        scale = None
        for j in range(min(m + 1, max_paths)):
            resid = y - _synth(d, picks_r[:j], picks_t[:j], coef) if j else y
            corr = d.phi_rx.T @ resid @ d.phi_tx
            best = float(corr.max())
            if scale is None:
                scale = max(float(corr.abs().max()), 1e-300)
            if j < m:
                got = float(corr[picks_r[j], picks_t[j]])
            else:      # the program stopped: its best atom was one it had picked
                got = max(float(corr[r, t]) for r, t in zip(picks_r, picks_t))
            corr_gap = max(corr_gap, (best - got) / scale)
            if j < m:
                fit = nnls_gram(_gram(d, picks_r[:j + 1], picks_t[:j + 1]),
                                _atom_b(d, y, picks_r[:j + 1], picks_t[:j + 1]))
                coef = fit.x
                outer += fit.outer
                solves += fit.solves
        p = np.asarray(power[s], np.float64)
        ref = np.zeros(len(p))
        ref[:m] = coef
        top = max(float(ref.max()) if len(ref) else 0.0, 1e-300)
        power_gap = max(power_gap, float(np.abs(p - ref).max()) / top)
        if m:
            ga = d.aoa_grid[torch.as_tensor(picks_r)].cpu().numpy()
            gd = d.aod_grid[torch.as_tensor(picks_t)].cpu().numpy()
            angle_gap = max(angle_gap, float(np.abs(np.asarray(aoa[s][:m], np.float64) - ga).max()),
                            float(np.abs(np.asarray(aod[s][:m], np.float64) - gd).max()))
    return SweepJudgement(corr_gap, power_gap, angle_gap, outer, solves)


class OwnPaths(NamedTuple):
    aoa: np.ndarray
    aod: np.ndarray
    power: np.ndarray
    valid: np.ndarray
    n_iters: np.ndarray
    aoa_idx: np.ndarray
    aod_idx: np.ndarray


def nn_omp(d: Dictionary, scenes: torch.Tensor, max_paths: int, dtype) -> OwnPaths:
    """The reference's own NN-OMP with every float step in ``dtype`` (the
    control where ``dtype`` is below float32): picks by its own argmax,
    refits on the ``dtype``-rounded Gram system, powers rounded to
    ``dtype``."""
    n = scenes.shape[0]
    out = {f: np.zeros((n, max_paths)) for f in ("aoa", "aod", "power")}
    valid = np.zeros((n, max_paths), bool)
    n_it = np.zeros(n, np.int64)
    ri = np.full((n, max_paths), -1, np.int64)
    ti = np.full((n, max_paths), -1, np.int64)
    prx, ptx = d.phi_rx.to(dtype), d.phi_tx.to(dtype)
    for s in range(n):
        y = scenes[s].to(dtype)
        resid = y
        picks = []
        coef = np.zeros(0)
        for _ in range(max_paths):
            corr = (prx.T @ resid @ ptx).float()
            flat = int(torch.argmax(corr))
            r, t = divmod(flat, corr.shape[1])
            if (r, t) in picks:
                break
            picks.append((r, t))
            rr = [p[0] for p in picks]
            tt = [p[1] for p in picks]
            G = ((prx[:, rr].T @ prx[:, rr]) * (ptx[:, tt].T @ ptx[:, tt])).double().cpu().numpy()
            b = torch.einsum("uk,ub,bk->k", prx[:, rr], y, ptx[:, tt]).double().cpu().numpy()
            coef = torch.as_tensor(nnls_gram(G, b).x).to(dtype).double().numpy()
            c = torch.as_tensor(coef, device=prx.device).to(dtype)
            resid = y - torch.einsum("uk,k,bk->ub", prx[:, rr], c, ptx[:, tt])
        n_it[s] = len(picks)
        for j, (r, t) in enumerate(picks):
            ri[s, j], ti[s, j] = r, t
            out["aoa"][s, j] = float(d.aoa_grid[r].to(dtype))
            out["aod"][s, j] = float(d.aod_grid[t].to(dtype))
            out["power"][s, j] = coef[j]
            valid[s, j] = coef[j] > 0
    return OwnPaths(out["aoa"], out["aod"], out["power"], valid, n_it, ri, ti)


class TrackCols(NamedTuple):
    aoa: np.ndarray      # [T, n] float32
    aod: np.ndarray
    power: np.ndarray
    observed: np.ndarray  # [T, n] bool
    created: np.ndarray  # [T]
    count: int


def track(aoa, aod, power, valid, max_tracks: int, gate_deg: float) -> TrackCols:
    """Greedy global-nearest-neighbour association, one sweep at a time:
    (track, path) pairs assign in ascending squared angle distance (float32
    arithmetic, row-major first on a tie) within the gate; leftover valid
    paths open tracks in path order while slots remain; unmatched tracks
    hold their position."""
    n, k_n = np.asarray(aoa).shape
    t_n = max_tracks
    pos = np.zeros((t_n, 2), np.float32)
    created = np.zeros(t_n, bool)
    count = 0
    gate2 = np.float32(gate_deg) * np.float32(gate_deg)
    cols = [np.zeros((t_n, n), np.float32) for _ in range(3)] + [np.zeros((t_n, n), bool)]
    for s in range(n):
        a = np.asarray(aoa[s], np.float32)
        dd_ = np.asarray(aod[s], np.float32)
        pw = np.asarray(power[s], np.float32)
        v = np.asarray(valid[s], bool)
        assigned = np.zeros(t_n, bool)
        used = np.zeros(k_n, bool)
        col_pow = np.zeros(t_n, np.float32)
        col_obs = np.zeros(t_n, bool)
        for _ in range(k_n):
            da = pos[:, 0:1] - a[None, :]
            db = pos[:, 1:2] - dd_[None, :]
            cost = (da * da + db * db).astype(np.float32)
            mask = (created & ~assigned)[:, None] & (v & ~used)[None, :]
            cost = np.where(mask, cost, np.float32(np.inf))
            ti, ki = divmod(int(np.argmin(cost)), k_n)
            if not cost[ti, ki] <= gate2:
                break
            assigned[ti] = used[ki] = True
            pos[ti] = (a[ki], dd_[ki])
            col_obs[ti] = True
            col_pow[ti] = pw[ki]
        for ki in range(k_n):
            if v[ki] and not used[ki] and count < t_n:
                pos[count] = (a[ki], dd_[ki])
                created[count] = True
                col_obs[count] = True
                col_pow[count] = pw[ki]
                count += 1
        cols[0][:, s], cols[1][:, s] = pos[:, 0], pos[:, 1]
        cols[2][:, s], cols[3][:, s] = col_pow, col_obs
    return TrackCols(*cols, created.copy(), count)
