"""Non-negative orthogonal matching pursuit: the float64 oracle, the
session (chain) form and the per-sweep (Gram-domain) form.

The port of ``slam_process_tpu/models/nn_omp.py``:

  * ``nn_omp_np``: a numpy + scipy copy of the float64 host oracle, with
    the reference's control flow (stop on a non-positive maximum or a
    duplicate atom, keep rule "ratio" or "positive").
  * ``nn_omp_scenes``: ``nn_omp_jax`` batched over N scenes, each with its
    own dictionary (what the JAX package's production ``"vmap"`` dataset
    program computes).  Each iteration recomputes the correlation chain
    Phi_rx^T R Phi_tx from the residual; both products are taken in
    float64 from the float32 operands and the [Ga, Gd] surface is rounded
    once to float32, and so are the refit's A^T A, A^T y and A c, so the
    card and the CPU select the same atoms.  No float32 product or solve
    is left (the NNLS LU runs in float64 too), so TF32
    (``torch.backends.cuda.matmul.allow_tf32``, whoever sets it) cannot
    reach the estimator; its float32 work is elementwise, one rounding an
    operation (eager PyTorch fuses no multiply-add).  The atom is the
    first flat maximum (``torch.argmax``, like ``jnp.argmax``).  Slots
    never selected hold grid index 0, as in JAX's device path.
  * ``run_nn_omp``: one entry point, ``engine="device"`` (the chain form
    with N = 1 on ``device``, None meaning CUDA, returned as numpy) or
    ``engine="host"`` (``nn_omp_np``).
  * ``nn_omp_gram_batch``: the per-sweep form, below.

``nn_omp_gram_batch`` is the port of ``nn_omp_gram_batch_jax``, the form
the per-sweep estimator calls.  With selected atoms a_k =
outer(phi_rx[:, r_k], phi_tx[:, t_k]) and residual R = Y - sum_k c_k a_k,
the residual correlation surface is

    Phi_rx^T R Phi_tx = corr_Y - sum_k c_k Grx[:, r_k] (x) Gtx[:, t_k]

with the dictionary Grams Grx = Phi_rx^T Phi_rx and Gtx = Phi_tx^T Phi_tx,
and the NNLS system is gathers: G_kl = Grx[r_k, r_l] Gtx[t_k, t_l], b_k =
corr_Y[r_k, t_k].  So the heavy correlation chain runs once, and each of
the ``max_paths`` iterations is a rank-K elementwise update of the [S, Ga,
Gd] surface, a two-stage argmax and a batched warm-started NNLS
(``ops/nnls.py``).

The three large products (corr_Y and the two Grams) are taken in float64
from the float32 operands and rounded once to float32: cuBLAS and the
CPU's BLAS sum in different orders, and a correctly rounded float32
surface makes the card and the CPU select the same atoms (neighbouring
grid points 0.1 deg apart can differ by a few float32 ulps).  Everything
after is float32, as in JAX, and elementwise, so it rounds alike on both
devices.  The argmax keeps JAX's two-stage rule: the max over d, the first
g holding the global max, then that row recomputed with the same
arithmetic and its first maximal d (``torch.argmax`` returns the first
maximal index, like ``jnp.argmax``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_process_tpu_torch.config import OmpConfig
from slam_process_tpu_torch.models.dictionary import BeamDictionary, dictionary_to_device
from slam_process_tpu_torch.ops.nnls import nnls_gram
from slam_process_tpu_torch.pipeline.device import resolve_device


class OmpPaths(NamedTuple):
    """Estimated paths: max_paths slots + validity mask.  Tensors or numpy
    arrays of [K] per scene, [S, K] for a batch ([S] for n_iters)."""

    aoa: torch.Tensor       # [.., K] grid angle per path
    aod: torch.Tensor       # [.., K]
    power: torch.Tensor     # [.., K] NNLS coefficient
    valid: torch.Tensor     # [.., K] bool kept by the keep rule
    n_iters: torch.Tensor   # [..] atoms selected
    aoa_idx: torch.Tensor   # [.., K] grid indices, -1 for empty slots
    aod_idx: torch.Tensor   # [.., K]


def _f64_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.double(), b.double()).to(torch.float32)


def nn_omp_np(dictionary: BeamDictionary, rss_matrix: np.ndarray, cfg: OmpConfig = OmpConfig(),
              keep_rule: str = "ratio", stop_nonpositive: bool = True,
              logger=None) -> OmpPaths:
    """Float64 host oracle with the reference's control flow.

    ``keep_rule`` "ratio" (v1-7) keeps coefficients above max *
    min_power_ratio, "positive" (v1) those above 0; ``stop_nonpositive``
    (v1-7) stops when the maximum correlation is <= 0.  ``logger``
    (optional) receives each iteration's atom angles, coefficient and
    residual norm.  Returns numpy arrays of [K] and ``n_iters`` an int.
    """
    from scipy.optimize import nnls as scipy_nnls

    phi_rx, phi_tx = dictionary.phi_rx, dictionary.phi_tx
    y = rss_matrix.astype(np.float64).ravel()
    shape = rss_matrix.shape
    residual = y.copy()
    selected: list[tuple[int, int]] = []
    coeffs = np.zeros(0)
    it = 0
    for k in range(cfg.max_paths):
        corr = phi_rx.T @ residual.reshape(shape) @ phi_tx
        if stop_nonpositive and np.max(corr) <= 0:
            break
        i_r, i_t = np.unravel_index(np.argmax(corr), corr.shape)
        if (i_r, i_t) in selected:
            break
        selected.append((int(i_r), int(i_t)))
        A = np.column_stack(
            [np.outer(phi_rx[:, r], phi_tx[:, t]).ravel() for r, t in selected])
        coeffs, _ = scipy_nnls(A, y)
        residual = y - A @ coeffs
        it = k + 1
        if logger is not None:
            logger.debug("iter %d: AoA=%.1f AoD=%.1f coeff=%.4f residual=%.4f",
                         k, dictionary.aoa_grid[i_r], dictionary.aod_grid[i_t],
                         coeffs[-1], float(np.linalg.norm(residual)))

    K = cfg.max_paths
    aoa = np.zeros(K)
    aod = np.zeros(K)
    power = np.zeros(K)
    valid = np.zeros(K, dtype=bool)
    aoa_idx = np.full(K, -1, dtype=np.int64)
    aod_idx = np.full(K, -1, dtype=np.int64)
    if len(coeffs):
        max_coeff = coeffs.max()
        for j, (r, t) in enumerate(selected):
            aoa[j] = dictionary.aoa_grid[r]
            aod[j] = dictionary.aod_grid[t]
            power[j] = coeffs[j]
            aoa_idx[j] = r
            aod_idx[j] = t
            if keep_rule == "ratio":
                valid[j] = coeffs[j] > max_coeff * cfg.min_power_ratio
            else:
                valid[j] = coeffs[j] > 0
    return OmpPaths(aoa, aod, power, valid, it, aoa_idx, aod_idx)


def _keep(coeffs: torch.Tensor, in_sel: torch.Tensor, cfg: OmpConfig, keep_rule: str):
    max_coeff = torch.where(in_sel, coeffs, float("-inf")).amax(dim=1)
    if keep_rule == "ratio":
        return in_sel & (coeffs > max_coeff[:, None] * cfg.min_power_ratio)
    return in_sel & (coeffs > 0)


# The NNLS subproblem solve of the session forms at K > 3: LU.  On an
# NVIDIA H100 the eager Gauss-Jordan loop (several kernels per pivot, K
# pivots a solve) took 1.7x LU's time at K = 20, for one session and for 21
# (chip_smoke.py's estimate phase), with the same selections.  The JAX
# package uses LU for one session and Gauss-Jordan for its batch.
NNLS_SOLVER = "lu"


def pad_grid_axis(phi_rx: torch.Tensor, aoa_grid: torch.Tensor, tp: int):
    """phi_rx [..., U, Ga] and aoa_grid [..., Ga] with Ga padded to a
    multiple of ``tp``: zero phi columns and the last grid angle repeated,
    as the JAX package pads the ``model``-sharded axis; and the padded
    count.  The sharded argmax never selects a padded atom
    (``_mask_padded``)."""
    pad = (-phi_rx.shape[-1]) % tp
    if not pad:
        return phi_rx, aoa_grid, 0
    phi_rx = torch.nn.functional.pad(phi_rx, (0, pad))
    aoa_grid = torch.cat([aoa_grid, aoa_grid[..., -1:].expand(aoa_grid.shape[:-1] + (pad,))],
                         dim=-1)
    return phi_rx, aoa_grid, pad


def _slices(ga: int, devices) -> list:
    """(device, lo, hi) of each model position's contiguous Ga slice."""
    per = ga // len(devices)
    return [(d, m * per, (m + 1) * per) for m, d in enumerate(devices)]


def _mask_padded(corr: torch.Tensor, hi: int, ga_real: int) -> torch.Tensor:
    """corr [.., Ga_m, Gd] of the slice ending at ``hi`` with the rows of
    padded atoms (global index >= ga_real) set to -inf: a padded atom then
    never wins, under either stopping rule."""
    n_pad = hi - max(ga_real, hi - corr.shape[-2])
    if n_pad > 0:
        corr = corr.clone()
        corr[..., corr.shape[-2] - n_pad:, :] = float("-inf")
    return corr


def _combine(picks: list, dev: torch.device):
    """The model positions' (value [N], *payload) picks, each the best of
    its slice with global indices, combined on ``dev``: the largest value,
    on a tie the lowest model rank, which holds the lowest global flat
    index (``torch.argmax`` returns the first maximum, as ``jnp.argmax``)."""
    if len(picks) == 1:
        return picks[0]
    stacked = [torch.stack([x.to(dev) for x in xs]) for xs in zip(*picks)]
    best = stacked[0].argmax(dim=0)
    lanes = torch.arange(best.shape[0], device=dev)
    return tuple(x[best, lanes] for x in stacked)


def nn_omp_scenes(phi_rx: torch.Tensor, phi_tx: torch.Tensor, aoa_grid: torch.Tensor,
                  aod_grid: torch.Tensor, mats: torch.Tensor, cfg: OmpConfig = OmpConfig(),
                  keep_rule: str = "ratio", stop_nonpositive: bool = True,
                  nnls_solver: str = NNLS_SOLVER, model_devices=None) -> OmpPaths:
    """NN-OMP over N scenes, each with its own dictionary: phi_rx [N, U,
    Ga], phi_tx [N, B, Gd], aoa_grid [N, Ga], aod_grid [N, Gd], mats [N, U,
    B] (float32, one device).  Zero-padded scenes (``pack_scenes``) give
    their padded atoms a correlation of exactly 0.  ``nnls_solver`` as
    ``ops/nnls.nnls_gram``'s.  Returns OmpPaths of [N, K] tensors ([N]
    n_iters) on the inputs' device.

    ``model_devices`` (a mesh row's devices; None: the inputs' device alone)
    shards the AoA grid over ``model``: Ga pads to a multiple of their count
    (``pad_grid_axis``) and each position computes the correlation chain
    over its contiguous Ga slice and returns its best value, global index
    and that atom's phi_rx column; ``_combine`` keeps the best, and the
    refit (a [N, U] column copy per iteration to the inputs' device, the
    NNLS and the residual) runs on the inputs' device.  Selections and
    coefficients equal the unsharded run's."""
    K = cfg.max_paths
    N, U, B = mats.shape
    Gd = phi_tx.shape[2]
    dev = mats.device
    devices = tuple(model_devices) if model_devices else (dev,)
    ga_real = phi_rx.shape[2]
    phi_rx, aoa_grid, _ = pad_grid_axis(phi_rx, aoa_grid, len(devices))
    y = mats.to(torch.float32).reshape(N, U * B)
    slots = torch.arange(K, device=dev)
    shards = []
    for d, lo, hi in _slices(phi_rx.shape[2], devices):
        rx = phi_rx[:, :, lo:hi].to(d)
        shards.append((d, lo, hi, rx, rx.transpose(1, 2).double(),     # [N, Ga_m, U]
                       phi_tx.to(d).double()))                         # [N, B, Gd]

    def select(residual):
        picks = []
        for d, lo, hi, rx, prx_t64, ptx64 in shards:
            r = residual.to(d).reshape(N, U, B).double()
            corr = torch.matmul(torch.matmul(prx_t64, r), ptx64).to(torch.float32)
            corr = _mask_padded(corr, hi, ga_real).reshape(N, -1)     # [N, Ga_m * Gd]
            idx = corr.argmax(dim=1)
            col = rx.gather(2, (idx // Gd)[:, None, None].expand(N, U, 1))[:, :, 0]
            picks.append((corr.gather(1, idx[:, None])[:, 0], idx + lo * Gd, col))
        return _combine(picks, dev)

    residual = y
    sel_r = torch.zeros((N, K), dtype=torch.long, device=dev)
    sel_t = torch.zeros_like(sel_r)
    cols_sel = torch.zeros((N, U, K), dtype=torch.float32, device=dev)
    coeffs = torch.zeros((N, K), dtype=torch.float32, device=dev)
    passive = torch.zeros((N, K), dtype=torch.bool, device=dev)
    nsel = torch.zeros(N, dtype=torch.long, device=dev)
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    for _ in range(K):
        max_corr, flat_idx, col = select(residual)
        i_r, i_t = flat_idx // Gd, flat_idx % Gd

        dup = ((sel_r == i_r[:, None]) & (sel_t == i_t[:, None])
               & (slots[None, :] < nsel[:, None])).any(dim=1)
        stop = done | dup
        if stop_nonpositive:
            stop = stop | (max_corr <= 0)
        upd = (slots[None, :] == nsel[:, None]) & ~stop[:, None]
        sel_r = torch.where(upd, i_r[:, None], sel_r)
        sel_t = torch.where(upd, i_t[:, None], sel_t)
        cols_sel = torch.where(upd[:, None, :], col[:, :, None], cols_sel)
        nsel = torch.where(stop, nsel, nsel + 1)

        # Atom matrix [N, U * B, K], zero columns for unselected slots.
        active = (slots[None, :] < nsel[:, None]).to(torch.float32)
        cols_rx = cols_sel * active[:, None, :]
        cols_tx = phi_tx.gather(2, sel_t[:, None, :].expand(N, B, K)) * active[:, None, :]
        A = (cols_rx[:, :, None, :] * cols_tx[:, None, :, :]).reshape(N, U * B, K)
        A_t = A.transpose(1, 2)
        G = _f64_product(A_t, A)
        b = _f64_product(A_t, y[:, :, None])[:, :, 0]
        # Warm-started Lawson-Hanson: the previous (coeffs, passive) is a
        # valid resume point when one atom joins.
        coeffs2, passive2 = nnls_gram(G, b, max_outer=cfg.nnls_max_iter, solver=nnls_solver,
                                      x0=coeffs, P0=passive)
        residual2 = y - _f64_product(A, coeffs2[:, :, None])[:, :, 0]
        coeffs = torch.where(stop[:, None], coeffs, coeffs2)
        passive = torch.where(stop[:, None], passive, passive2)
        residual = torch.where(stop[:, None], residual, residual2)
        done = stop

    in_sel = slots[None, :] < nsel[:, None]
    return OmpPaths(
        aoa=aoa_grid.gather(1, sel_r),
        aod=aod_grid.gather(1, sel_t),
        power=coeffs,
        valid=_keep(coeffs, in_sel, cfg, keep_rule),
        n_iters=nsel.to(torch.int32),
        aoa_idx=torch.where(in_sel, sel_r, -1).to(torch.int32),
        aod_idx=torch.where(in_sel, sel_t, -1).to(torch.int32),
    )


def run_nn_omp(dictionary: BeamDictionary, rss_matrix: np.ndarray, cfg: OmpConfig = OmpConfig(),
               keep_rule: str = "ratio", stop_nonpositive: bool = True, engine: str = "device",
               device=None, logger=None) -> OmpPaths:
    """One entry point for every NN-OMP flavor: ``engine="device"`` runs
    ``nn_omp_scenes`` on ``device`` (None: CUDA) with the dictionary and
    the scene rounded once to float32, and returns numpy arrays of [K]
    (``n_iters`` a numpy scalar); ``engine="host"`` is ``nn_omp_np``."""
    if engine == "host":
        return nn_omp_np(dictionary, rss_matrix, cfg, keep_rule=keep_rule,
                         stop_nonpositive=stop_nonpositive, logger=logger)
    if engine != "device":
        raise ValueError(f"unknown engine {engine!r}; use 'device' or 'host'")
    dev = resolve_device(device)
    d = dictionary_to_device(dictionary, dev)
    mat = torch.from_numpy(np.asarray(rss_matrix, dtype=np.float32)).to(dev)
    out = nn_omp_scenes(d.phi_rx[None], d.phi_tx[None], d.aoa_grid[None], d.aod_grid[None],
                        mat[None], cfg, keep_rule, stop_nonpositive)
    return OmpPaths(*(x.cpu().numpy()[0] for x in out))


def nn_omp_gram_batch(phi_rx: torch.Tensor, phi_tx: torch.Tensor, aoa_grid: torch.Tensor,
                      aod_grid: torch.Tensor, mats: torch.Tensor, cfg: OmpConfig = OmpConfig(),
                      keep_rule: str = "ratio", stop_nonpositive: bool = True,
                      model_devices=None) -> OmpPaths:
    """NN-OMP over S scenes mats [S, U, B] sharing the dictionary phi_rx
    [U, Ga], phi_tx [B, Gd] (all float32 on one device).

    ``model_devices`` (a mesh row's devices; None: the inputs' device alone)
    shards the AoA grid over ``model``: Ga pads to a multiple of their count
    (``pad_grid_axis``); each position holds corr_Y and Grx's columns of its
    contiguous Ga slice, updates its part of the surface, and returns its
    two-stage best (value, global g, d, and corr_Y there, the new atom's
    right-hand side); ``_combine`` keeps the best.  The NNLS runs on the
    inputs' device with the whole Grams.  Selections and coefficients equal
    the unsharded run's."""
    K = cfg.max_paths
    S = mats.shape[0]
    dev = mats.device
    devices = tuple(model_devices) if model_devices else (dev,)
    ga_real = phi_rx.shape[1]
    phi_rx, aoa_grid, _ = pad_grid_axis(phi_rx, aoa_grid, len(devices))
    Y64 = mats.to(torch.float32).double()
    slots = torch.arange(K, device=dev)

    grx = _f64_product(phi_rx.T, phi_rx)                        # [Ga, Ga]
    gtx = _f64_product(phi_tx.T, phi_tx)                        # [Gd, Gd]
    shards = []
    for d, lo, hi in _slices(phi_rx.shape[1], devices):
        t1 = torch.matmul(phi_rx[:, lo:hi].T.to(d).double(), Y64.to(d))       # [S, Ga_m, B]
        corr_y = torch.matmul(t1, phi_tx.to(d).double()).to(torch.float32)     # [S, Ga_m, Gd]
        del t1
        shards.append((d, lo, _mask_padded(corr_y, hi, ga_real), grx.T[:, lo:hi].to(d),
                       gtx.T.to(d), torch.arange(S, device=d)))

    def select(it, active_c, sel_r, sel_t):
        picks = []
        for d, lo, corr_y, grx_t, gtx_t, lanes_d in shards:
            a_c, s_r, s_t = active_c.to(d), sel_r.to(d), sel_t.to(d)
            # Rank-K residual: slots >= it hold no atom yet (coefficient 0),
            # so their terms are exact zeros and are skipped.
            grs = grx_t[s_r]                                    # [S, K, Ga_m]
            gts = gtx_t[s_t]                                    # [S, K, Gd]
            resid = corr_y
            for k in range(it):
                resid = resid - (a_c[:, k, None] * grs[:, k, :])[:, :, None] * gts[:, k, None, :]
            m1 = resid.amax(dim=2)                              # [S, Ga_m]
            del resid
            i_r = m1.argmax(dim=1)
            g_at = grs.gather(2, i_r[:, None, None].expand(S, K, 1))[:, :, 0]   # [S, K]
            row = corr_y[lanes_d, i_r]                          # [S, Gd]
            for k in range(it):
                row = row - (a_c[:, k, None] * g_at[:, k, None]) * gts[:, k, :]
            i_t = row.argmax(dim=1)
            picks.append((m1.gather(1, i_r[:, None])[:, 0], i_r + lo, i_t,
                          corr_y[lanes_d, i_r, i_t]))
        return _combine(picks, dev)

    sel_r = torch.zeros((S, K), dtype=torch.long, device=dev)
    sel_t = torch.zeros_like(sel_r)
    b_sel = torch.zeros((S, K), dtype=torch.float32, device=dev)
    coeffs = torch.zeros((S, K), dtype=torch.float32, device=dev)
    passive = torch.zeros((S, K), dtype=torch.bool, device=dev)
    nsel = torch.zeros(S, dtype=torch.long, device=dev)
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    for it in range(K):
        active_c = coeffs * (slots[None, :] < nsel[:, None])
        max_corr, i_r, i_t, b_new = select(it, active_c, sel_r, sel_t)

        dup = ((sel_r == i_r[:, None]) & (sel_t == i_t[:, None])
               & (slots[None, :] < nsel[:, None])).any(dim=1)
        stop = done | dup
        if stop_nonpositive:
            stop = stop | (max_corr <= 0)

        upd = (slots[None, :] == nsel[:, None]) & ~stop[:, None]
        sel_r = torch.where(upd, i_r[:, None], sel_r)
        sel_t = torch.where(upd, i_t[:, None], sel_t)
        b_sel = torch.where(upd, b_new[:, None], b_sel)
        nsel = torch.where(stop, nsel, nsel + 1)

        # NNLS on the separable Gram system, warm-started from the previous
        # (coeffs, passive): the old rows, columns and b entries are
        # unchanged when one atom joins.
        active = (slots[None, :] < nsel[:, None]).to(torch.float32)
        Gk = (grx[sel_r[:, :, None], sel_r[:, None, :]]
              * gtx[sel_t[:, :, None], sel_t[:, None, :]])
        Gk = Gk * active[:, :, None] * active[:, None, :]
        bk = b_sel * active
        coeffs2, passive2 = nnls_gram(Gk, bk, max_outer=cfg.nnls_max_iter, x0=coeffs,
                                      P0=passive)
        coeffs = torch.where(stop[:, None], coeffs, coeffs2)
        passive = torch.where(stop[:, None], passive, passive2)
        done = stop

    in_sel = slots[None, :] < nsel[:, None]
    return OmpPaths(
        aoa=aoa_grid[sel_r],
        aod=aod_grid[sel_t],
        power=coeffs,
        valid=_keep(coeffs, in_sel, cfg, keep_rule),
        n_iters=nsel.to(torch.int32),
        aoa_idx=torch.where(in_sel, sel_r, -1).to(torch.int32),
        aod_idx=torch.where(in_sel, sel_t, -1).to(torch.int32),
    )
