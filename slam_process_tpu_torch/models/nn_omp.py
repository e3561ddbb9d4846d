"""Non-negative orthogonal matching pursuit, Gram-domain batch form.

The port of ``slam_process_tpu/models/nn_omp.py::nn_omp_gram_batch_jax``,
the form the per-sweep estimator calls.  With selected atoms a_k =
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

import torch

from slam_process_tpu_torch.config import OmpConfig
from slam_process_tpu_torch.ops.nnls import nnls_gram


class OmpPaths(NamedTuple):
    """Estimated paths (max_paths slots + validity mask), [S, K] each."""

    aoa: torch.Tensor       # [S, K] f32 grid angle per path
    aod: torch.Tensor       # [S, K] f32
    power: torch.Tensor     # [S, K] f32 NNLS coefficient
    valid: torch.Tensor     # [S, K] bool kept by the keep rule
    n_iters: torch.Tensor   # [S] i32 atoms selected
    aoa_idx: torch.Tensor   # [S, K] i32 grid indices, -1 for empty slots
    aod_idx: torch.Tensor   # [S, K] i32


def _f64_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.double(), b.double()).to(torch.float32)


def nn_omp_gram_batch(phi_rx: torch.Tensor, phi_tx: torch.Tensor, aoa_grid: torch.Tensor,
                      aod_grid: torch.Tensor, mats: torch.Tensor, cfg: OmpConfig = OmpConfig(),
                      keep_rule: str = "ratio", stop_nonpositive: bool = True) -> OmpPaths:
    """NN-OMP over S scenes mats [S, U, B] sharing the dictionary phi_rx
    [U, Ga], phi_tx [B, Gd] (all float32 on one device)."""
    K = cfg.max_paths
    S = mats.shape[0]
    dev = mats.device
    Y = mats.to(torch.float32)
    slots = torch.arange(K, device=dev)
    lanes = torch.arange(S, device=dev)

    grx = _f64_product(phi_rx.T, phi_rx)                        # [Ga, Ga]
    gtx = _f64_product(phi_tx.T, phi_tx)                        # [Gd, Gd]
    t1 = torch.matmul(phi_rx.T.double(), Y.double())            # [S, Ga, B]
    corr_y = torch.matmul(t1, phi_tx.double()).to(torch.float32)  # [S, Ga, Gd]
    del t1
    grx_t, gtx_t = grx.T, gtx.T

    sel_r = torch.zeros((S, K), dtype=torch.long, device=dev)
    sel_t = torch.zeros_like(sel_r)
    coeffs = torch.zeros((S, K), dtype=torch.float32, device=dev)
    passive = torch.zeros((S, K), dtype=torch.bool, device=dev)
    nsel = torch.zeros(S, dtype=torch.long, device=dev)
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    for it in range(K):
        # Rank-K residual: slots >= it hold no atom yet (coefficient 0), so
        # their terms are exact zeros and are skipped.
        active_c = coeffs * (slots[None, :] < nsel[:, None])
        grs = grx_t[sel_r]                                      # [S, K, Ga]
        gts = gtx_t[sel_t]                                      # [S, K, Gd]
        resid = corr_y
        for k in range(it):
            resid = resid - (active_c[:, k, None] * grs[:, k, :])[:, :, None] * gts[:, k, None, :]
        m1 = resid.amax(dim=2)                                  # [S, Ga]
        del resid
        i_r = m1.argmax(dim=1)
        max_corr = m1.gather(1, i_r[:, None])[:, 0]
        g_at = grs.gather(2, i_r[:, None, None].expand(S, K, 1))[:, :, 0]   # [S, K]
        row = corr_y[lanes, i_r]                                # [S, Gd]
        for k in range(it):
            row = row - (active_c[:, k, None] * g_at[:, k, None]) * gts[:, k, :]
        i_t = row.argmax(dim=1)

        dup = ((sel_r == i_r[:, None]) & (sel_t == i_t[:, None])
               & (slots[None, :] < nsel[:, None])).any(dim=1)
        stop = done | dup
        if stop_nonpositive:
            stop = stop | (max_corr <= 0)

        upd = (slots[None, :] == nsel[:, None]) & ~stop[:, None]
        sel_r = torch.where(upd, i_r[:, None], sel_r)
        sel_t = torch.where(upd, i_t[:, None], sel_t)
        nsel = torch.where(stop, nsel, nsel + 1)

        # NNLS on the separable Gram system, warm-started from the previous
        # (coeffs, passive): the old rows, columns and b entries are
        # unchanged when one atom joins.
        active = (slots[None, :] < nsel[:, None]).to(torch.float32)
        Gk = (grx[sel_r[:, :, None], sel_r[:, None, :]]
              * gtx[sel_t[:, :, None], sel_t[:, None, :]])
        Gk = Gk * active[:, :, None] * active[:, None, :]
        bk = corr_y[lanes[:, None], sel_r, sel_t] * active
        coeffs2, passive2 = nnls_gram(Gk, bk, max_outer=cfg.nnls_max_iter, x0=coeffs,
                                      P0=passive)
        coeffs = torch.where(stop[:, None], coeffs, coeffs2)
        passive = torch.where(stop[:, None], passive, passive2)
        done = stop

    in_sel = slots[None, :] < nsel[:, None]
    max_coeff = torch.where(in_sel, coeffs, float("-inf")).amax(dim=1)
    if keep_rule == "ratio":
        valid = in_sel & (coeffs > max_coeff[:, None] * cfg.min_power_ratio)
    else:
        valid = in_sel & (coeffs > 0)
    return OmpPaths(
        aoa=aoa_grid[sel_r],
        aod=aod_grid[sel_t],
        power=coeffs,
        valid=valid,
        n_iters=nsel.to(torch.int32),
        aoa_idx=torch.where(in_sel, sel_r, -1).to(torch.int32),
        aod_idx=torch.where(in_sel, sel_t, -1).to(torch.int32),
    )
