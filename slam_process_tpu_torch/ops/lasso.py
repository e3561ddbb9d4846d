"""Positive LASSO by cyclic coordinate descent (sklearn-compatible).

The port of ``slam_process_tpu/ops/lasso.py``.  The reference deconvolves
each peak's patch with ``sklearn.linear_model.Lasso(alpha=0.1,
positive=True)``, which minimises

    1/(2 n_samples) ||y - X w||^2 + alpha ||w||_1,  w >= 0

by cyclic coordinate descent on the centred problem (``fit_intercept``):

  * ``lasso_positive_np``: the float64 host oracle, stopping once a sweep
    moves no coefficient by more than ``tol`` of the largest;
  * ``lasso_positive_torch``: the counterpart of ``lasso_positive_jax``, a
    fixed ``n_sweeps`` (no early exit, so no host read), batched over a
    leading P axis, in the inputs' dtype on their device.  A coordinate
    whose Gram diagonal is 0 (a zero column) is skipped.  Each coordinate
    is a handful of [P] operations, so a call launches on the order of
    ``n_sweeps * k * 8`` small device operations.  Its parts,
    ``lasso_gram`` (the centred Gram system) and ``lasso_sweep_`` (one
    sweep in place), are what ``models/lasso_refine``'s program captures
    as two CUDA graphs.
"""

from __future__ import annotations

import numpy as np
import torch


def lasso_positive_np(X: np.ndarray, y: np.ndarray, alpha: float, n_sweeps: int = 200,
                      tol: float = 1e-10, fit_intercept: bool = True) -> np.ndarray:
    """Host oracle: cyclic positive coordinate descent.  ``fit_intercept``
    centres X and y first (sklearn's default, which the reference keeps)."""
    if fit_intercept:
        X = X - X.mean(axis=0)
        y = y - y.mean()
    n, k = X.shape
    G = X.T @ X / n
    b = X.T @ y / n
    w = np.zeros(k)
    for _ in range(n_sweeps):
        w_max = 0.0
        d_w_max = 0.0
        for j in range(k):
            gj = G[j, j]
            if gj <= 0:
                continue
            rho = b[j] - G[j] @ w + gj * w[j]
            w_new = max(0.0, (rho - alpha) / gj)
            d_w_max = max(d_w_max, abs(w_new - w[j]))
            w_max = max(w_max, abs(w_new))
            w[j] = w_new
        if w_max == 0.0 or d_w_max / max(w_max, 1e-300) < tol:
            break
    return w


def lasso_gram(X: torch.Tensor, y: torch.Tensor, fit_intercept: bool = True):
    """The coordinate descent's fixed terms for X [P, n, k] and y [P, n]:
    (G [P, k, k], b [P, k], diag [P, k], live [P, k], safe [P, k]) of the
    centred problem (``fit_intercept``), G = X^T X / n, b = X^T y / n, the
    Gram's diagonal, where it is positive, and it clamped to 1e-30."""
    if fit_intercept:
        X = X - X.mean(dim=1, keepdim=True)
        y = y - y.mean(dim=1, keepdim=True)
    n = X.shape[1]
    Xt = X.transpose(1, 2)
    G = Xt @ X / n                                   # [P, k, k]
    b = (Xt @ y[:, :, None])[:, :, 0] / n            # [P, k]
    diag = G.diagonal(dim1=1, dim2=2)
    return G, b, diag, diag > 0, torch.clamp(diag, min=1e-30)


def lasso_sweep_(w: torch.Tensor, G: torch.Tensor, b: torch.Tensor, diag: torch.Tensor,
                 live: torch.Tensor, safe: torch.Tensor, alpha: float) -> torch.Tensor:
    """One full cyclic sweep over the k coordinates of ``lasso_gram``'s
    problem, updating w [P, k] in place (and returning it)."""
    for j in range(w.shape[1]):
        wj = w[:, j]
        rho = b[:, j] - (G[:, j] * w).sum(dim=1) + diag[:, j] * wj
        w_new = torch.clamp((rho - alpha) / safe[:, j], min=0.0)
        w[:, j] = torch.where(live[:, j], w_new, wj)
    return w


def lasso_positive_torch(X: torch.Tensor, y: torch.Tensor, alpha: float, n_sweeps: int = 200,
                         fit_intercept: bool = True) -> torch.Tensor:
    """Positive LASSO of X [P, n, k] (or [n, k]) against y [P, n] (or
    [n]): [P, k] (or [k]) coefficients after ``n_sweeps`` full sweeps
    (``lasso_sweep_``), on the inputs' device in their dtype."""
    single = X.dim() == 2
    if single:
        X, y = X[None], y[None]
    gram = lasso_gram(X, y, fit_intercept)
    w = torch.zeros_like(gram[1])
    for _ in range(n_sweeps):
        lasso_sweep_(w, *gram, alpha)
    return w[0] if single else w
