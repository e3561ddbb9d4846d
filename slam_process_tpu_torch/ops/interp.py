"""Radial-basis-function interpolation (scipy ``Rbf`` equivalent).

The port of ``slam_process_tpu/ops/interp.py``'s RBF functions, which
replace ``scipy.interpolate.Rbf(..., function='linear', smooth=s)``: kernel
matrix A_ij = phi(|x_i - x_j|) with A -= s I, nodes = solve(A, values),
evaluation phi(dist(query, centres)) @ nodes; ``kernel="thin_plate"`` is
phi = r^2 log r with phi(0) = 0.

Two branches, chosen by the inputs' type as the JAX package's ``xp``
switch chooses:

  * numpy arrays: the numpy code of the JAX package's host path, operation
    for operation (``numpy.linalg.solve``);
  * tensors: the same formulas on the tensor's device, in numpy's types:
    the centres' distances in their own dtype (float32 for the angle
    LUT's float32 angles, as numpy computes them in the JAX package's host
    path), the solve and the evaluation in float64
    (``torch.linalg.solve``; a singular system raises
    ``torch.linalg.LinAlgError``).

The separable resamplers (``RectBivariateSpline`` upsampling, the svd,
peak-picking and geometric estimators' grids): ``cubic_spline_interp_matrix``
builds a not-a-knot cubic spline's [Q, N] weight matrix on the host in
float64, so a 2-D resample is ``Wy @ values @ Wx^T``
(``bicubic_spline_resample``: numpy for a numpy ``values``, else float64 on
the tensor's device); ``bilinear_resample`` is the plain bilinear one.
"""

from __future__ import annotations

import numpy as np
import torch


def _rbf_phi(r, kernel: str):
    if kernel == "linear":
        return r
    if kernel == "thin_plate":
        # scipy uses xlogy(r^2, r): exactly 0 at r = 0.
        if isinstance(r, np.ndarray):
            return np.where(r > 0, (r * r) * np.log(np.where(r > 0, r, 1.0)), 0.0)
        return torch.where(r > 0, (r * r) * torch.log(torch.where(r > 0, r, 1.0)), 0.0)
    raise ValueError(f"unknown RBF kernel {kernel!r}")


def _distances(a, b):
    if isinstance(a, np.ndarray):
        d = a[:, None, :] - b[None, :, :]
        return np.sqrt(np.sum(d * d, axis=-1) + 1e-38)
    d = a[:, None, :] - b[None, :, :]
    # The root taken in float64 and rounded once: correctly rounded, as
    # numpy's and CUDA's float32 roots are and torch's CPU one is not.
    sq = torch.sum(d * d, dim=-1) + 1e-38
    return torch.sqrt(sq.double()).to(sq.dtype)


def _on(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (numpy or a tensor) as a tensor on ``like``'s device, in its
    own dtype."""
    return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x),
                           device=like.device)


def rbf_linear_fit(points, values, smooth: float = 0.0, kernel: str = "linear"):
    """Kernel weights (nodes [N]) for centres ``points`` [N, D] and
    ``values`` [N]: numpy for a numpy ``points``, else on ``points``'
    device with the kernel matrix in the centres' dtype and the solve in
    the promoted dtype of it and ``values``, as numpy promotes."""
    n = points.shape[0]
    r = _distances(points, points)
    if isinstance(points, np.ndarray):
        A = _rbf_phi(r, kernel) - np.eye(n, dtype=r.dtype) * smooth
        return np.linalg.solve(A, values)
    A = _rbf_phi(r, kernel) - torch.eye(n, dtype=r.dtype, device=r.device) * smooth
    values = _on(values, r)
    dtype = torch.promote_types(A.dtype, values.dtype)
    return torch.linalg.solve(A.to(dtype), values.to(dtype))


def rbf_linear_eval(points, nodes, queries, kernel: str = "linear"):
    """The fitted RBF at ``queries`` [Q, D] -> [Q], in the promoted dtype
    of the distances and ``nodes``."""
    phi = _rbf_phi(_distances(queries, points), kernel)
    if isinstance(phi, np.ndarray):
        return phi @ nodes
    dtype = torch.promote_types(phi.dtype, nodes.dtype)
    return phi.to(dtype) @ nodes.to(dtype)


def rbf_interpolate_grid(x_centers, y_centers, values_2d, grid_x, grid_y,
                         smooth: float = 0.0, kernel: str = "linear"):
    """The renderer's pattern: an RBF over the (bs, ue) angle mesh.

    x_centers [B] (AoD / BS angles), y_centers [U] (AoA / UE angles),
    values_2d [U, B] UE-major, grid_x / grid_y the 1-D target axes.
    Returns [len(grid_y), len(grid_x)], as ``Rbf(bs_mesh.flatten(),
    ue_mesh.flatten(), rss.flatten())`` evaluated on the grid meshes.
    numpy for a numpy ``values_2d``; for a tensor, on its device with the
    values in float64 (the centres' distances in their own dtype, as
    numpy computes them).
    """
    if isinstance(values_2d, np.ndarray):
        bs_mesh, ue_mesh = np.meshgrid(np.asarray(x_centers), np.asarray(y_centers))
        pts = np.stack([bs_mesh.ravel(), ue_mesh.ravel()], axis=1)
        nodes = rbf_linear_fit(pts, np.ravel(values_2d), smooth, kernel)
        gx, gy = np.meshgrid(np.asarray(grid_x), np.asarray(grid_y))
        q = np.stack([gx.ravel(), gy.ravel()], axis=1)
        return rbf_linear_eval(pts, nodes, q, kernel).reshape(len(grid_y), len(grid_x))
    vals = values_2d.to(torch.float64)
    x, y = _on(x_centers, vals), _on(y_centers, vals)
    dtype = torch.promote_types(x.dtype, y.dtype)
    bs_mesh, ue_mesh = torch.meshgrid(x.to(dtype), y.to(dtype), indexing="xy")
    pts = torch.stack([bs_mesh.reshape(-1), ue_mesh.reshape(-1)], dim=1)
    nodes = rbf_linear_fit(pts, vals.reshape(-1), smooth, kernel)
    gx, gy = _on(grid_x, vals), _on(grid_y, vals)
    dtype = torch.promote_types(gx.dtype, gy.dtype)
    gx, gy = torch.meshgrid(gx.to(dtype), gy.to(dtype), indexing="xy")
    q = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)
    return rbf_linear_eval(pts, nodes, q, kernel).reshape(len(grid_y), len(grid_x))


# ---------------------------------------------------------------------------
# Separable not-a-knot cubic spline (RectBivariateSpline s=0 equivalent)
# ---------------------------------------------------------------------------


def _spline_coth_matrix(x: np.ndarray):
    """The not-a-knot cubic spline's second-derivative system (host):
    A m = rhs_w @ y."""
    n = len(x)
    h = np.diff(x)
    A = np.zeros((n, n))
    rhs_w = np.zeros((n, n))
    for i in range(1, n - 1):
        A[i, i - 1] = h[i - 1]
        A[i, i] = 2 * (h[i - 1] + h[i])
        A[i, i + 1] = h[i]
        rhs_w[i, i - 1] = 6 / h[i - 1]
        rhs_w[i, i] = -6 / h[i - 1] - 6 / h[i]
        rhs_w[i, i + 1] = 6 / h[i]
    # not-a-knot: third derivative continuous at x1 and x_{n-2}
    A[0, 0] = h[1]
    A[0, 1] = -(h[0] + h[1])
    A[0, 2] = h[0]
    A[-1, -3] = h[-1]
    A[-1, -2] = -(h[-2] + h[-1])
    A[-1, -1] = h[-2]
    return A, rhs_w


def cubic_spline_interp_matrix(x: np.ndarray, xq: np.ndarray) -> np.ndarray:
    """Dense [Q, N] float64 matrix mapping samples y at ``x`` to the
    spline's values at ``xq`` (host)."""
    x = np.asarray(x, dtype=np.float64)
    xq = np.asarray(xq, dtype=np.float64)
    n = len(x)
    if n < 4:
        raise ValueError("need >= 4 points for not-a-knot cubic spline")
    A, rhs_w = _spline_coth_matrix(x)
    M = np.linalg.solve(A, rhs_w)  # second derivatives = M @ y
    h = np.diff(x)
    idx = np.clip(np.searchsorted(x, xq, side="right") - 1, 0, n - 2)
    W = np.zeros((len(xq), n))
    for q, (j, xv) in enumerate(zip(idx, xq)):
        hj = h[j]
        a = (x[j + 1] - xv) / hj
        b = (xv - x[j]) / hj
        # s(x) = a*y_j + b*y_{j+1} + ((a^3-a) m_j + (b^3-b) m_{j+1}) h^2/6
        W[q, j] += a
        W[q, j + 1] += b
        W[q] += ((a**3 - a) * M[j] + (b**3 - b) * M[j + 1]) * hj * hj / 6.0
    return W


def bicubic_spline_resample(values_2d, x, y, xq, yq):
    """Separable cubic-spline resample of values[y, x] onto (yq, xq):
    numpy in ``values_2d``'s dtype for a numpy array, else float64 on the
    tensor's device."""
    Wy = cubic_spline_interp_matrix(np.asarray(y), np.asarray(yq))
    Wx = cubic_spline_interp_matrix(np.asarray(x), np.asarray(xq))
    if isinstance(values_2d, np.ndarray):
        Wy = Wy.astype(values_2d.dtype)
        Wx = Wx.astype(values_2d.dtype)
        return Wy @ values_2d @ Wx.T
    v = values_2d.to(torch.float64)
    Wy, Wx = (torch.from_numpy(w).to(v.device) for w in (Wy, Wx))
    return Wy @ v @ Wx.T


def bilinear_resample(values_2d, x, y, xq, yq):
    """Bilinear resample of values[y, x] onto (yq, xq), clamped at the
    edges: numpy for a numpy ``values_2d``, else on the tensor's device in
    its dtype."""
    if isinstance(values_2d, np.ndarray):
        x, y, xq, yq = (np.asarray(a) for a in (x, y, xq, yq))
        jx = np.clip(np.searchsorted(x, xq, side="right") - 1, 0, len(x) - 2)
        jy = np.clip(np.searchsorted(y, yq, side="right") - 1, 0, len(y) - 2)
        clip = np.clip
    else:
        x, y, xq, yq = (_on(a, values_2d).contiguous() for a in (x, y, xq, yq))

        def cell(a, q):   # numpy's searchsorted compares in the promoted dtype
            t = torch.promote_types(a.dtype, q.dtype)
            return torch.clamp(torch.searchsorted(a.to(t), q.to(t), right=True) - 1, 0,
                               len(a) - 2)

        jx, jy = cell(x, xq), cell(y, yq)
        clip = torch.clamp
    tx = clip((xq - x[jx]) / (x[jx + 1] - x[jx]), 0.0, 1.0)
    ty = clip((yq - y[jy]) / (y[jy + 1] - y[jy]), 0.0, 1.0)
    v00 = values_2d[jy[:, None], jx[None, :]]
    v01 = values_2d[jy[:, None], jx[None, :] + 1]
    v10 = values_2d[jy[:, None] + 1, jx[None, :]]
    v11 = values_2d[jy[:, None] + 1, jx[None, :] + 1]
    return (v00 * (1 - ty[:, None]) * (1 - tx[None, :])
            + v01 * (1 - ty[:, None]) * tx[None, :]
            + v10 * ty[:, None] * (1 - tx[None, :])
            + v11 * ty[:, None] * tx[None, :])
