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

The separable spline resamplers of the JAX module serve estimators not
ported yet and are not here.
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
