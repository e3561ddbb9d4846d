"""Batched non-negative least squares on Gram systems (Lawson-Hanson).

The port of ``slam_process_tpu/ops/nnls.py::nnls_gram`` with the vmap axis
written out: G [S, K, K], b [S, K] hold S independent problems min ||A x -
y||, x >= 0, given G = A^T A and b = A^T y.  ``nnls_gram`` launches kernel
K7 (``ops/cuda_nnls.py``, ``csrc/nnls.cu``) on CUDA tensors, where each
lane runs JAX's two nested bounded ``while_loop``s on the device and the
host reads nothing, and runs ``nnls_gram_plain`` on CPU tensors.

``nnls_gram_plain`` is K7's plain version: the loops become Python loops
that run all lanes in lockstep: each lane keeps its own ``done`` flag and
takes updates only while it is not done (what ``jnp.where`` does under
vmap), and a loop ends when every lane is done or at ``max_outer`` /
``MAX_INNER``.  Each loop step asks the device once whether every lane is
done (``HOST_SYNCS`` counts them: the plain version's only host syncs;
constants are Python scalars, not tensors copied to the device).

Arithmetic is float32 as in JAX, with JAX's guards: ``jnp.maximum(x - z,
1e-300)`` is ``max(x - z, 0)`` in float32 (1e-300 flushes to zero), and
both ``1e-30`` pivot / determinant guards stay.  The masked subproblem
solve pads rows and columns outside the passive set with identity, so the
solution is exactly zero there.  G x is summed term by term in column
order, so the card and the CPU round it alike.
"""

from __future__ import annotations

import torch

from slam_process_tpu_torch.ops import cuda_nnls

HOST_SYNCS = 0   # the plain version's lockstep-loop host syncs since the caller set it to 0

MAX_INNER = 16   # bound on the inner (feasibility) loop's steps
TOL = 1e-10      # coefficient threshold
TOL_REL = 3e-7   # gradient threshold relative to max|b|


def _all(flags: torch.Tensor) -> bool:
    global HOST_SYNCS
    HOST_SYNCS += 1
    return bool(flags.all())


def _matvec(G: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    acc = G[:, :, 0] * x[:, 0, None]
    for col in range(1, G.shape[2]):
        acc = acc + G[:, :, col] * x[:, col, None]
    return acc


def _solve_passive(G: torch.Tensor, b: torch.Tensor, P: torch.Tensor,
                   solver: str = "auto") -> torch.Tensor:
    """Solve the passive-set subproblems [S, K]: rows / columns outside P
    replaced by identity.  "auto": the closed-form adjugate at K = 3,
    Gauss-Jordan without pivoting for K > 3, LU otherwise; "lu": LU except
    at K = 3 (as in JAX).  The LU solve is ``torch.linalg.solve_ex`` in
    float64, rounded once to float32: no library float32 routine (which
    TF32 could reach) runs, and it neither checks for a singular system nor
    waits for the device to say (a singular one gives inf / NaN, as
    ``jnp.linalg.solve`` does)."""
    k = G.shape[2]
    Pf = P.to(G.dtype)
    Gp = G * (Pf[:, :, None] * Pf[:, None, :]) + torch.diag_embed(1.0 - Pf)
    bp = b * Pf
    if k > 3 and solver != "lu":
        # Gp is SPD on the passive set and identity off it; a zero pivot
        # (near-collinear atoms) zeroes its row instead of making inf/NaN.
        aug = torch.cat([Gp, bp[:, :, None]], dim=2)                 # [S, K, K+1]
        for i in range(k):
            piv = aug[:, i, i]
            inv_piv = torch.where(piv.abs() > 1e-30, 1.0 / piv, 0.0)
            row = aug[:, i] * inv_piv[:, None]
            col = aug[:, :, i]
            aug = aug - col[:, :, None] * row[:, None, :]
            aug[:, i] = row
        return aug[:, :, k]
    if k == 3:
        a11, a12, a13 = Gp[:, 0, 0], Gp[:, 0, 1], Gp[:, 0, 2]
        a21, a22, a23 = Gp[:, 1, 0], Gp[:, 1, 1], Gp[:, 1, 2]
        a31, a32, a33 = Gp[:, 2, 0], Gp[:, 2, 1], Gp[:, 2, 2]
        c11 = a22 * a33 - a23 * a32
        c12 = a13 * a32 - a12 * a33
        c13 = a12 * a23 - a13 * a22
        c21 = a23 * a31 - a21 * a33
        c22 = a11 * a33 - a13 * a31
        c23 = a13 * a21 - a11 * a23
        c31 = a21 * a32 - a22 * a31
        c32 = a12 * a31 - a11 * a32
        c33 = a11 * a22 - a12 * a21
        det = a11 * c11 + a12 * c21 + a13 * c31
        # Degenerate Gram (det underflows to 0): zeros, not inf/NaN.
        inv_det = torch.where(det.abs() > 1e-30, 1.0 / det, 0.0)
        b0, b1, b2 = bp[:, 0], bp[:, 1], bp[:, 2]
        return torch.stack([(c11 * b0 + c12 * b1 + c13 * b2) * inv_det,
                            (c21 * b0 + c22 * b1 + c23 * b2) * inv_det,
                            (c31 * b0 + c32 * b1 + c33 * b2) * inv_det], dim=1)
    return torch.linalg.solve_ex(Gp.double(), bp.double())[0].to(Gp.dtype)


def _inner(G, b, x, P, run, solver):
    """Lawson-Hanson inner loop over the lanes in ``run``: solve on the
    passive set, and while any passive coefficient is <= TOL step back to
    the feasible boundary and drop the zeroed atoms."""
    x_c, P_c, done = x, P, ~run
    for _ in range(MAX_INNER):
        if _all(done):
            break
        z = _solve_passive(G, b, P_c, solver)
        neg = P_c & (z <= TOL)
        any_neg = neg.any(dim=1)
        alpha = torch.where(neg, x_c / (x_c - z).clamp_min(0.0), float("inf")).amin(dim=1)
        x_n = x_c + alpha[:, None] * (z - x_c)
        P_n = P_c & (x_n > TOL)
        live = ~done
        x_c = torch.where((live & any_neg)[:, None], x_n,
                          torch.where(live[:, None], z, x_c))
        P_c = torch.where((live & any_neg)[:, None], P_n, P_c)
        done = done | ~any_neg
    return x_c, P_c


def nnls_gram(G: torch.Tensor, b: torch.Tensor, max_outer: int = 64, solver: str = "auto",
              x0=None, P0=None):
    """Batched Lawson-Hanson on Gram systems: (x [S, K], passive [S, K]).

    ``max_outer`` bounds active-set additions.  The gradient test uses
    ``TOL + TOL_REL * max|b|`` per lane (float32 rounding noise in w = b -
    G x is proportional to |b|); the coefficient tests keep ``TOL``.
    ``x0`` / ``P0`` warm-start the active set from a previous solution of
    the same lanes when one atom joined (x0 >= 0, zero off P0, optimal on
    P0).  Kernel K7 on CUDA tensors (K <= 32), ``nnls_gram_plain`` on CPU
    tensors.
    """
    if G.dim() != 3 or b.dim() != 2 or G.shape[:2] != b.shape or G.shape[1] != G.shape[2]:
        raise ValueError(f"nnls_gram takes G [S, K, K] and b [S, K], got "
                         f"{tuple(G.shape)} and {tuple(b.shape)}")
    if G.is_cuda:
        return cuda_nnls.nnls_gram_cuda(
            G.contiguous(), b.contiguous(), max_outer, solver,
            None if x0 is None else x0.contiguous(), None if P0 is None else P0.contiguous())
    if G.device.type != "cpu":
        raise ValueError(f"NNLS runs on CUDA or CPU tensors, got {G.device}")
    return nnls_gram_plain(G, b, max_outer, solver, x0, P0)


def nnls_gram_plain(G: torch.Tensor, b: torch.Tensor, max_outer: int = 64,
                    solver: str = "auto", x0=None, P0=None):
    """``nnls_gram`` as lockstep Python loops on any device (K7's plain
    version; the module docstring)."""
    k = G.shape[2]
    w_tol = TOL + TOL_REL * b.abs().amax(dim=1)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    P = torch.zeros_like(b, dtype=torch.bool) if P0 is None else P0.clone()
    done = torch.zeros(b.shape[0], dtype=torch.bool, device=b.device)
    cols = torch.arange(k, device=b.device)
    for _ in range(max_outer):
        if _all(done):
            break
        w = b - _matvec(G, x)
        w_masked = torch.where(P, float("-inf"), w)
        j = w_masked.argmax(dim=1)
        can_add = (w_masked.gather(1, j[:, None])[:, 0] > w_tol) & ~P.all(dim=1)
        step = can_add & ~done
        x_upd, P_upd = _inner(G, b, x, P | (cols[None, :] == j[:, None]), step, solver)
        x = torch.where(step[:, None], x_upd.clamp_min(0.0), x)
        P = torch.where(step[:, None], P_upd, P)
        done = done | ~can_add
    return x, P
