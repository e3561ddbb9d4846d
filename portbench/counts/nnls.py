"""K7, the NN-OMP refits' NNLS (``nnls_kernel``): per closed sweep one
solve per pick, k = 1..K atoms, G, b, x0 and P0 read and x and P written
once (k (4 k + 14) bytes); ``k7_ops`` at K of the outer steps and passive
solves that the reference's own Lawson-Hanson refits take
(``reference/paths.nnls_gram``)."""


def k7_ops(k: int, solver: str, outer: int, solves: int) -> tuple:
    """K7's arithmetic for ``outer`` outer steps and ``solves`` passive
    solves at K = k, as (float32, float64) operations: an outer step's G x
    and gradient (2 k^2 + k) and argmax (k); a solve's masked tile (2 k^2 +
    k), its elimination (the adjugate's 54 at K = 3; Gauss-Jordan's k (k + 1)
    (2 k + 1); LU's 2 k^3 / 3 + 2 k^2, in float64) and the step back (6 k).
    A frozen copy of ``chip_smoke.k7_ops``."""
    f64 = 0
    if k == 3:
        elim = 54
    elif k > 3 and solver == "auto":
        elim = k * (k + 1) * (2 * k + 1)
    else:
        elim, f64 = 0, 2 * k ** 3 // 3 + 2 * k ** 2
    return outer * (2 * k * k + 2 * k) + solves * (2 * k * k + k + elim + 6 * k), solves * f64


def work(s: dict):
    n = s.get("sweeps")
    if not n:
        return None
    k = s["max_paths"]
    f32, f64 = k7_ops(k, "auto", s["nnls_outer"], s["nnls_solves"])
    return n * sum(j * (4 * j + 14) for j in range(1, k + 1)), {"f32": f32, "f64": f64}
