"""The port's dense OMP (slam_process_tpu_torch.models.omp_dense) == the
JAX package's.

* ``omp_dense_np`` equal to JAX's on the scenes of JAX's own
  ``test_omp_dense_jax_matches_np_synthetic`` (a dense beam lattice,
  planted separable atoms) and on sparse scenes.
* ``omp_dense_torch`` (float64 on the CPU) on those dense scenes: the
  selected atoms equal the float64 oracle's and JAX's float32
  ``omp_dense_jax``'s, the coefficients within rtol 1e-6 of the oracle's
  (the device solves the normal equations, the oracle ``lstsq``) and
  within JAX's own bounds (rtol 2e-3, atol 1e-5) of JAX's.
* JAX's observable rule (atoms of norm <= 1e-15 are never selected) on
  sparse random samples, where the oracle selects such atoms: the torch
  engine selects none, and equals the oracle with that rule added.
* ``run_omp_dense`` with each engine.
"""

import numpy as np
import pytest
import torch

import slam_process_tpu.models  # noqa: F401  (the JAX package loads its registry first)
from slam_process_tpu.models import omp_dense as jax_od
from slam_process_tpu_torch.models import omp_dense
from slam_process_tpu_torch.models.dictionary import gaussian_beam

AOA_GRID = np.arange(-30.0, 30.0, 0.5)
AOD_GRID = np.arange(-20.0, 25.0, 0.5)


def dense_scene(trial, rng):
    """JAX's test scene ``trial``: a lattice of samples, four planted atoms
    and noise."""
    ga = np.linspace(-29, 29, 12 + trial)
    gd = np.linspace(-19, 24, 10 + trial)
    meas_aoa, meas_aod = (x.ravel() for x in np.meshgrid(ga, gd))
    y = rng.random(meas_aoa.size) * 0.05
    for _ in range(4):
        ca, cd = rng.uniform(-28, 28), rng.uniform(-18, 23)
        y = y + rng.uniform(1.0, 3.0) * (gaussian_beam(meas_aoa, ca, 1.4)
                                         * gaussian_beam(meas_aod, cd, 1.4))
    return meas_aoa, meas_aod, y


def sparse_scene(seed):
    rng = np.random.default_rng(seed)
    m = 60
    return rng.uniform(-29, 29, m), rng.uniform(-19, 24, m), rng.uniform(0.1, 3.0, m)


def torch_paths(meas_aoa, meas_aod, y, n_paths=5):
    t = [torch.from_numpy(np.asarray(x, np.float64)) for x in
         (meas_aoa, meas_aod, y, AOA_GRID, AOD_GRID)]
    rx = omp_dense.gaussian_beam_torch(t[0][:, None], t[3][None, :], 1.4)
    tx = omp_dense.gaussian_beam_torch(t[1][:, None], t[4][None, :], 1.4)
    return omp_dense.DenseOmpPaths(*(x.numpy() for x in omp_dense.omp_dense_torch(
        rx, tx, t[2], t[3], t[4], n_paths)))


def test_omp_dense_matches_jax_on_its_scenes():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    for trial in range(3):
        meas_aoa, meas_aod, y = dense_scene(trial, rng)
        ref = omp_dense.omp_dense_np(meas_aoa, meas_aod, y, AOA_GRID, AOD_GRID)
        want = jax_od.omp_dense_np(meas_aoa, meas_aod, y, AOA_GRID, AOD_GRID)
        for g, w in zip(ref, want):
            np.testing.assert_array_equal(g, w)
        got = torch_paths(meas_aoa, meas_aod, y)
        np.testing.assert_array_equal(got.aoa, ref.aoa, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(got.aod, ref.aod, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(got.valid, ref.valid)
        np.testing.assert_allclose(got.power, ref.power, rtol=1e-6, atol=0)

        rx, tx = (gaussian_beam(jnp.asarray(m, jnp.float32)[:, None],
                                jnp.asarray(g, jnp.float32)[None, :], 1.4)
                  for m, g in ((meas_aoa, AOA_GRID), (meas_aod, AOD_GRID)))
        j = jax.device_get(jax.jit(jax_od.omp_dense_jax, static_argnames="n_paths")(
            rx, tx, jnp.asarray(y, jnp.float32), jnp.asarray(AOA_GRID, jnp.float32),
            jnp.asarray(AOD_GRID, jnp.float32)))
        np.testing.assert_allclose(np.asarray(j.aoa), got.aoa, atol=1e-5)
        np.testing.assert_allclose(np.asarray(j.aod), got.aod, atol=1e-5)
        np.testing.assert_allclose(np.asarray(j.power), got.power, rtol=2e-3, atol=1e-5)


def observable_oracle(meas_aoa, meas_aod, y, n_paths=5):
    """``omp_dense_np`` with JAX's observable rule added (a test-local
    reference): the oracle's selection loop over atoms of norm > 1e-15."""
    rx = gaussian_beam(meas_aoa[:, None], AOA_GRID[None, :], 1.4)
    tx = gaussian_beam(meas_aod[:, None], AOD_GRID[None, :], 1.4)
    norms = np.sqrt(np.einsum("mg,mh->gh", rx**2, tx**2))
    unobservable = (norms <= 1e-15).ravel()
    Gd = len(AOD_GRID)
    residual, cols, sel = y.copy(), [], []
    for _ in range(n_paths):
        corr = np.abs(np.einsum("m,mg,mh->gh", residual, rx, tx) / np.maximum(norms, 1e-300))
        flat = corr.ravel()
        flat[unobservable] = -np.inf
        flat[[g * Gd + h for g, h in sel]] = -np.inf
        j = int(np.argmax(flat))
        sel.append((j // Gd, j % Gd))
        cols.append(rx[:, j // Gd] * tx[:, j % Gd] / norms[j // Gd, j % Gd])
        A = np.stack(cols, axis=1)
        coefs = np.linalg.lstsq(A, y, rcond=None)[0]
        residual = y - A @ coefs
    return np.array([AOA_GRID[g] for g, _ in sel]), np.array([AOD_GRID[h] for _, h in sel]), \
        coefs, norms


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_observable_rule_on_sparse_samples(seed):
    meas_aoa, meas_aod, y = sparse_scene(seed)
    ref = omp_dense.omp_dense_np(meas_aoa, meas_aod, y, AOA_GRID, AOD_GRID)
    for g, w in zip(ref, jax_od.omp_dense_np(meas_aoa, meas_aod, y, AOA_GRID, AOD_GRID)):
        np.testing.assert_array_equal(g, w)
    aoa, aod, coefs, norms = observable_oracle(meas_aoa, meas_aod, y)
    picked = [norms[np.searchsorted(AOA_GRID, a), np.searchsorted(AOD_GRID, d)]
              for a, d in zip(ref.aoa, ref.aod)]
    assert min(picked) <= 1e-15        # the oracle takes an unobservable atom
    got = torch_paths(meas_aoa, meas_aod, y)
    np.testing.assert_array_equal(got.aoa, aoa)
    np.testing.assert_array_equal(got.aod, aod)
    np.testing.assert_allclose(got.power, coefs, rtol=1e-6, atol=0)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_run_omp_dense_engines(engine):
    meas_aoa, meas_aod, y = dense_scene(1, np.random.default_rng(12))
    got = omp_dense.run_omp_dense(meas_aoa.astype(np.float32), meas_aod.astype(np.float32), y,
                                  AOA_GRID, AOD_GRID, n_paths=4, engine=engine, device="cpu")
    ref = omp_dense.omp_dense_np(meas_aoa.astype(np.float32), meas_aod.astype(np.float32), y,
                                 AOA_GRID, AOD_GRID, n_paths=4)
    assert all(isinstance(x, np.ndarray) and x.shape == (4,) for x in got)
    np.testing.assert_array_equal(got.aoa, ref.aoa)
    np.testing.assert_array_equal(got.aod, ref.aod)
    np.testing.assert_allclose(got.power, ref.power, rtol=1e-6 if engine == "device" else 0)
    with pytest.raises(ValueError, match="unknown engine"):
        omp_dense.run_omp_dense(meas_aoa, meas_aod, y, AOA_GRID, AOD_GRID, engine="tpu")
