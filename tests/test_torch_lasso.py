"""The port's positive LASSO and the lasso_refine estimator's pieces == the
JAX package's.

* ``lasso_positive_np`` equal to JAX's (tol-stopped and fixed sweeps).
* ``lasso_positive_torch`` (one problem and a batch of P, float32 on the
  CPU) against JAX's float32 ``lasso_positive_jax`` within 1e-6 of the
  coefficients' scale; in float64 against ``lasso_positive_np`` run the
  same 200 sweeps within 1e-12 of the scale; a zero column stays 0.
* ``make_heatmap_interpolated`` and ``peak_regions_np`` equal to JAX's;
  ``refine_patches`` equal to JAX's; ``refine_patches_device`` (float64 on
  the CPU, padded 7 x 7 patches, 200 sweeps) within 1e-9 of the map's
  scale of the same clamped patches solved on the host in float64 with 200
  sweeps, and within JAX's own bound (2e-3 of the scale,
  ``tests/test_device_engines.py``) of the tol-stopped host map (whose
  design is the float32 angles' float32) and of JAX's float32 device map;
  ``classify_peaks`` equal to JAX's.
"""

import numpy as np
import pytest
import torch

import slam_process_tpu.models  # noqa: F401  (the JAX package loads its registry first)
from slam_process_tpu.models import lasso_refine as jax_lr
from slam_process_tpu.ops import lasso as jax_lasso
from slam_process_tpu.ops import peaks as jax_peaks
from slam_process_tpu_torch.models import lasso_refine
from slam_process_tpu_torch.ops import lasso
from slam_process_tpu_torch.utils.synthetic import ANGLES


def problem(seed, n=60, k=15):
    rng = np.random.default_rng(seed)
    X = np.abs(rng.normal(size=(n, k)))
    y = X @ np.abs(rng.normal(size=k) * (rng.random(k) < 0.4)) + 0.01 * rng.normal(size=n)
    return X, y


def scale_close(got, want, tol):
    scale = max(float(np.max(np.abs(want))), 1.0)
    assert np.max(np.abs(np.asarray(got) - want)) <= tol * scale


@pytest.mark.parametrize("sweeps,tol", [(200, 1e-10), (5000, 1e-10), (50, -1.0)])
def test_lasso_np_matches_jax(sweeps, tol):
    for seed in (21, 22, 23):
        X, y = problem(seed)
        np.testing.assert_array_equal(lasso.lasso_positive_np(X, y, 0.1, sweeps, tol),
                                      jax_lasso.lasso_positive_np(X, y, 0.1, sweeps, tol))


def test_lasso_torch_matches_jax_float32_and_np_float64():
    import jax
    import jax.numpy as jnp

    Xs, ys = zip(*(problem(seed) for seed in (31, 32, 33, 34)))
    X, y = np.stack(Xs), np.stack(ys)
    X[2, :, 4] = 0.0                                 # a zero column: skipped
    batch = lasso.lasso_positive_torch(torch.from_numpy(X).float(), torch.from_numpy(y).float(),
                                       0.1).numpy()
    jfn = jax.jit(lambda a, b: jax_lasso.lasso_positive_jax(a, b, 0.1))
    for p in range(len(X)):
        want = np.asarray(jfn(jnp.asarray(X[p], jnp.float32), jnp.asarray(y[p], jnp.float32)))
        scale_close(batch[p], want, 1e-6)
        single = lasso.lasso_positive_torch(torch.from_numpy(X[p]).float(),
                                            torch.from_numpy(y[p]).float(), 0.1).numpy()
        scale_close(single, want, 1e-6)
    assert batch[2, 4] == 0.0
    w64 = lasso.lasso_positive_torch(torch.from_numpy(X), torch.from_numpy(y), 0.1).numpy()
    for p in range(len(X)):
        scale_close(w64[p], lasso.lasso_positive_np(X[p], y[p], 0.1, 200, tol=-1.0), 1e-12)


def lattice(seed, unmapped=()):
    """Pair means on the beam-angle lattice (float32 angles) of a scene of
    three Gaussian paths."""
    rng = np.random.default_rng(seed)
    ang = ANGLES.astype(np.float32)
    ue, bs = (x.ravel() for x in np.meshgrid(np.arange(0, 64, 2), np.arange(0, 64, 2),
                                             indexing="ij"))
    keep = ~np.isin(ue, unmapped) & ~np.isin(bs, unmapped)
    aoa, aod = ang[ue[keep]], ang[bs[keep]]
    rss = sum(rng.uniform(2e4, 9e4) * np.exp(-((aoa - rng.uniform(-35, 35)) ** 2
                                              + (aod - rng.uniform(-35, 35)) ** 2) / 30.0)
              for _ in range(3)) + rng.uniform(0, 3e3, len(aoa))
    return aoa, aod, rss


def host_fixed_sweeps(aoa, aod, rss, aoa_grid, aod_grid, heat, peaks):
    """The clamped patches in float64, 200 sweeps each (the device
    engine's arithmetic, patch by patch on the host)."""
    refined = np.zeros_like(heat)
    a64, d64 = aoa.astype(np.float64), aod.astype(np.float64)
    for pk in peaks[:20]:
        r0, c0 = pk["idx"]
        r1, r2 = max(0, r0 - 3), min(heat.shape[0] - 1, r0 + 3)
        c1, c2 = max(0, c0 - 3), min(heat.shape[1] - 1, c0 + 3)
        G = np.column_stack([lasso_refine.beam_gain(a64, a) * lasso_refine.beam_gain(d64, d)
                             for d in aod_grid[r1:r2 + 1] for a in aoa_grid[c1:c2 + 1]])
        norms = np.linalg.norm(G, axis=0) + 1e-8
        coef = lasso.lasso_positive_np(G / norms, rss, 0.1, 200, tol=-1.0) / norms
        refined[r1:r2 + 1, c1:c2 + 1] += coef.reshape(r2 - r1 + 1, c2 - c1 + 1)
    return refined


@pytest.mark.parametrize("seed,unmapped", [(41, ()), (42, (4, 30, 62))])
def test_refine_patches_device_matches_host_and_jax(seed, unmapped):
    aoa, aod, rss = lattice(seed, unmapped)
    got = lasso_refine.make_heatmap_interpolated(aoa, aod, rss, grid_res=2.0)
    want = jax_lr.make_heatmap_interpolated(aoa, aod, rss, grid_res=2.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    aoa_grid, aod_grid, heat = got
    peaks = lasso_refine.peak_regions_np(heat, 65.0)
    assert peaks == jax_peaks.peak_regions_np(heat, 65.0) and len(peaks) >= 3
    # A peak on the map's edge clamps its patch.
    assert any(min(p["idx"]) < 3 or p["idx"][0] > heat.shape[0] - 4
               or p["idx"][1] > heat.shape[1] - 4 for p in peaks)
    host = lasso_refine.refine_patches(aoa, aod, rss, aoa_grid, aod_grid, heat, peaks)
    np.testing.assert_array_equal(
        host, jax_lr.refine_patches(aoa, aod, rss, aoa_grid, aod_grid, heat, peaks))
    dev = lasso_refine.refine_patches_device(aoa, aod, rss, aoa_grid, aod_grid, heat.shape,
                                             peaks, device="cpu")
    scale_close(dev, host_fixed_sweeps(aoa, aod, rss, aoa_grid, aod_grid, heat, peaks), 1e-9)
    scale_close(dev, host, 2e-3)
    scale_close(dev, jax_lr.refine_patches_device(aoa, aod, rss, aoa_grid, aod_grid,
                                                  heat.shape, peaks), 2e-3)
    final = lasso_refine.peak_regions_np(0.6 * dev + 0.4 * heat, 65.0)
    assert lasso_refine.classify_peaks(final) == jax_lr.classify_peaks(final)
    assert lasso_refine.classify_peaks(final[:1]) == jax_lr.classify_peaks(final[:1])
    assert lasso_refine.classify_peaks([]) == []
