"""The port's peak primitives and the peak-picking estimator's pieces ==
the JAX package's.

* ``local_max_mask``: the numpy branch equal to JAX's (scipy); the torch
  branch (max_pool2d, -inf padding) equal to it and to JAX's
  ``reduce_window`` branch, with plateaus and edge maxima, sizes 3 and 5.
* ``percentile``: the numpy branch equal to ``np.nanpercentile``; the torch
  branch (``torch.nanquantile``, linear) within 1e-10 of the values' range,
  NaN entries skipped.
* ``peak_regions_np`` equal to JAX's (labels, cells, powers, order);
  ``savgol_rows`` numpy equal to JAX's, torch within 1e-10.
* ``build_heatmap_grid`` and ``detect_peaks`` equal to JAX's, with holes
  filled by the nearest sample; ``peak_mask_torch`` on the CPU equal to
  the host mask at the 90th percentile.
"""

import numpy as np
import pytest
import torch

import slam_process_tpu.models  # noqa: F401  (the JAX package loads its registry first)
from slam_process_tpu.models import peak_picking as jax_pp
from slam_process_tpu.ops import peaks as jax_peaks
from slam_process_tpu_torch.models import peak_picking
from slam_process_tpu_torch.ops import peaks
from slam_process_tpu_torch.utils.synthetic import ANGLES


def heats(seed):
    """A smooth multi-peak map, a map with plateaus (integer levels) and
    maxima on its edges, and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-40, 40, 33), np.linspace(-40, 40, 47), indexing="ij")
    smooth = sum(rng.uniform(0.5, 2) * np.exp(-((yy - rng.uniform(-40, 40)) ** 2
                                               + (xx - rng.uniform(-40, 40)) ** 2) / 60)
                 for _ in range(5))
    plateau = np.floor(smooth * 3)
    plateau[0, :] = plateau.max() + 1
    return {"smooth": smooth, "plateau": plateau, "noise": rng.normal(size=(20, 31))}


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("kind", ["smooth", "plateau", "noise"])
def test_local_max_mask_matches_jax(kind, size):
    import jax.numpy as jnp

    heat = heats(1)[kind]
    want = jax_peaks.local_max_mask(heat, size)
    np.testing.assert_array_equal(peaks.local_max_mask(heat, size), want)
    got = peaks.local_max_mask(torch.from_numpy(heat), size)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    if kind != "smooth":   # float32 may merge the smooth map's near-equal neighbours
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jax_peaks.local_max_mask(jnp.asarray(heat, jnp.float32), size)))


@pytest.mark.parametrize("q", [0.0, 37.5, 65.0, 90.0, 100.0])
def test_percentile_matches_numpy(q):
    for heat in heats(2).values():
        h = heat.copy()
        h.flat[::7] = np.nan
        want = np.nanpercentile(h, q)
        assert peaks.percentile(h, q) == jax_peaks.percentile(h, q) == want
        got = float(peaks.percentile(torch.from_numpy(h), q))
        assert abs(got - want) <= 1e-10 * max(np.nanmax(h) - np.nanmin(h), 1.0)


@pytest.mark.parametrize("seed", [3, 4])
def test_peak_regions_and_savgol_match_jax(seed):
    for heat in heats(seed).values():
        for thresh in (65.0, 90.0):
            assert peaks.peak_regions_np(heat, thresh) == jax_peaks.peak_regions_np(heat, thresh)
        want = jax_peaks.savgol_rows(heat, 7, 2)
        np.testing.assert_array_equal(peaks.savgol_rows(heat, 7, 2), want)
        got = peaks.savgol_rows(torch.from_numpy(heat), 7, 2).numpy()
        assert np.max(np.abs(got - want)) <= 1e-10 * max(np.ptp(want), 1.0)


def samples(seed, holes=0):
    """Pair means on the beam-angle lattice (float32 angles), with
    ``holes`` pairs missing."""
    rng = np.random.default_rng(seed)
    ang = ANGLES.astype(np.float32)
    ue, bs = np.meshgrid(np.arange(2, 30), np.arange(10, 50), indexing="ij")
    ue, bs = ue.ravel(), bs.ravel()
    keep = np.ones(len(ue), bool)
    keep[rng.choice(len(ue), holes, replace=False)] = False
    aoa, aod = ang[ue[keep]], ang[bs[keep]]
    rss = sum(rng.uniform(2e4, 9e4) * np.exp(-((aoa - rng.uniform(-30, 0)) ** 2
                                              + (aod - rng.uniform(-25, 20)) ** 2) / 20.0)
              for _ in range(3)) + rng.uniform(0, 3e3, len(aoa))
    return aoa, aod, rss


@pytest.mark.parametrize("holes", [0, 60])
def test_heatmap_grid_and_peaks_match_jax(holes):
    aoa, aod, rss = samples(5, holes)
    got = peak_picking.build_heatmap_grid(aoa, aod, rss)
    want = jax_pp.build_heatmap_grid(aoa, aod, rss)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    aod_grid, aoa_grid, heat = got
    thresh = np.percentile(heat, 90)
    found = peak_picking.detect_peaks(heat, aod_grid, aoa_grid, thresh)
    assert found == jax_pp.detect_peaks(heat, aod_grid, aoa_grid, thresh) and len(found) >= 2
    mask = peak_picking.peak_mask_torch(torch.from_numpy(heat), 90.0).numpy()
    np.testing.assert_array_equal(mask, peaks.local_max_mask(heat, 3) & (heat > thresh))
