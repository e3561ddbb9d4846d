"""The port's spline resamplers and SVD estimator == the JAX package's.

* ``cubic_spline_interp_matrix`` equal to JAX's; ``bicubic_spline_resample``
  and ``bilinear_resample``: the numpy branch equal to JAX's, the torch
  branch (float64 on the CPU) within 1e-12 of the result's range, at
  random float64 axes and at the testbed's float32 beam angles.
* ``build_raw_matrix`` (pair means without pandas) equal to JAX's (pandas
  groupby), on rows with repeated pairs, and with an unmapped beam and a
  beam past the table (angle 0, float64 axes).
* ``svd_upsample`` equal to JAX's; ``svd_paths`` equal to JAX's;
  ``svd_paths_torch`` on the CPU against ``svd_paths``: valid slots and
  cells equal, power and singular values within rtol 1e-9; against
  JAX's float32 ``svd_paths_jax`` within JAX's own bounds (angles 1e-3,
  values rtol 1e-3, ``tests/test_device_engines.py``).
"""

import numpy as np
import pytest
import torch

import slam_process_tpu.models  # noqa: F401  (the JAX package loads its registry first)
from slam_process_tpu.models import svd_est as jax_svd
from slam_process_tpu.ops import interp as jax_interp
from slam_process_tpu_torch.models import svd_est
from slam_process_tpu_torch.ops import interp
from slam_process_tpu_torch.utils.synthetic import ANGLES


def axes(kind, rng):
    if kind == "beam_angles":
        a = ANGLES.astype(np.float32)
        return a[::3], a[1::2]
    return np.sort(rng.uniform(-43.6, 45.0, 14)), np.sort(rng.uniform(-43.6, 45.0, 11))


def within_range(got, want, tol=1e-12):
    span = max(float(np.ptp(want)), 1.0)
    assert np.max(np.abs(np.asarray(got) - want)) <= tol * span


@pytest.mark.parametrize("kind", ["random", "beam_angles"])
def test_spline_matrix_and_resamplers_match_jax(kind):
    rng = np.random.default_rng(5)
    x, y = axes(kind, rng)
    values = rng.uniform(-80.0, -20.0, (len(y), len(x)))
    xq = np.linspace(float(x.min()) - 2.0, float(x.max()) + 2.0, 37)
    yq = np.linspace(float(y.min()), float(y.max()), 29)
    np.testing.assert_array_equal(interp.cubic_spline_interp_matrix(x, xq),
                                  jax_interp.cubic_spline_interp_matrix(x, xq))
    for fn in ("bicubic_spline_resample", "bilinear_resample"):
        want = np.asarray(getattr(jax_interp, fn)(values, x, y, xq, yq))
        got = getattr(interp, fn)(values, x, y, xq, yq)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=fn)
        t = getattr(interp, fn)(torch.from_numpy(values), x, y, xq, yq)
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float64
        within_range(t.numpy(), want)


def pair_rows(rng, n=900, unmapped=False):
    ue = rng.integers(0, 20, n)
    bs = rng.integers(0, 30, n)
    if unmapped:
        bs[:40] = 66      # past the 64-beam table: angle 0
    rss = rng.integers(1, 1 << 18, n)
    lut = ANGLES.astype(np.float32).copy()
    if unmapped:
        lut[7] = np.nan
    return ue, bs, rss, lut


@pytest.mark.parametrize("unmapped", [False, True])
def test_build_raw_matrix_and_upsample_match_jax(unmapped):
    ue, bs, rss, lut = pair_rows(np.random.default_rng(6), unmapped=unmapped)
    got = svd_est.build_raw_matrix(ue, bs, rss, lut)
    want = jax_svd.build_raw_matrix(ue, bs, rss, lut)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    assert (got[2].dtype == np.float64) == unmapped
    if unmapped:
        # Two zero angles make the spline singular, in both packages.
        return
    up, up_j = svd_est.svd_upsample(*got), jax_svd.svd_upsample(*want)
    for g, w in zip(up, up_j):
        np.testing.assert_array_equal(g, w)


def heat_of(seed):
    rng = np.random.default_rng(seed)
    ue, bs = np.sort(rng.uniform(-40, 40, 90)), np.sort(rng.uniform(-40, 40, 180))
    heat = rng.uniform(0.0, 0.2, (90, 180))
    for _ in range(3):
        a, d, p = rng.uniform(-35, 35), rng.uniform(-35, 35), rng.uniform(0.5, 3.0)
        heat += p * np.exp(-((ue[:, None] - a) ** 2 + (bs[None, :] - d) ** 2) / 8.0)
    return heat, ue, bs


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_svd_paths_torch_matches_oracle_and_jax(seed):
    import jax
    import jax.numpy as jnp

    heat, ue, bs = heat_of(seed)
    ref = svd_est.svd_paths(heat, ue, bs)
    want = jax_svd.svd_paths(heat, ue, bs)
    for g, w in zip(ref, want):
        np.testing.assert_array_equal(g, w)
    got = svd_est.svd_paths_torch(*(torch.from_numpy(x) for x in (heat, ue, bs)))
    got = svd_est.SvdPaths(*(x.numpy() for x in got))
    assert 1 < ref.valid.sum() < 16
    np.testing.assert_array_equal(got.valid, ref.valid)
    np.testing.assert_array_equal(got.aoa, ref.aoa)
    np.testing.assert_array_equal(got.aod, ref.aod)
    np.testing.assert_allclose(got.power, ref.power, rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.singular, ref.singular, rtol=1e-9, atol=1e-12 * ref.singular[0])

    j = jax.device_get(jax.jit(jax_svd.svd_paths_jax)(
        *(jnp.asarray(x, jnp.float32) for x in (heat, ue, bs))))
    np.testing.assert_array_equal(np.asarray(j.valid), got.valid)
    kept = got.valid
    np.testing.assert_allclose(np.asarray(j.aoa)[kept], got.aoa[kept], atol=1e-3)
    np.testing.assert_allclose(np.asarray(j.aod)[kept], got.aod[kept], atol=1e-3)
    np.testing.assert_allclose(np.asarray(j.power)[kept], got.power[kept], rtol=1e-3)
    np.testing.assert_allclose(np.asarray(j.singular)[kept], got.singular[kept], rtol=1e-3)


def test_svd_paths_torch_energy_threshold_and_rank_cap():
    """A flat heat needs one component; a noise heat hits the 16 cap."""
    rng = np.random.default_rng(8)
    ue, bs = np.linspace(-40, 40, 90), np.linspace(-40, 40, 180)
    for heat, rank in ((np.ones((90, 180)), 1), (rng.uniform(0, 1, (90, 180)) ** 8, 16)):
        ref = svd_est.svd_paths(heat, ue, bs, energy_thresh=0.999)
        got = svd_est.svd_paths_torch(*(torch.from_numpy(x) for x in (heat, ue, bs)),
                                      energy_thresh=0.999)
        assert int(ref.valid.sum()) == rank
        np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
        np.testing.assert_allclose(got.singular.numpy(), ref.singular, rtol=1e-9,
                                   atol=1e-12 * ref.singular[0])
