"""The port's RBF interpolation (slam_process_tpu_torch.ops.interp) and the
estimation figure's background == the JAX package's.

``rbf_linear_fit``, ``rbf_linear_eval`` and ``rbf_interpolate_grid``,
linear and thin-plate, with ``smooth`` 0 and 0.1: the numpy branch equals
JAX's numpy path exactly; the torch branch (float64 on the CPU) is within
1e-9 of the result's range.  The reference shape (64 x 64 centres, 100 x
100 queries, smooth 0.1), as ``tests/test_interp.py`` has, at random
float64 angles and at the testbed's float32 beam angles.
``render/estimation.rbf_background`` on the CPU against JAX's (numpy,
float64 or float32 angles) within 1e-9 of the heat's range, and a singular system gives
zeros, as JAX's fallback does.  ``estimation_plot`` writes a PNG.
"""

import numpy as np
import pytest
import torch

import slam_process_tpu.models  # noqa: F401  (the JAX package loads its registry first)
from slam_process_tpu.ops import interp as jax_interp
from slam_process_tpu.render import estimation as jax_estimation
from slam_process_tpu_torch.ops import interp
from slam_process_tpu_torch.render import estimation
from slam_process_tpu_torch.utils.synthetic import ANGLES


def angle_axes(rng, u=12, b=9):
    ue = np.sort(rng.uniform(-43.6, 45.0, u))
    bs = np.sort(rng.uniform(-43.6, 45.0, b))
    return ue, bs


def within_range(got, want, tol=1e-9):
    span = float(np.ptp(want))
    assert np.max(np.abs(np.asarray(got) - want)) <= tol * max(span, 1e-300)


@pytest.mark.parametrize("kernel", ["linear", "thin_plate"])
@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_rbf_fit_and_eval_match_jax(kernel, smooth):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-40, 40, (30, 2))
    vals = rng.uniform(8.0, 12.0, 30)
    queries = rng.uniform(-40, 40, (17, 2))
    want_nodes = jax_interp.rbf_linear_fit(pts, vals, smooth, kernel)
    want = jax_interp.rbf_linear_eval(pts, want_nodes, queries, kernel)
    nodes = interp.rbf_linear_fit(pts, vals, smooth, kernel)
    np.testing.assert_array_equal(nodes, want_nodes)
    np.testing.assert_array_equal(interp.rbf_linear_eval(pts, nodes, queries, kernel), want)

    t_nodes = interp.rbf_linear_fit(torch.from_numpy(pts), torch.from_numpy(vals), smooth,
                                    kernel)
    assert t_nodes.dtype == torch.float64
    got = interp.rbf_linear_eval(torch.from_numpy(pts), t_nodes, torch.from_numpy(queries),
                                 kernel)
    within_range(got.numpy(), want)


@pytest.mark.parametrize("kernel", ["linear", "thin_plate"])
@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_rbf_interpolate_grid_matches_jax(kernel, smooth):
    rng = np.random.default_rng(4)
    ue, bs = angle_axes(rng)
    rss = rng.uniform(8.0, 12.0, (len(ue), len(bs)))
    gx = np.linspace(bs.min(), bs.max(), 23)
    gy = np.linspace(ue.min(), ue.max(), 19)
    want = jax_interp.rbf_interpolate_grid(bs, ue, rss, gx, gy, smooth=smooth, kernel=kernel)
    got = interp.rbf_interpolate_grid(bs, ue, rss, gx, gy, smooth=smooth, kernel=kernel)
    assert got.shape == (19, 23)
    np.testing.assert_array_equal(got, want)
    t = interp.rbf_interpolate_grid(bs, ue, torch.from_numpy(rss.astype(np.float32)), gx, gy,
                                    smooth=smooth, kernel=kernel)
    assert t.dtype == torch.float64 and t.shape == (19, 23)
    f32 = jax_interp.rbf_interpolate_grid(bs, ue, rss.astype(np.float32).astype(np.float64),
                                          gx, gy, smooth=smooth, kernel=kernel)
    within_range(t.numpy(), f32)
    with pytest.raises(ValueError, match="RBF kernel"):
        interp.rbf_interpolate_grid(bs, ue, rss, gx, gy, kernel="cubic")


@pytest.mark.parametrize("angles", ["random_f64", "testbed_f32"])
def test_rbf_at_the_reference_shape(angles):
    """64 x 64 centres (a 4,096-unknown solve) onto 100 x 100 queries: at
    random float64 angles, and at the testbed's 64 beam angles in float32
    (the angle LUT's dtype, whose distances numpy takes in float32)."""
    rng = np.random.default_rng(1)
    ue, bs = angle_axes(rng, 64, 64)
    if angles == "testbed_f32":
        ue = bs = ANGLES.astype(np.float32)
    rss = rng.uniform(8.0, 12.0, (64, 64))
    gx = np.linspace(bs.min(), bs.max(), 100)
    gy = np.linspace(ue.min(), ue.max(), 100)
    want = jax_interp.rbf_interpolate_grid(bs, ue, rss, gx, gy, smooth=0.1)
    np.testing.assert_array_equal(interp.rbf_interpolate_grid(bs, ue, rss, gx, gy, smooth=0.1),
                                  want)
    got = interp.rbf_interpolate_grid(bs, ue, torch.from_numpy(rss), gx, gy, smooth=0.1)
    within_range(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_rbf_background_matches_jax(smooth, dtype):
    rng = np.random.default_rng(5)
    ue, bs = (x.astype(dtype) for x in angle_axes(rng, 20, 16))
    rss = rng.uniform(8.0, 12.0, (20, 16))
    want = jax_estimation.rbf_background(rss, ue, bs, 40, smooth)
    got = estimation.rbf_background(rss, ue, bs, 40, smooth, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    within_range(got[2], want[2])


def test_rbf_background_singular_system_gives_zeros():
    """Two centres at the same angle (a repeated beam angle): the linear
    kernel matrix has two equal rows, the reference's fallback draws a
    zero background.  A shape error is not caught."""
    ue = np.array([-10.0, 0.0, 0.0, 10.0])
    bs = np.array([-5.0, 5.0])
    rss = np.arange(8.0).reshape(4, 2)
    want = jax_estimation.rbf_background(rss, ue, bs, 12)[2]
    got = estimation.rbf_background(rss, ue, bs, 12, device="cpu")[2]
    np.testing.assert_array_equal(got, np.zeros((12, 12)))
    np.testing.assert_array_equal(want, np.zeros((12, 12)))
    with pytest.raises(RuntimeError):
        estimation.rbf_background(np.ones((3, 2)), ue, bs, 12, device="cpu")


def test_estimation_plot_writes_png(tmp_path):
    from slam_process_tpu_torch.models.classifiers import classify_advanced

    rng = np.random.default_rng(6)
    ue, bs = angle_axes(rng, 10, 8)
    rss = rng.uniform(8.0, 12.0, (10, 8))
    c = classify_advanced(np.array([1.0, 20.0]), np.array([2.0, -30.0]), np.array([2.0, 1.99]),
                          np.array([True, True]))
    for style in ("v1", "v1-7"):
        out = estimation.estimation_plot(rss, ue, bs, c, tmp_path / f"{style}.png", style=style,
                                         grid_n=30, dpi=50, device="cpu")
        assert out.stat().st_size > 5_000
