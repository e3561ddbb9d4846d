"""Port raster (slam_process_tpu_torch) == the JAX package's rasters.

The plain raster (the CPU side of kernel K3) against the Pallas raster
kernel in interpret mode and the ``ops/raster.py`` XLA chain, on the
small-magnitude tiles of tests/test_pallas_raster.py: ``norm_t`` within
2e-5, the same NaN pattern and LUT-bin flips under 1 %, as that test
holds the Pallas kernel.  All-NaN and one-cell tiles, the shipped viridis
table, and the blur against the float64 oracle.
"""

import numpy as np
import pytest
import torch

from slam_process_tpu.ops import raster as jax_raster
from slam_process_tpu.ops.pallas_raster import pallas_rasterize_batch
from slam_process_tpu_torch.ops import raster


def small_tiles(seed=30):
    rng = np.random.default_rng(seed)
    mats = rng.normal(size=(3, 64, 64)).astype(np.float32) * 20 - 70
    mats[rng.random(mats.shape) < 0.05] = np.nan
    return mats


def xla_chain(mats, use_log):
    """ops/raster.py's XLA raster, tile by tile."""
    import jax.numpy as jnp

    lut = jnp.asarray(jax_raster.colormap_lut("viridis"))
    out = []
    for m in mats:
        b = jax_raster.blur_nan_aware_jax(jnp.asarray(m), 1.0)
        t = jax_raster.shifted_log_norm(b) if use_log else jax_raster.linear_norm(b)
        out.append((np.asarray(jax_raster.apply_colormap_float(t, lut)), np.asarray(t),
                    np.asarray(b)))
    return tuple(np.stack(x) for x in zip(*out))


def port_raster(mats, use_log):
    lut = torch.from_numpy(raster.colormap_lut("viridis"))
    return tuple(x.numpy() for x in raster.rasterize_tiles(torch.from_numpy(mats), lut,
                                                            1.0, use_log))


def assert_raster_close(t, ref_t, rgba, ref_rgba, atol=2e-5):
    assert (np.isfinite(t) == np.isfinite(ref_t)).all()
    both = np.isfinite(t)
    np.testing.assert_allclose(t[both], ref_t[both], atol=atol)
    bins = np.clip((np.nan_to_num(t) * 256).astype(int), 0, 255)
    ref_bins = np.clip((np.nan_to_num(ref_t) * 256).astype(int), 0, 255)
    assert (bins != ref_bins).mean() < 0.01
    assert np.quantile(np.abs(rgba - ref_rgba), 0.99) < 1e-5


@pytest.mark.parametrize("use_log", [True, False])
def test_plain_raster_matches_pallas_and_xla(use_log):
    mats = small_tiles()
    rgba, t, blurred = port_raster(mats, use_log)
    assert rgba.shape == (3, 64, 64, 4) and t.shape == blurred.shape == (3, 64, 64)
    p_rgba, p_t = pallas_rasterize_batch(mats, jax_raster.colormap_lut("viridis"),
                                         blur_sigma=1.0, use_log=use_log, interpret=True)
    assert_raster_close(t, np.asarray(p_t), rgba, np.asarray(p_rgba))
    x_rgba, x_t, x_b = xla_chain(mats, use_log)
    assert_raster_close(t, x_t, rgba, x_rgba)
    fin = np.isfinite(x_b)
    assert (np.isfinite(blurred) == fin).all()
    np.testing.assert_allclose(blurred[fin], x_b[fin], rtol=1e-5)


@pytest.mark.parametrize("use_log", [True, False])
def test_all_nan_and_one_cell_tiles(use_log):
    mats = np.full((2, 64, 64), np.nan, dtype=np.float32)
    mats[1, 17, 40] = 1234.0
    rgba, t, blurred = port_raster(mats, use_log)
    assert np.isnan(t[0]).all() and np.isnan(blurred[0]).all() and not rgba[0].any()
    reach = np.zeros((64, 64), bool)
    reach[14:21, 37:44] = True                 # the 7 x 7 taps around the cell
    assert (np.isfinite(t[1]) == reach).all()
    np.testing.assert_allclose(blurred[1][reach], 1234.0, rtol=1e-6)
    p_rgba, p_t = pallas_rasterize_batch(mats, jax_raster.colormap_lut("viridis"),
                                         blur_sigma=1.0, use_log=use_log, interpret=True)
    assert_raster_close(t, np.asarray(p_t), rgba, np.asarray(p_rgba))


def test_viridis_asset_equals_matplotlib():
    lut = raster.colormap_lut("viridis")
    assert lut.dtype == np.float32 and lut.shape == (256, 4)
    np.testing.assert_array_equal(lut, jax_raster.colormap_lut("viridis"))
    # Names not shipped come from matplotlib, as the JAX package's do.
    np.testing.assert_array_equal(raster.colormap_lut("magma"), jax_raster.colormap_lut("magma"))
    with pytest.raises(KeyError):
        raster.colormap_lut("no_such_colormap")


@pytest.mark.parametrize("sigma", [0.0, 0.5, 1.0, 2.3])
def test_gaussian_kernel_equals_jax(sigma):
    np.testing.assert_array_equal(raster.gaussian_kernel_np(sigma),
                                  jax_raster.gaussian_kernel_np(sigma))


@pytest.mark.parametrize("shape,sigma", [((64, 64), 1.0), ((48, 100), 2.0), ((5, 7), 1.0)])
def test_blur_matches_f64_oracle(shape, sigma):
    rng = np.random.default_rng(7)
    data = (rng.random(shape) * (1 << 18)).astype(np.float32)
    data[rng.random(shape) < 0.1] = np.nan
    got = raster.blur_nan_aware(torch.from_numpy(data),
                                raster.blur_taps(sigma, "cpu")).numpy()
    want = jax_raster.blur_nan_aware_np(data.astype(np.float64), sigma)
    assert (np.isfinite(got) == np.isfinite(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
