"""The port's heatmap (``Session.render_heatmap``, ``render/``) against the
JAX package's, on the CPU.

JAX renders through its numpy float64 path (``intensity_grid_np`` and
``rasterize`` on an ndarray); the port in float32 through the plain
version of kernel K3.  Held to ``PERF.md`` section 2's contract: the same
NaN pattern, ``blurred`` within rtol 1e-5, ``norm_t`` within 1e-3 of JAX's
norm of its own blurred matrix, LUT-bin flips in under 1 % of cells, and
the angle vectors equal.  For heatmap variants v1 (Parsed rows), v2 (FLAG 1
rows) and v3 (filtered rows), log and linear norm, with and without
explicit vmin / vmax, on the full 64-beam angle table and on one that
leaves beams unmapped (a non-square tile).  Also ``angle_edges``, the PNG's
cells against the port's raster colors, the explicit bounds of
``raster_tiles_plain`` against JAX's ``rasterize``, and the colormap
tables.
"""

import numpy as np
import pytest
import torch

from slam_process_tpu import config as jax_config
from slam_process_tpu.ops import raster as jax_raster
from slam_process_tpu.pipeline.session import Session as JaxSession
from slam_process_tpu.render.figures import angle_edges as jax_angle_edges
from slam_process_tpu_torch.config import RenderConfig, SceneConfig
from slam_process_tpu_torch.ops import raster
from slam_process_tpu_torch.pipeline.session import Session
from slam_process_tpu_torch.render.figures import angle_edges
from slam_process_tpu_torch.utils.synthetic import (
    synthetic_session_bytes, to_hex_text, write_angle_table)

UNMAPPED = (0, 5, 6, 40, 63)
# Bounds inside the data's range: the log form's vmin - min + 1e-6 stays
# positive, as the figure's LogNorm needs.
BOUNDS = {"auto": (None, None), "bounds": (40_000.0, 150_000.0), "vmax_only": (None, 90_000.0)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("render")
    log = tmp / "render.txt"
    log.write_bytes(to_hex_text(synthetic_session_bytes(
        n_groups=3, frames_per_beam=3, baselines_per_group=9, junk_frac=0.2, seed=21)))
    full = write_angle_table(tmp / "angles_full.xlsx")
    partial = write_angle_table(tmp / "angles_partial.xlsx", unmapped=UNMAPPED)
    s = JaxSession.from_log(log)
    s.correct()
    s.export_parsed(tmp / "parsed.xlsx")
    s.export_filtered(tmp / "filtered.xlsx")
    return tmp, {"full": full, "partial": partial}


def sessions(tmp, variant):
    """(port session, JAX session, source) of a heatmap variant."""
    if variant == "v3":
        return (Session.from_filtered_xlsx(tmp / "filtered.xlsx"),
                JaxSession.from_filtered_xlsx(tmp / "filtered.xlsx"), "filtered")
    return (Session.from_parsed_xlsx(tmp / "parsed.xlsx"),
            JaxSession.from_parsed_xlsx(tmp / "parsed.xlsx"), "parsed")


def bins(t):
    return np.clip((np.nan_to_num(t) * 256).astype(int), 0, 255)


def assert_raster_contract(got, jax_blurred, jax_norm):
    """PERF.md section 2: blurred rtol 1e-5, norm_t 1e-3, flips < 1 %."""
    assert got.blurred.shape == jax_blurred.shape
    assert (np.isnan(got.blurred) == np.isnan(jax_blurred)).all()
    np.testing.assert_allclose(got.blurred, jax_blurred, rtol=1e-5, equal_nan=True)
    assert (np.isnan(got.norm_t) == np.isnan(jax_norm)).all()
    fin = ~np.isnan(jax_norm)
    np.testing.assert_allclose(got.norm_t[fin], jax_norm[fin], atol=1e-3)
    assert (bins(got.norm_t) != bins(jax_norm)).mean() < 0.01


@pytest.mark.parametrize("table", ["full", "partial"])
@pytest.mark.parametrize("bounds", sorted(BOUNDS))
@pytest.mark.parametrize("use_log", [True, False], ids=["log", "linear"])
@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_render_heatmap_matches_jax(files, variant, use_log, bounds, table):
    tmp, tables = files
    vmin, vmax = BOUNDS[bounds]
    port, jax_s, source = sessions(tmp, variant)
    flag = 1 if variant == "v2" else None
    got = port.render_heatmap(
        tables[table], None, SceneConfig(keep_nan=True, fill_with_min=False, flag_filter=flag),
        RenderConfig(use_log=use_log, vmin=vmin, vmax=vmax), source=source, device="cpu")
    want = jax_s.render_heatmap(
        tables[table], None,
        jax_config.SceneConfig(keep_nan=True, fill_with_min=False, flag_filter=flag),
        jax_config.RenderConfig(use_log=use_log, vmin=vmin, vmax=vmax), source=source)
    norm = jax_raster.shifted_log_norm if use_log else jax_raster.linear_norm
    jax_norm = norm(np.asarray(want.blurred), vmin, vmax)
    assert_raster_contract(got, np.asarray(want.blurred), jax_norm)
    np.testing.assert_array_equal(got.aod_angles, want.aod_angles)
    np.testing.assert_array_equal(got.aoa_angles, want.aoa_angles)
    n_mapped = 64 - (len(UNMAPPED) if table == "partial" else 0)
    assert got.rgba.dtype == np.uint8 and got.rgba.shape[2] == 4
    assert got.rgba.shape[0] <= n_mapped and got.rgba.shape[1] <= n_mapped
    assert (got.rgba != want.rgba).any(axis=-1).mean() < 0.01
    if table == "partial":
        assert got.rgba.shape[:2] != (64, 64)


def test_intensity_matches_jax(files):
    tmp, _ = files
    port, jax_s, _ = sessions(tmp, "v1")
    for source, cfg in (("parsed", SceneConfig(flag_filter=1)), ("filtered", SceneConfig())):
        got = port.intensity(cfg, source=source, device="cpu")
        want = jax_s.intensity(jax_config.SceneConfig(flag_filter=cfg.flag_filter),
                               source=source)
        np.testing.assert_array_equal(got.counts, want.counts)
        np.testing.assert_array_equal(got.row_mask, want.row_mask)
        np.testing.assert_array_equal(got.col_mask, want.col_mask)
        np.testing.assert_allclose(got.mean, want.mean, rtol=1e-6, equal_nan=True)
        assert got.mean.dtype == np.float32


def test_angle_edges_match_jax():
    for vals in ([1.0, 2.0, 4.0], [3.0], np.linspace(-43.6, 45.0, 64)):
        np.testing.assert_array_equal(angle_edges(vals), jax_angle_edges(vals))
    np.testing.assert_allclose(angle_edges([1.0, 2.0, 4.0]), [0.5, 1.5, 3.0, 5.0])


@pytest.mark.parametrize("bounds", sorted(BOUNDS))
@pytest.mark.parametrize("use_log", [True, False], ids=["log", "linear"])
def test_png_cells_match_the_port_raster(files, tmp_path, use_log, bounds):
    """The PNG's cells are the port's raster colors: the figure's
    matplotlib norm and colormap recolor the blurred matrix as the raster
    did (the counterpart of tests/test_render.py's figure check)."""
    import matplotlib
    from matplotlib.colors import LogNorm, Normalize

    tmp, tables = files
    vmin, vmax = BOUNDS[bounds]
    port, _, source = sessions(tmp, "v3")
    cfg = RenderConfig(use_log=use_log, vmin=vmin, vmax=vmax)
    png = tmp_path / "heat.png"
    rendered = port.render_heatmap(tables["partial"], png, render_cfg=cfg, source=source,
                                   device="cpu")
    assert png.stat().st_size > 10_000
    m = rendered.blurred.astype(np.float64)
    finite = np.isfinite(m)
    if use_log:
        mn = m[finite].min()
        data = m - mn + 1e-6
        norm = LogNorm(vmin=(vmin - mn + 1e-6) if vmin is not None else data[finite].min(),
                       vmax=(vmax - mn + 1e-6) if vmax is not None else data[finite].max())
    else:
        data = m
        norm = Normalize(vmin=vmin if vmin is not None else m[finite].min(),
                         vmax=vmax if vmax is not None else m[finite].max())
    cmap = matplotlib.colormaps["viridis"].copy()
    cmap.set_bad((1, 1, 1, 0))
    fig = cmap(norm(np.ma.masked_invalid(data)))
    dev = rendered.rgba.astype(np.float64) / 255.0
    diff = np.abs(fig * fig[..., 3:4] - dev * dev[..., 3:4])
    # A cell on a LUT bin's edge may fall in the neighbouring bin (float32
    # against float64); every other cell is the same color.
    assert (diff.max(axis=-1) > 0.5 / 255.0 + 1e-3).mean() < 0.01


@pytest.mark.parametrize("vmin,vmax", [(None, None), (0.3, None), (None, 1.1), (-5.0, 0.7),
                                       (0.2, 0.8)])
@pytest.mark.parametrize("use_log", [True, False], ids=["log", "linear"])
def test_plain_raster_bounds_match_jax_rasterize(use_log, vmin, vmax):
    rng = np.random.default_rng(8)
    mats = rng.random((3, 20, 30)).astype(np.float32)
    mats[rng.random(mats.shape) < 0.05] = np.nan
    taps = raster.blur_taps(1.0, "cpu")
    lut = torch.from_numpy(raster.colormap_lut("viridis"))
    rgba, t, b = (x.numpy() for x in raster.raster_tiles_plain(
        torch.from_numpy(mats), lut, taps, use_log, vmin, vmax))
    for i, m in enumerate(mats):
        want_rgba, want_b = jax_raster.rasterize(m.astype(np.float64), blur_sigma=1.0,
                                                 use_log=use_log, vmin=vmin, vmax=vmax,
                                                 as_u8=False)
        norm = jax_raster.shifted_log_norm if use_log else jax_raster.linear_norm
        want_t = norm(want_b, vmin, vmax)
        np.testing.assert_allclose(b[i], want_b, rtol=1e-5, equal_nan=True)
        assert (np.isnan(t[i]) == np.isnan(want_t)).all()
        fin = ~np.isnan(want_t)
        np.testing.assert_allclose(t[i][fin], want_t[fin], atol=1e-3)
        assert (bins(t[i]) != bins(want_t)).mean() < 0.01
        assert (np.abs(rgba[i] - want_rgba) > 1e-6).any(axis=-1).mean() < 0.01


def test_vmax_below_the_minimum_is_transparent_as_in_jax():
    m = np.full((1, 6, 6), 5.0, dtype=np.float32)
    m[0, 2, 3] = 9.0
    lut = torch.from_numpy(raster.colormap_lut("viridis"))
    rgba, t, _ = raster.raster_tiles_plain(torch.from_numpy(m), lut, raster.blur_taps(1.0, "cpu"),
                                           True, None, 1.0)
    want = jax_raster.shifted_log_norm(m[0].astype(np.float64), None, 1.0)
    assert np.isnan(want).all() and torch.isnan(t).all() and (rgba == 0).all()


@pytest.mark.parametrize("name", ["viridis", "magma", "coolwarm"])
def test_colormap_tables_match_jax(name):
    np.testing.assert_array_equal(raster.colormap_lut(name), jax_raster.colormap_lut(name))


def test_non_viridis_heatmap_matches_jax(files):
    tmp, tables = files
    port, jax_s, source = sessions(tmp, "v3")
    got = port.render_heatmap(tables["full"], None, render_cfg=RenderConfig(colormap="magma"),
                              source=source, device="cpu")
    want = jax_s.render_heatmap(tables["full"], None,
                                render_cfg=jax_config.RenderConfig(colormap="magma"),
                                source=source)
    assert (got.rgba != want.rgba).any(axis=-1).mean() < 0.01


def test_to_u8_matches_jax():
    x = np.random.default_rng(3).random((7, 9, 4)).astype(np.float32)
    x[0, 0] = (0.0, 1.0, 0.5, 1.0 / 510)
    np.testing.assert_array_equal(raster.to_u8(torch.from_numpy(x)).numpy(),
                                  jax_raster.to_u8(x))


def test_render_config_from_reference_matches_jax():
    from slam_process_tpu_torch.convert import render_config_from_reference

    jax_cfg = jax_config.RenderConfig(colormap="magma", use_log=False, vmin=1.0, vmax=9.0,
                                      grid_size=[50, 60], dpi=72)
    got = render_config_from_reference(jax_cfg)
    assert got == RenderConfig(colormap="magma", use_log=False, vmin=1.0, vmax=9.0,
                               grid_size=(50, 60), dpi=72)
    assert render_config_from_reference(jax_config.RenderConfig()) == RenderConfig()
    with pytest.raises(AttributeError):
        render_config_from_reference(object())
