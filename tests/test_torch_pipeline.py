"""Port session pipeline (slam_process_tpu_torch) == the JAX package's.

``session_pipeline(device="cpu")`` against JAX's ``session_pipeline`` on the
same padded bytes: frames, frame_valid, n_frames, corrected_bs, keep,
correct_overflow, n_kept and counts exactly; mean_grid bit-equal (cell
sums < 2^24, where JAX's float32 einsum is exact); blurred within 1e-5
relative, norm_t within 1e-3 absolute, LUT-bin flips under 1 % and
premultiplied rgba within 1e-3.  Near the grid's minimum the shifted log
magnifies the float32 rounding of RSS-sized blurred values (JAX blurs with
separable matmuls, the port with direct 7 x 7 sums), so the 2e-5 bound of
the raster unit test does not carry over.  ``Session.from_log`` against
JAX's device engine, and the configs carried over by
``configs_from_reference``.
"""

import functools

import numpy as np
import pytest
import torch

from slam_process_tpu import config as jax_config
from slam_process_tpu.ops.raster import colormap_lut as jax_colormap_lut
from slam_process_tpu.ops.scene import fill_grid as jax_fill_grid
from slam_process_tpu.ops.scene import intensity_grid_jax
from slam_process_tpu.pipeline import device as jax_device
from slam_process_tpu_torch import config
from slam_process_tpu_torch.convert import configs_from_reference
from slam_process_tpu_torch.ops.scene import fill_grid, intensity_grid
from slam_process_tpu_torch.pipeline import device
from slam_process_tpu_torch.pipeline.session import Session
from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, to_hex_text

EXACT = ("frames", "frame_valid", "n_frames", "corrected_bs", "keep", "correct_overflow",
         "n_kept", "counts")


def run_both(raw, n_padded=1 << 16, use_log=True, jax_correct=None, port_configs=None):
    import jax
    import jax.numpy as jnp

    padded = device.pad_bytes(raw, n_padded)
    jax_fn = jax.jit(functools.partial(
        jax_device.session_pipeline, capacity=0, use_log=use_log,
        correct_cfg=jax_correct or jax_config.CorrectConfig()))
    want = jax_fn(jnp.asarray(padded), jnp.int32(len(raw)),
                  jnp.asarray(jax_colormap_lut("viridis")))
    kw = {}
    if port_configs is not None:
        kw = dict(decode_cfg=port_configs[0], correct_cfg=port_configs[1])
    lut = torch.from_numpy(device.colormap_lut("viridis"))
    got = device.session_pipeline(torch.from_numpy(padded), lut, use_log=use_log, **kw)
    return got, want


def assert_outputs_match(got, want):
    for field in EXACT:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    mean, counts = got.mean_grid.numpy(), got.counts.numpy()
    assert np.nanmax(np.nan_to_num(mean) * counts) < 2 ** 24
    np.testing.assert_array_equal(mean, np.asarray(want.mean_grid))   # NaN == NaN here

    b, w_b = got.blurred.numpy(), np.asarray(want.blurred)
    assert (np.isfinite(b) == np.isfinite(w_b)).all()
    fin = np.isfinite(w_b)
    np.testing.assert_allclose(b[fin], w_b[fin], rtol=1e-5)
    t, w_t = got.norm_t.numpy(), np.asarray(want.norm_t)
    assert (np.isfinite(t) == np.isfinite(w_t)).all()
    np.testing.assert_allclose(t[fin], w_t[fin], atol=1e-3)
    bins = np.clip((np.nan_to_num(t) * 256).astype(int), 0, 255)
    w_bins = np.clip((np.nan_to_num(w_t) * 256).astype(int), 0, 255)
    assert (bins != w_bins).mean() < 0.01
    rgba, w_rgba = got.rgba.numpy(), np.asarray(want.rgba)
    assert np.abs(rgba * rgba[..., 3:] - w_rgba * w_rgba[..., 3:]).max() <= 1e-3


SESSIONS = {
    "seed0": dict(n_groups=4, frames_per_beam=2, baselines_per_group=6, seed=0),
    "junk_and_group_over_4096": dict(n_groups=3, frames_per_beam=1, baselines_per_group=4,
                                     junk_frac=0.3, big_group=4200, seed=1),
}


@pytest.mark.parametrize("name", sorted(SESSIONS))
@pytest.mark.parametrize("use_log", [True, False])
def test_session_pipeline_matches_jax(name, use_log):
    got, want = run_both(synthetic_session_bytes(**SESSIONS[name]), use_log=use_log)
    assert int(got.n_kept) > 0 and not bool(got.correct_overflow)
    assert_outputs_match(got, want)


def test_configs_from_reference_match_jax():
    jax_cfgs = (jax_config.DecodeConfig(), jax_config.CorrectConfig(cycle=60_000, tol=300),
                jax_config.SceneConfig(keep_nan=True, fill_with_min=False))
    port_cfgs = configs_from_reference(*jax_cfgs)
    assert [type(c) for c in port_cfgs] == [config.DecodeConfig, config.CorrectConfig,
                                            config.SceneConfig]
    assert port_cfgs[1] == config.CorrectConfig(cycle=60_000, tol=300)
    assert port_cfgs[2].keep_nan and not port_cfgs[2].fill_with_min
    raw = synthetic_session_bytes(**SESSIONS["seed0"])
    got, want = run_both(raw, use_log=False, jax_correct=jax_cfgs[1], port_configs=port_cfgs)
    assert_outputs_match(got, want)
    with pytest.raises(AttributeError):
        configs_from_reference(object(), *jax_cfgs[1:])


@pytest.mark.parametrize("scene", [dict(), dict(keep_nan=True, fill_with_min=False),
                                   dict(flag_filter=0)])
def test_intensity_grid_matches_jax(scene):
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    f = 3000
    ue = rng.integers(-2, 66, f).astype(np.int32)
    bs = rng.integers(0, 40, f).astype(np.int32)
    rss = rng.integers(1, 1 << 18, f).astype(np.int32)
    valid = rng.random(f) < 0.9
    flag = rng.integers(0, 2, f).astype(np.int32)
    jax_cfg = jax_config.SceneConfig(**scene)
    port_cfg = configs_from_reference(jax_config.DecodeConfig(), jax_config.CorrectConfig(),
                                      jax_cfg)[2]
    want = intensity_grid_jax(jnp.asarray(ue), jnp.asarray(bs),
                              jnp.asarray(rss).astype(jnp.float32), jnp.asarray(valid),
                              jnp.asarray(flag), cfg=jax_cfg)
    got = intensity_grid(*(torch.from_numpy(x) for x in (ue, bs, rss, valid, flag)),
                         cfg=port_cfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(fill_grid(got, port_cfg).numpy(),
                                  np.asarray(jax_fill_grid(want, jax_cfg)))


def test_session_from_log_matches_jax(tmp_path):
    from slam_process_tpu.pipeline.session import Session as JaxSession

    path = tmp_path / "Serial Debug 2026-10-16 120000.txt"
    path.write_bytes(to_hex_text(synthetic_session_bytes(
        n_groups=3, frames_per_beam=2, baselines_per_group=5, junk_frac=0.2, seed=8)))
    want = JaxSession.from_log(path, engine="device")
    got = Session.from_log(path, device="cpu")
    for field in ("frames", "corrected_bs", "filtered"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert len(got.filtered) > 0


def test_session_overflow_raises_naming_bounds(tmp_path):
    path = tmp_path / "many_groups.txt"
    path.write_bytes(to_hex_text(synthetic_session_bytes(
        n_groups=257, frames_per_beam=1, baselines_per_group=1, junk_frac=0.0, seed=2)))
    with pytest.raises(RuntimeError, match="max_groups=256.*max_baselines_per_group=256"):
        Session.from_log(path, device="cpu")


def test_run_session_on_device_layout():
    raw = synthetic_session_bytes(**SESSIONS["seed0"])
    out = device.run_session_on_device(raw, device="cpu")
    rows = device.bucket_size(len(raw)) // 11 + 1
    assert out.frames.shape == (rows, 5) and out.frames.dtype == torch.int32
    assert out.frame_valid.dtype == out.keep.dtype == torch.bool
    assert out.mean_grid.shape == out.norm_t.shape == out.blurred.shape == (64, 64)
    assert out.rgba.shape == (64, 64, 4) and out.counts.dtype == torch.int32
    assert int(out.n_frames) == int(out.frame_valid.sum()) == 64 * 4 * 2
