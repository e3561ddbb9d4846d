"""The pre-log scene (``SceneConfig.log_transform``: rows with RSS <= 0
dropped, ln(RSS) summed) on the port's device paths, on the CPU.

  * ``intensity_grid`` and the per-sweep sums against the JAX package's
    ``intensity_grid_jax`` / scan engine and against the float64 oracle
    ``intensity_grid_np``: counts equal, means within rtol 1e-6 of the
    oracle (ln and the sums are float64, each mean rounded to float32
    once) and within JAX's own rtol 3e-5 / atol 3e-4 of JAX
    (``tests/test_scene.py``'s tolerance between its float32 sums and the
    oracle);
  * ``run_session_on_device(log_transform_scene=True)`` against JAX's
    ``session_pipeline`` on the same bytes and against the oracle built
    from the session's filtered rows;
  * a pre-log device stream against the offline grid within rtol 1e-5 /
    atol 1e-5 (``tests/test_streaming_device.py``'s tolerance) and against
    the oracle within rtol 1e-6, with its online paths' per-sweep sums
    still integer; a checkpoint round trip (the float64 sums under the
    same leaf) equal to the uninterrupted stream, and a checkpoint restored
    under the other scene config refused.
"""

import pickle

import numpy as np
import pytest
import torch

from slam_process_tpu_torch.config import PipelineConfig, SceneConfig
from slam_process_tpu_torch.ops.scene import (
    intensity_cell_sums, intensity_grid, intensity_grid_np, intensity_per_sweep)
from slam_process_tpu_torch.parallel.streaming_device import (
    DeviceStreamingSession, make_paths_spec, replay_log_device)
from slam_process_tpu_torch.pipeline.device import run_session_on_device
from slam_process_tpu_torch.pipeline.session import Session
from slam_process_tpu_torch.utils.synthetic import (
    synthetic_session_bytes, to_hex_text, write_angle_table)

LOG = SceneConfig(log_transform=True)
PRELOG = PipelineConfig(scene=LOG)


def random_rows(seed, n=3000):
    """Rows over the 64 x 64 grid, RSS over the 18-bit range with some rows
    of RSS 0 (dropped by the pre-log rule) and some ids out of range."""
    rng = np.random.default_rng(seed)
    ue = rng.integers(-2, 66, n)
    bs = rng.integers(-2, 66, n)
    rss = rng.integers(0, 1 << 18, n)
    rss[rng.random(n) < 0.05] = 0
    return ue, bs, rss


def assert_close_to_oracle(mean, counts, ref, rtol):
    np.testing.assert_array_equal(counts, ref.counts)
    assert (np.isnan(mean) == np.isnan(ref.mean)).all()
    np.testing.assert_allclose(mean, ref.mean, rtol=rtol, atol=0, equal_nan=True)


@pytest.mark.parametrize("seed", [8, 9])
def test_grid_matches_jax_and_oracle(seed):
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.config import SceneConfig as JaxSceneConfig
    from slam_process_tpu.ops.scene import intensity_grid_jax

    ue, bs, rss = random_rows(seed)
    ref = intensity_grid_np(ue, bs, rss, cfg=LOG)
    valid = torch.ones(len(ue), dtype=torch.bool)
    got = intensity_grid(*(torch.from_numpy(x).to(torch.int32) for x in (ue, bs, rss)), valid,
                         cfg=LOG)
    assert got.mean.dtype == torch.float32 and got.counts.dtype == torch.int32
    assert_close_to_oracle(got.mean.numpy(), got.counts.numpy(), ref, rtol=1e-6)
    np.testing.assert_allclose(float(got.fill_value), ref.fill_value, rtol=1e-6)
    np.testing.assert_array_equal(got.row_mask.numpy(), ref.row_mask)
    np.testing.assert_array_equal(got.col_mask.numpy(), ref.col_mask)

    jcfg = JaxSceneConfig(log_transform=True)
    want = jax.jit(lambda u, b, r, v: intensity_grid_jax(u, b, r, v, cfg=jcfg))(
        jnp.asarray(ue, jnp.int32), jnp.asarray(bs, jnp.int32), jnp.asarray(rss, jnp.float32),
        jnp.asarray(valid.numpy()))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=3e-5, atol=3e-4,
                               equal_nan=True)


def test_cell_sums_are_float64_and_drop_nonpositive_rss():
    ue = torch.tensor([1, 1, 1, 2, 3], dtype=torch.int32)
    bs = torch.tensor([4, 4, 4, 5, 6], dtype=torch.int32)
    rss = torch.tensor([np.e ** 2, 1, 0, 7, -3]).round().to(torch.int32)
    valid = torch.ones(5, dtype=torch.bool)
    sums, counts = intensity_cell_sums(ue, bs, rss, valid, cfg=LOG)
    assert sums.dtype == torch.float64 and counts.dtype == torch.int64
    assert int(counts[1, 4]) == 2 and int(counts[2, 5]) == 1 and int(counts.sum()) == 3
    assert float(sums[1, 4]) == np.log(7.0) + np.log(1.0)
    sums, counts = intensity_cell_sums(ue, bs, rss.clamp(min=0), valid)
    assert sums.dtype == torch.int64 and int(counts.sum()) == 5
    with pytest.raises(ValueError, match="integer RSS"):
        intensity_cell_sums(ue, bs, rss.float(), valid)


def test_per_sweep_sums_match_jax_scan_and_oracle():
    import jax.numpy as jnp

    from slam_process_tpu.config import SceneConfig as JaxSceneConfig
    from slam_process_tpu.ops.scene import intensity_per_sweep_jax

    ue, bs, rss = random_rows(3, n=4000)
    gid = np.sort(np.random.default_rng(3).integers(-1, 6, len(ue)))
    n_sweeps = 5                      # rows of sweep 5 and of -1 are dropped
    cols = [torch.from_numpy(x).to(torch.int32) for x in (ue, bs, rss, gid)]
    valid = torch.ones(len(ue), dtype=torch.bool)
    mean, counts = intensity_per_sweep(*cols, valid, n_sweeps, LOG)
    assert mean.dtype == torch.float32 and counts.dtype == torch.int32
    for s in range(n_sweeps):
        rows = gid == s
        ref = intensity_grid_np(ue[rows], bs[rows], rss[rows], cfg=LOG)
        assert_close_to_oracle(mean[s].numpy(), counts[s].numpy(), ref, rtol=1e-6)
    want_mean, want_counts = intensity_per_sweep_jax(
        jnp.asarray(ue, jnp.int32), jnp.asarray(bs, jnp.int32), jnp.asarray(rss, jnp.float32),
        jnp.asarray(gid, jnp.int32), jnp.asarray(valid.numpy()), n_sweeps,
        JaxSceneConfig(log_transform=True))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), rtol=3e-5, atol=3e-4,
                               equal_nan=True)


@pytest.fixture(scope="module")
def session_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prelog")
    raw = synthetic_session_bytes(n_groups=5, frames_per_beam=3, baselines_per_group=9,
                                  junk_frac=0.05, seed=12, n_paths=2)
    log = tmp / "prelog.txt"
    log.write_bytes(to_hex_text(raw, "shipped"))
    return raw, log, write_angle_table(tmp / "beam_angle.xlsx")


def test_session_pipeline_matches_jax_and_oracle(session_files):
    import functools

    import jax
    import jax.numpy as jnp

    from slam_process_tpu.ops.decode import frame_capacity
    from slam_process_tpu.ops.raster import colormap_lut
    from slam_process_tpu.pipeline.device import bucket_size, pad_bytes, session_pipeline

    raw, log, _ = session_files
    got = run_session_on_device(raw, device="cpu", log_transform_scene=True)
    n = bucket_size(len(raw))
    want = jax.jit(functools.partial(session_pipeline, capacity=frame_capacity(n),
                                     log_transform_scene=True))(
        jnp.asarray(pad_bytes(raw, n)), jnp.int32(len(raw)), jnp.asarray(colormap_lut("viridis")))
    for field in ("frames", "frame_valid", "corrected_bs", "keep", "counts"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_allclose(got.mean_grid.numpy(), np.asarray(want.mean_grid), rtol=3e-5,
                               atol=3e-4, equal_nan=True)
    np.testing.assert_allclose(got.norm_t.numpy(), np.asarray(want.norm_t), atol=1e-3,
                               equal_nan=True)
    f = Session.from_log(log, device="cpu").filtered
    ref = intensity_grid_np(f[:, 0], f[:, 1], f[:, 2], cfg=LOG)
    assert_close_to_oracle(got.mean_grid.numpy(), got.counts.numpy(), ref, rtol=1e-6)
    # The linear scene is unchanged by the option's default.
    linear = run_session_on_device(raw, device="cpu")
    assert torch.equal(linear.counts, got.counts)
    assert not torch.equal(torch.nan_to_num(linear.mean_grid), torch.nan_to_num(got.mean_grid))


def test_prelog_stream_matches_offline(session_files):
    raw, log, angles = session_files
    f = Session.from_log(log, device="cpu").filtered
    ref = intensity_grid_np(f[:, 0], f[:, 1], f[:, 2], cfg=LOG)
    spec = make_paths_spec(angles, s_step=16)
    s = replay_log_device(raw, chunk_bytes=1 << 12, config=PRELOG, device="cpu",
                          collect_filtered=True, collect_paths=spec)
    assert s._state.sums.dtype == torch.float64
    np.testing.assert_array_equal(s.filtered, f)
    grid = s.intensity()
    np.testing.assert_array_equal(grid.counts, ref.counts)
    np.testing.assert_allclose(grid.mean, ref.mean, rtol=1e-5, atol=1e-5, equal_nan=True)
    np.testing.assert_allclose(grid.mean, ref.mean, rtol=1e-6, atol=0, equal_nan=True)
    # The online paths run on the integer per-sweep sums of the linear scene.
    linear = replay_log_device(raw, chunk_bytes=1 << 12, device="cpu", collect_paths=spec)
    for a, b in zip(s.sweep_paths()[0], linear.sweep_paths()[0]):
        np.testing.assert_array_equal(a, b)


def test_prelog_checkpoint_round_trip(session_files, tmp_path):
    raw, _, angles = session_files
    spec = make_paths_spec(angles, s_step=16)
    kw = dict(config=PRELOG, collect_filtered=True, collect_paths=spec, device="cpu")
    full = replay_log_device(raw, chunk_bytes=1 << 12, emit_capacity=1 << 16, **kw)
    # Float64 sums add in window order, so both streams are fed the same
    # chunks (``replay_log_device``'s) and make the same windows.
    chunks = [raw[off:off + (1 << 12)] for off in range(0, len(raw), 1 << 12)]
    half = len(chunks) // 2
    part = DeviceStreamingSession(chunk_bytes=1 << 12, emit_capacity=1 << 16, **kw)
    for chunk in chunks[:half]:
        part.feed(chunk)
    path = tmp_path / "prelog.ckpt"
    part.save_checkpoint(path)
    with np.load(path) as z:
        arrays = dict(z)
    sums_leaf = [k for k, v in arrays.items() if k.startswith("leaf_") and v.dtype == np.float64]
    assert sums_leaf == ["leaf_0002"]         # the running sums keep their key
    resumed = DeviceStreamingSession.restore(path, device="cpu")
    assert resumed.config.scene.log_transform
    for chunk in chunks[half:]:
        resumed.feed(chunk)
    resumed.finalize()
    np.testing.assert_array_equal(resumed.filtered, full.filtered)
    np.testing.assert_array_equal(resumed.intensity().counts, full.intensity().counts)
    np.testing.assert_array_equal(resumed.intensity().mean, full.intensity().mean)
    for a, b in zip(resumed.sweep_paths()[0], full.sweep_paths()[0]):
        np.testing.assert_array_equal(a, b)

    # The same leaves under the linear scene's config: its int64 sums refuse
    # the float64 leaf, and the other way round.
    meta = pickle.loads(arrays["meta"].tobytes())
    for config, leaf in ((PipelineConfig(), arrays["leaf_0002"]),
                         (PRELOG, arrays["leaf_0002"].astype(np.int64))):
        blob = np.frombuffer(pickle.dumps(dict(meta, config=config)), dtype=np.uint8)
        with open(tmp_path / "other.ckpt", "wb") as fh:
            np.savez(fh, **dict(arrays, meta=blob, leaf_0002=leaf))
        with pytest.raises(ValueError, match="checkpoint leaf 2"):
            DeviceStreamingSession.restore(tmp_path / "other.ckpt", device="cpu")
