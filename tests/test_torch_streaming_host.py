"""The port's host streaming session (``parallel/streaming.py``) and the
device session's ``render()``, on the CPU.

A synthetic session of planted multipath (``n_paths=3``, 5 sweeps, 0.5 deg
grids, the sizes of ``tests/test_torch_streaming.py``) goes through:

  * the port's ``StreamingSession`` and the JAX package's, at 7 bytes (under
    one frame), 4 KiB and 64 KiB chunks: frame / kept / group counts,
    ``filtered`` and the running sums and counts equal; NN-OMP indices,
    ``n_iters``, ``valid`` and sweep validity equal, power within rtol 2e-4;
    anchors equal; ``track_columns`` equal to the session's own
    ``path_tracks`` column for column;
  * the port's offline ``Session`` and device stream: equal exactly, which
    shows that a batch of one sweep gives the offline [S]-batch's result
    (the JAX host engine pads each call to eight lanes for its CPU GEMMs);
  * checkpoints: a resume equals an uninterrupted run, and a checkpoint of
    the other engine is refused both ways;
  * ``DeviceStreamingSession.render()`` on the CPU against the JAX host
    session's ``render()`` on the same stream (blurred rtol 1e-5, norm_t
    1e-3 of JAX's norm of its blurred matrix, < 1 % LUT-bin flips), and the
    host session's ``render()`` equal to it.
"""

import numpy as np
import pytest
import torch

from slam_process_tpu.ops import raster as jax_raster
from slam_process_tpu.parallel import streaming as jax_streaming
from slam_process_tpu.parallel import streaming_device as jax_sd
from slam_process_tpu_torch.config import PipelineConfig, SceneConfig
from slam_process_tpu_torch.io.angles import load_angle_lut
from slam_process_tpu_torch.parallel.streaming import StreamingSession, iter_chunks, replay_log
from slam_process_tpu_torch.parallel.streaming_device import (
    DeviceStreamingSession, make_paths_spec, replay_log_device)
from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, write_angle_table

SESSION = dict(n_groups=5, frames_per_beam=8, baselines_per_group=9, junk_frac=0.05, seed=3,
               n_paths=3)
EST = dict(grid_res=0.5)
CHUNKS = [7, 1 << 12, 1 << 16]


@pytest.fixture(scope="module")
def raw():
    return synthetic_session_bytes(**SESSION)


@pytest.fixture(scope="module")
def angles(tmp_path_factory):
    return write_angle_table(tmp_path_factory.mktemp("host_stream") / "beam_angle.xlsx")


@pytest.fixture(scope="module")
def spec(angles):
    return make_paths_spec(angles, s_step=8, **EST)


@pytest.fixture(scope="module")
def jax_spec(angles):
    return jax_sd.make_paths_spec(angles, s_step=8, **EST)


@pytest.fixture(scope="module")
def device_stream(raw, spec):
    return replay_log_device(raw, chunk_bytes=1 << 12, device="cpu", collect_filtered=True,
                             collect_paths=spec)


def readers(s):
    return s.sweep_paths(), s.sweep_times(), s.path_tracks()


def assert_paths_equal(a, b, exact=True):
    (pa, va), ta, (tra, tta, vela) = a
    (pb, vb), tb, (trb, ttb, velb) = b
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(tta, ttb)
    for name in pb._fields:
        got, want = np.asarray(getattr(pa, name)), np.asarray(getattr(pb, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if name == "power" and not exact:
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("pos_aoa", "pos_aod", "power", "observed", "created"):
        got, want = np.asarray(getattr(tra, name)), np.asarray(getattr(trb, name))
        if name == "power" and not exact:
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert int(tra.n_tracks) == int(trb.n_tracks)
    for x, y in zip(vela, velb):
        if exact:
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-3, atol=1e-9)


def assert_columns_equal_tracks(s):
    """``track_columns`` read in pieces == ``path_tracks``' tensors."""
    tracks, times, _ = s.path_tracks()
    n = s.n_sweeps_closed
    parts = [s.track_columns(lo, min(lo + 2, n)) for lo in range(0, n, 2)]
    for i, name in enumerate(("pos_aoa", "pos_aod", "power", "observed")):
        np.testing.assert_array_equal(np.concatenate([p[i] for p in parts]).T,
                                      getattr(tracks, name))
    np.testing.assert_array_equal(np.concatenate([p[4] for p in parts]), times)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_host_stream_matches_jax_host_stream(raw, spec, jax_spec, chunk):
    ours = replay_log(raw, chunk_bytes=chunk, collect_paths=spec)
    ref = jax_streaming.replay_log(raw, chunk_bytes=chunk, collect_paths=jax_spec)
    for name in ("n_frames", "n_kept", "n_groups", "n_sweeps_closed"):
        assert getattr(ours, name) == getattr(ref, name), name
    np.testing.assert_array_equal(ours.filtered, ref.filtered)
    np.testing.assert_array_equal(ours._sums, ref._sums)
    np.testing.assert_array_equal(ours._counts, ref._counts)
    a, b = ours.intensity(), ref.intensity()
    for name in ("mean", "counts", "row_mask", "col_mask", "fill_value"):
        np.testing.assert_array_equal(getattr(a, name), np.asarray(getattr(b, name)), name)
    assert ours.n_sweeps_closed == 5
    assert_paths_equal(readers(ours), readers(ref), exact=False)
    assert_columns_equal_tracks(ours)
    jax_cols = ref.track_columns(0, ref.n_sweeps_closed)
    for got, want in zip(ours.track_columns(0, ours.n_sweeps_closed), jax_cols):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_batch_of_one_equals_offline_batch(raw, spec, device_stream, chunk):
    """One sweep per estimator call (the host engine) == the device stream,
    which equals the offline [S] batch (``tests/test_torch_streaming.py``),
    exactly."""
    ours = replay_log(raw, chunk_bytes=chunk, collect_paths=spec)
    np.testing.assert_array_equal(ours.filtered, device_stream.filtered)
    np.testing.assert_array_equal(ours.intensity().mean, device_stream.intensity().mean)
    assert_paths_equal(readers(ours), readers(device_stream), exact=True)
    assert int(ours.path_tracks()[0].n_tracks) > 0 and ours.sweep_paths()[0].valid.sum() > 5


def test_chunks_and_replay(raw):
    assert [len(c) for c in iter_chunks(raw[:25], 10)] == [10, 10, 5]
    s = StreamingSession()
    n = sum(s.feed(c) for c in iter_chunks(raw, 5_000))
    s.finalize()
    assert n == s.n_frames == replay_log(raw).n_frames > 0


def test_log_transform_sums_match_jax(raw):
    from slam_process_tpu import config as jax_config

    ours = replay_log(raw, chunk_bytes=1 << 12,
                      config=PipelineConfig(scene=SceneConfig(log_transform=True)))
    ref = jax_streaming.replay_log(raw, chunk_bytes=1 << 12, config=jax_config.PipelineConfig(
        scene=jax_config.SceneConfig(log_transform=True)))
    np.testing.assert_array_equal(ours._counts, ref._counts)
    np.testing.assert_allclose(ours._sums, ref._sums, rtol=1e-12)


def test_state_errors_and_empty_stream(spec):
    s = StreamingSession()
    for reader in (s.sweep_paths, s.path_tracks, s.sweep_times, lambda: s.n_sweeps_closed,
                   lambda: s.track_columns(0, 1)):
        with pytest.raises(ValueError, match="collect_paths"):
            reader()
    s.feed(b"\x00" * 100)
    s.finalize()
    s.finalize()                          # idempotent
    with pytest.raises(RuntimeError, match="already finalized"):
        s.feed(b"\x00" * 100)

    s = StreamingSession(collect_paths=spec)
    s.feed(np.zeros(4096, np.uint8))
    s.finalize()
    paths, valid = s.sweep_paths()
    assert s.n_sweeps_closed == 0 and len(valid) == 0 and paths.aoa.shape == (0, 3)
    assert paths.n_iters.dtype == np.int32 and paths.valid.dtype == bool
    tracks, times, _ = s.path_tracks()
    assert int(tracks.n_tracks) == 0 and len(times) == 0 and s.track_columns(0, 3)[0].shape == (
        0, spec[0].max_tracks)


@pytest.mark.parametrize("kind", ["paths", "filtered"])
def test_checkpoint_resume_equals_uninterrupted(raw, spec, tmp_path, kind):
    kw = dict(collect_paths=spec) if kind == "paths" else {}
    full = replay_log(raw, chunk_bytes=1 << 12, **kw)
    part = StreamingSession(**kw)
    split = len(raw) // 2 + 7                # mid-frame, so the byte carry is non-empty
    part.feed(raw[:split])
    if kind == "paths":
        part.track_columns(0, part.n_sweeps_closed)   # a cached tracker needs no state
    path = tmp_path / f"{kind}.ckpt"
    part.save_checkpoint(path, extra={"pos": split, "text_carry": b"1A"})
    assert not (tmp_path / f"{kind}.ckpt.tmp").exists()
    resumed = StreamingSession.restore(path)
    assert resumed.checkpoint_extra == {"pos": split, "text_carry": b"1A"}
    resumed.feed(raw[split:])
    resumed.finalize()
    for name in ("n_frames", "n_kept", "n_groups"):
        assert getattr(resumed, name) == getattr(full, name), name
    np.testing.assert_array_equal(resumed.filtered, full.filtered)
    np.testing.assert_array_equal(resumed._sums, full._sums)
    if kind == "paths":
        assert_paths_equal(readers(resumed), readers(full))
        assert_columns_equal_tracks(resumed)

    resumed.save_checkpoint(path)
    done = StreamingSession.restore(path)
    with pytest.raises(RuntimeError, match="already finalized"):
        done.feed(raw[:100])


def test_checkpoint_of_the_other_engine_is_refused(raw, spec, tmp_path):
    host = StreamingSession(collect_paths=spec)
    host.feed(raw[:5_000])
    host.save_checkpoint(tmp_path / "host.ckpt")
    dev = DeviceStreamingSession(chunk_bytes=1 << 12, collect_paths=spec, device="cpu")
    dev.feed(raw[:5_000])
    dev.save_checkpoint(tmp_path / "device.ckpt")
    with pytest.raises(ValueError, match="not a StreamingSession checkpoint: kind='device_stream'"):
        StreamingSession.restore(tmp_path / "device.ckpt")
    with pytest.raises(ValueError, match="not a DeviceStreamingSession checkpoint: "
                                         "kind='host_stream'"):
        DeviceStreamingSession.restore(tmp_path / "host.ckpt", device="cpu")


def bins(t):
    return np.clip((np.nan_to_num(t) * 256).astype(int), 0, 255)


def test_render_matches_jax_host_stream(raw, angles, device_stream):
    """PERF.md section 2's render contract, on the stream's own grid."""
    lut = load_angle_lut(angles)
    got = device_stream.render(lut)
    ref = jax_streaming.replay_log(raw, chunk_bytes=1 << 12).render(lut)
    want_b = np.asarray(ref.blurred)
    want_t = jax_raster.shifted_log_norm(want_b, None, None)
    assert got.blurred.shape == want_b.shape == (64, 64)
    assert (np.isnan(got.blurred) == np.isnan(want_b)).all()
    np.testing.assert_allclose(got.blurred, want_b, rtol=1e-5, equal_nan=True)
    assert (np.isnan(got.norm_t) == np.isnan(want_t)).all()
    fin = ~np.isnan(want_t)
    np.testing.assert_allclose(got.norm_t[fin], want_t[fin], atol=1e-3)
    assert (bins(got.norm_t) != bins(want_t)).mean() < 0.01
    np.testing.assert_array_equal(got.aod_angles, ref.aod_angles)
    np.testing.assert_array_equal(got.aoa_angles, ref.aoa_angles)
    assert got.rgba.dtype == np.uint8 and got.rgba.shape == (64, 64, 4)

    host = replay_log(raw, chunk_bytes=1 << 12).render(lut)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(host, name), getattr(got, name), name)


def test_render_launches_the_raster(raw, angles, device_stream, monkeypatch):
    """``render()`` rasterizes on the session's device through
    ``rasterize_tiles`` (K3 on CUDA, its plain version here)."""
    from slam_process_tpu_torch.render import heatmap

    calls = []
    real = heatmap.rasterize_tiles
    monkeypatch.setattr(heatmap, "rasterize_tiles",
                        lambda mats, *a: calls.append(mats.device) or real(mats, *a))
    device_stream.render(load_angle_lut(angles))
    assert calls == [torch.device("cpu")]
