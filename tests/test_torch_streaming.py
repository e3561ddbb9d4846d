"""Port device streaming session == the offline port and the JAX stream.

``slam_process_tpu_torch.parallel.streaming_device`` on the CPU (every
kernel's plain version) with a synthetic session of planted multipath
(``n_paths=3``, 5 sweeps, 0.5 deg grids):

  * against the port's offline path, exactly, at 4 KiB, 64 KiB and
    one-window chunks: ``filtered`` == the host engine's, ``intensity()``
    == the host pivot, and ``sweep_paths`` / ``sweep_times`` /
    ``path_tracks`` / ``track_columns`` == ``Session.sweep_paths`` and
    ``Session.path_tracks`` with ``beam_ids=(spec.ue_ids, spec.bs_ids)``;
  * against the JAX package's ``DeviceStreamingSession`` on the same bytes,
    chunk size and spec (``convert.paths_spec_from_reference``): counts,
    ``filtered``, intensity counts and means (cell sums < 2^24) equal;
    NN-OMP indices, ``n_iters`` and ``valid`` equal and power within rtol
    2e-4 (every selection of this session is compared; none is a near
    tie); tracks equal where the selections are, so all of them here;
  * the JAX suite's edge cases (``tests/test_streaming_device.py``,
    ``tests/test_streaming_paths.py``) and checkpoint resume.
"""

import numpy as np
import pytest
import torch

from slam_process_tpu_torch.config import PipelineConfig, SceneConfig
from slam_process_tpu_torch.ops.correct import correct_frames_np, detect_groups_np
from slam_process_tpu_torch.ops.decode import decode_frames_np
from slam_process_tpu_torch.ops.scene import intensity_grid_np
from slam_process_tpu_torch.parallel.streaming_device import (
    DeviceStreamingSession, make_paths_spec, replay_log_device)
from slam_process_tpu_torch.pipeline.session import Session
from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, write_angle_table

SESSION = dict(n_groups=5, frames_per_beam=8, baselines_per_group=9, junk_frac=0.05, seed=3,
               n_paths=3)
EST = dict(grid_res=0.5)


@pytest.fixture(scope="module")
def raw():
    return synthetic_session_bytes(**SESSION)


@pytest.fixture(scope="module")
def angles(tmp_path_factory):
    return write_angle_table(tmp_path_factory.mktemp("stream") / "beam_angle.xlsx")


@pytest.fixture(scope="module")
def spec(angles):
    return make_paths_spec(angles, s_step=8, **EST)


@pytest.fixture(scope="module")
def offline(raw, angles, spec):
    frames = decode_frames_np(raw).frames
    res = correct_frames_np(frames)
    s = Session("offline")
    s.frames = frames
    beam_ids = (spec[0].ue_ids, spec[0].bs_ids)
    paths, valid = s.sweep_paths(angles, device="cpu", beam_ids=beam_ids, **EST)
    tracks = s.path_tracks(angles, device="cpu", beam_ids=beam_ids, **EST)
    return frames, res, paths, valid, s.sweep_times(len(valid)), tracks


def replay(raw, chunk, **kw):
    s = DeviceStreamingSession(chunk_bytes=chunk, device="cpu", **kw)
    for off in range(0, len(raw), chunk):
        s.feed(raw[off:off + chunk])
    s.finalize()
    return s


def assert_same_paths(a, b, exact=True):
    """Readers of two paths sources: (sweep_paths, sweep_times, path_tracks)."""
    (pa, va), ta, (tra, tta, vela) = a
    (pb, vb), tb, (trb, ttb, velb) = b
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(tta, ttb)
    for name in pb._fields:
        got, want = getattr(pa, name), np.asarray(getattr(pb, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if name == "power" and not exact:
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("pos_aoa", "pos_aod", "power", "observed", "created"):
        got, want = getattr(tra, name), np.asarray(getattr(trb, name))
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


def readers(s):
    return s.sweep_paths(), s.sweep_times(), s.path_tracks()


@pytest.mark.parametrize("chunk", [1 << 12, 1 << 16, 1 << 20])
def test_stream_equals_offline(raw, spec, offline, chunk):
    frames, res, paths, valid, times, tracks = offline
    s = replay_log_device(raw, chunk_bytes=chunk, device="cpu", collect_filtered=True,
                          collect_paths=spec)
    assert not s.overflow
    assert s.n_frames == len(frames) and s.n_kept == len(res.filtered)
    assert s.n_groups == int(detect_groups_np(frames[:, 1])[-1]) + 1
    np.testing.assert_array_equal(s.filtered, res.filtered)
    grid = intensity_grid_np(res.filtered[:, 0], res.filtered[:, 1], res.filtered[:, 2])
    ours = s.intensity()
    np.testing.assert_array_equal(ours.counts, grid.counts)
    np.testing.assert_array_equal(ours.mean, grid.mean)
    assert s.n_sweeps_closed == len(valid) == 5
    assert_same_paths(readers(s), ((paths, valid), times, tracks))
    assert int(tracks[0].n_tracks) > 0 and paths.valid.sum() > 5

    n = s.n_sweeps_closed
    parts = [s.track_columns(lo, min(lo + 2, n)) for lo in range(0, n, 2)]
    for i, name in enumerate(("pos_aoa", "pos_aod", "power", "observed")):
        np.testing.assert_array_equal(np.concatenate([p[i] for p in parts]).T,
                                      getattr(tracks[0], name))
    raw_times = np.concatenate([p[4] for p in parts])
    np.testing.assert_array_equal(raw_times, times)


@pytest.mark.parametrize("kind", ["filtered_and_paths", "filtered", "paths"])
def test_window_compacts_kept_rows_once(raw, spec, offline, monkeypatch, kind):
    """A window makes two compactions: the open-group carry and one
    ``compact_rows_streams`` of the kept rows for every consumer (the emit
    ring and the online paths); the flush makes the second only.  The
    stream still equals the offline port."""
    from slam_process_tpu_torch.parallel import streaming_device as sd

    calls, windows = [], []
    real = sd.compact_rows_streams
    monkeypatch.setattr(sd, "compact_rows_streams",
                        lambda *a: calls.append(len(a[2])) or real(*a))
    step = sd.DeviceStreamingSession._step
    monkeypatch.setattr(sd.DeviceStreamingSession, "_step",
                        lambda self, *a: windows.append(1) or step(self, *a))
    kw = {"filtered_and_paths": dict(collect_filtered=True, collect_paths=spec),
          "filtered": dict(collect_filtered=True), "paths": dict(collect_paths=spec)}[kind]
    s = replay(raw, 1 << 12, **kw)
    n_dest = 2 if kind == "filtered_and_paths" else 1
    assert len(windows) > 5
    assert calls == [1, n_dest] * len(windows) + [n_dest]
    _, res, paths, valid, times, tracks = offline
    if "collect_filtered" in kw:
        np.testing.assert_array_equal(s.filtered, res.filtered)
    if "collect_paths" in kw:
        assert_same_paths(readers(s), ((paths, valid), times, tracks))


@pytest.fixture(scope="module")
def jax_pair(raw, angles):
    """The same bytes through both packages' streams at 8 KiB windows,
    driven by one JAX spec."""
    from slam_process_tpu.parallel import streaming_device as jsd
    from slam_process_tpu_torch.convert import paths_spec_from_reference

    jspec = jsd.make_paths_spec(angles, s_step=8, **EST)
    chunk, kw = 1 << 13, dict(collect_filtered=True, group_capacity=4096)
    js = jsd.DeviceStreamingSession(chunk_bytes=chunk, collect_paths=jspec, **kw)
    for off in range(0, len(raw), chunk):
        js.feed(raw[off:off + chunk])
    js.finalize()
    port_spec = paths_spec_from_reference(*jspec, device="cpu")
    return replay(raw, chunk, collect_paths=port_spec, **kw), js, jspec, port_spec


def test_paths_spec_from_reference(spec, jax_pair):
    _, _, jspec, (port_spec, dict_args) = jax_pair
    assert port_spec == spec[0]
    assert type(port_spec.est_key[1]).__module__.startswith("slam_process_tpu_torch")
    for got, want, ours in zip(dict_args, jspec[1], spec[1]):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), ours)


def test_stream_equals_jax_stream(jax_pair):
    ps, js, _, _ = jax_pair
    for name in ("n_frames", "n_kept", "n_groups", "n_sweeps_closed", "overflow"):
        assert getattr(ps, name) == getattr(js, name), name
    np.testing.assert_array_equal(ps.filtered, js.filtered)
    a, b = ps.intensity(), js.intensity()
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.mean, b.mean)
    assert_same_paths(readers(ps), readers(js), exact=False)


def frame(ue, rss, clk, flag=0, bs=0x3F):
    b = [0xCC if flag else 0x33, ue & 0x3F, 0xC0 | (bs & 0x3F)]
    b += [0x40 | ((clk >> (6 * k)) & 0x3F) for k in range(5)]
    b += [0x80 | ((rss >> (6 * k)) & 0x3F) for k in range(3)]
    return b


def test_big_open_group_straddles_window_boundary():
    """A group of 4,500 frames (above the JAX package's old 4,096 default)
    crosses several 16 KiB window edges under the default bounds."""
    out = []
    for i in range(40):
        out += frame(i % 64, 50 + i, 1_000 + 700 * i)
    big = 4_500
    for i in range(big):
        out += frame(i * 64 // big, 100 + i % 200, 40_000 + 700 * i)
    for i in range(40):
        out += frame(i % 64, 60 + i, 4_000_000 + 700 * i)
    raw = np.asarray(out, dtype=np.uint8)
    frames = decode_frames_np(raw).frames
    s = replay(raw, 1 << 14, collect_filtered=True)
    assert not s.overflow
    assert s.n_frames == len(frames) == 4_580 and s.n_groups == 3
    np.testing.assert_array_equal(s.filtered, correct_frames_np(frames).filtered)


def test_emit_ring_grows_from_a_small_ring(raw):
    stream = np.concatenate([raw] * 3)
    s = DeviceStreamingSession(chunk_bytes=1 << 12, collect_filtered=True, device="cpu")
    s._ecap = 1 << 10                     # a small initial ring, so that it must grow
    s._state.emit_buf = torch.zeros((s._ecap, 4), dtype=torch.int32)
    for off in range(0, len(stream), 5_000):
        s.feed(stream[off:off + 5_000])
    s.finalize()
    want = correct_frames_np(decode_frames_np(stream).frames).filtered
    assert len(want) > 1 << 10 and s._ecap == 1 << 18
    np.testing.assert_array_equal(s.filtered, want)


def test_fixed_emit_capacity_too_small_raises(raw, offline):
    res = offline[1]
    s = replay_log_device(raw, chunk_bytes=1 << 14, device="cpu", collect_filtered=True,
                          emit_capacity=64)
    with pytest.raises(RuntimeError, match="emit ring overflowed"):
        s.filtered
    assert s.n_kept == len(res.filtered) > 64
    grid = intensity_grid_np(res.filtered[:, 0], res.filtered[:, 1], res.filtered[:, 2])
    np.testing.assert_array_equal(s.intensity().mean, grid.mean)


def test_group_capacity_overflow_warns_once():
    out = []
    for i in range(64):
        out += frame(i % 64, 100 + i, 10_000 + 61_000 * i)
    s = DeviceStreamingSession(chunk_bytes=256, group_capacity=16, device="cpu")
    s.feed(np.asarray(out, dtype=np.uint8))
    s.finalize()
    assert s.overflow
    with pytest.warns(RuntimeWarning, match="capacity exceeded"):
        _ = s.n_frames
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert s.n_kept >= 0


@pytest.mark.parametrize("kw,chunk", [(dict(capacity=2), 1 << 14), (dict(s_step=1), 1 << 20)])
def test_paths_overflow_raises(raw, angles, kw, chunk):
    s = replay(raw, chunk, collect_paths=make_paths_spec(angles, **EST, **kw))
    assert s.n_frames > 0 and not s.overflow
    for reader in (s.sweep_paths, s.path_tracks, s.sweep_times, lambda: s.track_columns(0, 1)):
        with pytest.raises(RuntimeError, match="online estimation overflow"):
            reader()


def test_junk_only_stream_yields_no_sweeps(spec):
    s = DeviceStreamingSession(chunk_bytes=1 << 16, collect_paths=spec, device="cpu")
    s.feed(np.zeros(4096, np.uint8))
    s.finalize()
    paths, valid = s.sweep_paths()
    assert s.n_sweeps_closed == 0 and len(valid) == 0 and paths.aoa.shape == (0, 3)
    tracks, times, _ = s.path_tracks()
    assert int(tracks.n_tracks) == 0 and len(times) == 0
    assert s.n_frames == 0 and s.n_groups == 0


def test_argument_and_state_errors(spec):
    s = DeviceStreamingSession(chunk_bytes=1 << 16, device="cpu")
    for reader in (s.sweep_paths, s.path_tracks, s.sweep_times, lambda: s.n_sweeps_closed,
                   lambda: s.track_columns(0, 1)):
        with pytest.raises(ValueError, match="collect_paths"):
            reader()
    with pytest.raises(ValueError, match="collect_filtered"):
        s.filtered
    with pytest.raises(ValueError, match="10-byte carry"):
        DeviceStreamingSession(chunk_bytes=10, device="cpu")
    # The pre-log scene is ported: its running sums are float64.
    prelog = DeviceStreamingSession(PipelineConfig(scene=SceneConfig(log_transform=True)),
                                    device="cpu")
    assert prelog._state.sums.dtype == torch.float64
    s.feed(b"\x00" * 100)
    s.finalize()
    s.finalize()                          # idempotent
    with pytest.raises(RuntimeError, match="already finalized"):
        s.feed(b"\x00" * 100)


def test_flag_filter_is_honoured(raw):
    cfg = PipelineConfig(scene=SceneConfig(flag_filter=1))
    s = replay_log_device(raw, chunk_bytes=1 << 14, config=cfg, device="cpu")
    # Every kept row is a FLAG 0 frame, so a FLAG 1 filter keeps none.
    assert s.n_kept > 0 and int(s.intensity().counts.sum()) == 0


@pytest.mark.parametrize("kind", ["paths", "filtered"])
def test_checkpoint_resume_equals_uninterrupted(raw, spec, tmp_path, kind):
    kw = (dict(collect_paths=spec, collect_filtered=True) if kind == "paths"
          else dict(collect_filtered=True))
    chunk = 1 << 12
    full = replay(raw, chunk, **kw)
    part = DeviceStreamingSession(chunk_bytes=chunk, device="cpu", **kw)
    split = len(raw) // 2 + 7                # mid-window, so the byte carry is non-empty
    part.feed(raw[:split])
    path = tmp_path / f"{kind}.ckpt"
    part.save_checkpoint(path, extra={"offset": split})
    resumed = DeviceStreamingSession.restore(path, device="cpu")
    assert resumed.checkpoint_extra == {"offset": split}
    resumed.feed(raw[split:])
    resumed.finalize()
    for name in ("n_frames", "n_kept", "n_groups", "overflow"):
        assert getattr(resumed, name) == getattr(full, name), name
    np.testing.assert_array_equal(resumed.filtered, full.filtered)
    np.testing.assert_array_equal(resumed.intensity().mean, full.intensity().mean)
    if kind == "paths":
        assert_same_paths(readers(resumed), readers(full))


def test_checkpoint_rejects_mismatches(raw, spec, tmp_path):
    s = DeviceStreamingSession(chunk_bytes=1 << 12, collect_paths=spec, device="cpu")
    s.feed(raw[:10_000])
    s.finalize()
    path = tmp_path / "s.ckpt"
    s.save_checkpoint(path, extra={"k": [1, 2]})
    r = DeviceStreamingSession.restore(path, device="cpu")
    assert r.checkpoint_extra == {"k": [1, 2]}
    with pytest.raises(RuntimeError, match="already finalized"):
        r.feed(raw[10_000:])
    assert not (tmp_path / "s.ckpt.tmp").exists()

    with np.load(path) as z:
        arrays = dict(z)
    for leaf, bad in (("leaf_0000", np.zeros((3, 5), np.int32)),
                      ("leaf_0002", arrays["leaf_0002"].astype(np.float32))):
        broken = dict(arrays, **{leaf: bad})
        with open(tmp_path / "bad.ckpt", "wb") as f:
            np.savez(f, **broken)
        with pytest.raises(ValueError, match="checkpoint leaf"):
            DeviceStreamingSession.restore(tmp_path / "bad.ckpt", device="cpu")

    import pickle

    meta = pickle.loads(arrays["meta"].tobytes())
    for key, value, match in (("kind", "host_stream", "not a DeviceStreamingSession"),
                              ("version", 99, "unsupported checkpoint version")):
        blob = np.frombuffer(pickle.dumps(dict(meta, **{key: value})), dtype=np.uint8)
        with open(tmp_path / "bad.ckpt", "wb") as f:
            np.savez(f, **dict(arrays, meta=blob))
        with pytest.raises(ValueError, match=match):
            DeviceStreamingSession.restore(tmp_path / "bad.ckpt", device="cpu")
