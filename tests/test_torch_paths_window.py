"""The single stream's read-free paths step against the block form.

``DeviceStreamingSession`` runs its paths step in the read-free form
(``parallel/streaming_device._paths_after_read`` on every lane,
``_every_lane``): the estimator on all s_step + 1 sweep lanes, each lane's
results written to ring row ``n_closed + j`` on the device, the open lane
taken by a device index, so a window reads nothing back and can be a CUDA
graph.  ``MultiStreamingSession`` takes the block form (one host read of
the closed-sweep counts, then the estimator on the JAX package's 8-lane
blocks up to the largest count; ``counted`` below is a single stream with
``_every_lane`` off).  On the CPU (every kernel's plain version) the two
forms, fed the same windows, must leave the same state: every leaf equal,
the rings on their rows below ``n_closed`` (the rows past it are slack,
which no reader reads), after every feed and after the flush.  The cases
cover windows that close 0 sweeps, 1, ``s_step`` and ``s_step + 1`` (an
overflow) and a capacity overflow.
"""

import dataclasses

import numpy as np
import pytest

from slam_process_tpu_torch.parallel import streaming_device as sd
from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, write_angle_table

# 12 sweeps of 128 frames (~1.4 KB each) with planted multipath.
SESSION = dict(n_groups=12, frames_per_beam=2, baselines_per_group=5, junk_frac=0.05, seed=3,
               n_paths=3)
EST = dict(grid_res=2.0)
RINGS = ("est_rings", "valid_ring", "time_ring", "trk_aoa", "trk_aod", "trk_pow", "trk_obs")


@pytest.fixture(scope="module")
def raw():
    return synthetic_session_bytes(**SESSION)


@pytest.fixture(scope="module")
def angles(tmp_path_factory):
    return write_angle_table(tmp_path_factory.mktemp("paths_window") / "beam_angle.xlsx")


def host(x):
    return np.asarray(x.cpu().numpy())


def assert_same_state(a, b):
    """Every state leaf equal; the rings on their rows below n_closed."""
    for f in dataclasses.fields(a._state):
        if f.name != "paths":
            for x, y in zip(sd._leaves(getattr(a._state, f.name)),
                            sd._leaves(getattr(b._state, f.name))):
                np.testing.assert_array_equal(host(x), host(y), err_msg=f.name)
    pa, pb = a._state.paths, b._state.paths
    n = int(pa.n_closed)
    assert int(pb.n_closed) == n
    for f in dataclasses.fields(pa):
        for x, y in zip(sd._leaves(getattr(pa, f.name)), sd._leaves(getattr(pb, f.name))):
            if f.name in RINGS:
                x, y = x[:n], y[:n]
            np.testing.assert_array_equal(host(x), host(y), err_msg=f.name)


@pytest.mark.parametrize("chunk,capacity,closes,overflow", [
    (1024, 64, {0, 1}, False),
    (4096, 64, {3}, False),
    (8192, 64, {4}, True),
    (4096, 5, set(), True),
], ids=["windows_close_0_and_1", "windows_close_s_step", "window_closes_s_step_plus_1",
        "capacity_overflow"])
def test_read_free_paths_step_equals_counted_form(raw, angles, chunk, capacity, closes,
                                                 overflow):
    s_step = 3
    spec = sd.make_paths_spec(angles, s_step=s_step, capacity=capacity, **EST)
    free = sd.DeviceStreamingSession(chunk_bytes=chunk, collect_paths=spec, device="cpu")
    counted = sd.DeviceStreamingSession(chunk_bytes=chunk, collect_paths=spec, device="cpu")
    counted._every_lane = False
    seen = set()
    for off in range(0, len(raw), chunk):
        before = int(counted._state.paths.n_closed)
        free.feed(raw[off:off + chunk])
        counted.feed(raw[off:off + chunk])
        seen.add(int(counted._state.paths.n_closed) - before)
        assert_same_state(free, counted)
    free.finalize()
    counted.finalize()
    assert_same_state(free, counted)
    assert closes <= seen
    assert bool(free._state.paths.overflow) is overflow
    if not overflow:
        paths, valid = free.sweep_paths()
        assert len(valid) == SESSION["n_groups"] and paths.valid.any()


def test_single_stream_with_paths_reads_no_count(raw, angles, monkeypatch):
    """The single stream's windows and flush read no closed-sweep count;
    the multi-stream round still reads its counts once a round and flush."""
    spec = sd.make_paths_spec(angles, s_step=8, **EST)
    sd.HOST_SYNCS = 0
    s = sd.DeviceStreamingSession(chunk_bytes=2048, collect_paths=spec, device="cpu")
    for off in range(0, len(raw), 2048):
        s.feed(raw[off:off + 2048])
    s.finalize()
    assert sd.HOST_SYNCS == 0 and s.n_sweeps_closed == SESSION["n_groups"]
    rounds = []
    step = sd.MultiStreamingSession._window
    monkeypatch.setattr(sd.MultiStreamingSession, "_window",
                        lambda self, *a: rounds.append(1) or step(self, *a))
    m = sd.MultiStreamingSession(1, chunk_bytes=2048, collect_paths=spec, device="cpu")
    m.feed([raw])
    m.finalize()
    assert sd.HOST_SYNCS == len(rounds) + 1
    for a, b in zip(m.stream_paths(0), s.sweep_paths()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
