"""The port's scene change detection (slam_process_tpu_torch.models.
change_detection) == the JAX package's, event for event.

Seeded ``Tracks`` (coasting-hold positions, as the tracker makes them)
with births, deaths, jumps past ``jump_deg`` and LoS handovers go through
``detect_scene_changes_np`` and ``scene_change_events`` of both packages:
every mask and the event table equal exactly, at several (min_persist,
min_gone, jump_deg).  Zero sweeps give no events.  ``Session.scene_changes``
on a synthetic multipath session (the CPU) equals the JAX package's.
"""

import numpy as np
import pytest

from slam_process_tpu.models import change_detection as jax_cd
from slam_process_tpu.pipeline.session import Session as JaxSession
from slam_process_tpu_torch.models import change_detection
from slam_process_tpu_torch.models.tracking import Tracks
from slam_process_tpu_torch.pipeline.session import Session
from slam_process_tpu_torch.utils.synthetic import (
    synthetic_session_bytes, to_hex_text, write_angle_table)


def seeded_tracks(seed, t_n=6, s_n=40):
    """Tracks whose observations come in runs (births, then deaths after
    gaps), whose positions drift with occasional jumps, and whose powers
    cross (LoS handovers); unobserved sweeps hold the last position."""
    rng = np.random.default_rng(seed)
    obs = np.zeros((t_n, s_n), bool)
    for t in range(t_n):
        s = int(rng.integers(0, 8))
        while s < s_n:
            run = int(rng.integers(1, 9))
            obs[t, s:s + run] = True
            s += run + int(rng.integers(1, 7))
    step = rng.normal(0, 0.5, (t_n, s_n, 2))
    jumps = rng.random((t_n, s_n)) < 0.08
    step[jumps] += rng.choice([-1, 1], (int(jumps.sum()), 2)) * rng.uniform(4, 9, (
        int(jumps.sum()), 2))
    pos = rng.uniform(-30, 30, (t_n, 1, 2)) + np.cumsum(step, axis=1)
    power = rng.uniform(0.5, 1.5, (t_n, s_n)) * (1 + np.sin(
        np.arange(s_n)[None, :] / 4 + rng.uniform(0, 6, (t_n, 1))))
    pos_a = np.zeros((t_n, s_n), np.float32)
    pos_d = np.zeros((t_n, s_n), np.float32)
    for t in range(t_n):
        last = (0.0, 0.0)
        for s in range(s_n):
            if obs[t, s]:
                last = pos[t, s]
            pos_a[t, s], pos_d[t, s] = last
    created = obs.any(axis=1)
    created[-1] = False   # a slot never opened
    obs[-1] = False
    return Tracks(pos_a, pos_d, (power * obs).astype(np.float32), obs, created,
                  int(created.sum()))


@pytest.mark.parametrize("params", [(3, 3, 5.0), (2, 2, 4.0), (1, 5, 2.5), (4, 1, 8.0)],
                         ids=lambda p: "persist{}_gone{}_jump{}".format(*p))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_changes_and_events_match_jax(seed, params):
    tracks = seeded_tracks(seed)
    mp, mg, jd = params
    want = jax_cd.detect_scene_changes_np(tracks, min_persist=mp, min_gone=mg, jump_deg=jd)
    got = change_detection.detect_scene_changes_np(tracks, min_persist=mp, min_gone=mg,
                                                   jump_deg=jd)
    assert got._fields == want._fields
    for g, w, name in zip(got, want, want._fields):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    times = np.cumsum(np.random.default_rng(seed).integers(50_000, 70_000, tracks.observed.shape[1]))
    ev = change_detection.scene_change_events(got, tracks, times)
    np.testing.assert_array_equal(ev, jax_cd.scene_change_events(want, tracks, times))
    kinds = set(ev[:, 2].astype(int).tolist())
    assert {0, 1, 3} <= kinds and (2 in kinds or jd > 5)   # births, deaths, handovers


def test_zero_sweeps_give_no_events():
    z = np.zeros((4, 0), np.float32)
    tracks = Tracks(z, z, z, z.astype(bool), np.zeros(4, bool), 0)
    got = change_detection.detect_scene_changes_np(tracks)
    want = jax_cd.detect_scene_changes_np(tracks)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    assert change_detection.scene_change_events(got, tracks, np.zeros(0)).shape == (0, 7)
    assert change_detection.EVENT_KINDS == jax_cd.EVENT_KINDS


def test_session_scene_changes_match_jax(tmp_path):
    path = tmp_path / "mp.txt"
    path.write_bytes(to_hex_text(synthetic_session_bytes(
        n_groups=12, frames_per_beam=1, baselines_per_group=4, seed=8, n_paths=3)))
    angles = write_angle_table(tmp_path / "angles.xlsx")
    s = Session.from_log(path, device="cpu")
    js = JaxSession.from_log(path)
    js.correct()
    np.testing.assert_array_equal(s.filtered, js.filtered)
    kw = dict(min_persist=2, min_gone=2, jump_deg=3.0, grid_res=1.0)
    ev, tracks, times = s.scene_changes(angles, device="cpu", **kw)
    j_ev, j_tracks, j_times = js.scene_changes(angles, **kw)
    np.testing.assert_array_equal(times, j_times)
    for field in ("observed", "created", "pos_aoa", "pos_aod"):
        np.testing.assert_array_equal(getattr(tracks, field), getattr(j_tracks, field))
    assert tracks.n_tracks == j_tracks.n_tracks > 0
    assert ev.shape == j_ev.shape and ev.shape[0] > 0
    # Power is the estimator's float32 coefficient: the events' power
    # column within rtol 2e-4, every other column exactly.
    np.testing.assert_array_equal(ev[:, :6], j_ev[:, :6])
    np.testing.assert_allclose(ev[:, 6], j_ev[:, 6], rtol=2e-4)
