"""The port's scene change detection (slam_process_tpu_torch.models.
change_detection) == the JAX package's, event for event.

Seeded ``Tracks`` (coasting-hold positions, as the tracker makes them)
with births, deaths, jumps past ``jump_deg`` and LoS handovers go through
``detect_scene_changes_np`` and ``scene_change_events`` of both packages:
every mask and the event table equal exactly, at several (min_persist,
min_gone, jump_deg).  Zero sweeps give no events.  ``Session.scene_changes``
on a synthetic multipath session (the CPU) equals the JAX package's.  The
live feed's pieces: ``IncrementalChangeDetector`` fed one column at a time
equals the JAX package's row for row and the batch table, and
``ClkUnwrapper`` pushed one anchor at a time equals ``unwrap_clk_anchors``
and the JAX package's, with the same count of non-wrap decreases.  The
detector on torch tensors (``detect_scene_changes``, CPU tensors here; the
card in ``tests/test_torch_cuda.py``) is bit-identical to both packages'
numpy oracles and to ``detect_scene_changes_jax``: seeds 0-2 at four
parameter sets, a track opened but never observed, zero sweeps.
"""

import numpy as np
import pytest
import torch

from slam_process_tpu.models import change_detection as jax_cd
from slam_process_tpu.utils import timestamps as jax_ts
from slam_process_tpu.pipeline.session import Session as JaxSession
from slam_process_tpu_torch.models import change_detection
from slam_process_tpu_torch.models.tracking import Tracks
from slam_process_tpu_torch.pipeline.session import Session
from slam_process_tpu_torch.utils.timestamps import ClkUnwrapper, unwrap_clk_anchors
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


def tensor_tracks(tracks):
    return Tracks(*(torch.from_numpy(np.ascontiguousarray(x)) for x in tracks[:5]),
                  tracks.n_tracks)


def never_observed(tracks):
    """``tracks`` with slot 1 opened but its observations cleared."""
    obs, power, created = (np.array(x) for x in (tracks.observed, tracks.power, tracks.created))
    obs[1] = False
    power[1] = 0.0
    created[1] = True
    return tracks._replace(observed=obs, power=power, created=created)


@pytest.mark.parametrize("params", [(3, 3, 5.0), (2, 2, 4.0), (1, 5, 2.5), (4, 1, 8.0)],
                         ids=lambda p: "persist{}_gone{}_jump{}".format(*p))
@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "seed0_never_observed"])
def test_torch_detector_bit_identical_to_np_and_jax(case, params):
    """``detect_scene_changes`` on CPU tensors equals the port's and JAX's
    numpy oracle and ``detect_scene_changes_jax`` mask for mask, bit for
    bit, with tensors of the numpy dtypes on the tracks' device."""
    tracks = seeded_tracks(int(case[4]))
    if case.endswith("never_observed"):
        tracks = never_observed(tracks)
    mp, mg, jd = params
    kw = dict(min_persist=mp, min_gone=mg, jump_deg=jd)
    got = change_detection.detect_scene_changes(tensor_tracks(tracks), **kw)
    want = change_detection.detect_scene_changes_np(tracks, **kw)
    want_jax = jax_cd.detect_scene_changes_jax(tracks, **kw)
    want_jax_np = jax_cd.detect_scene_changes_np(tracks, **kw)
    assert got._fields == want._fields
    for g, w, j, jn, name in zip(got, want, want_jax, want_jax_np, want._fields):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu", name
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=name)
        np.testing.assert_array_equal(w, jn, err_msg=name)
    if case.endswith("never_observed"):
        assert not (got.birth[1].any() or got.death[1].any() or got.jump[1].any())
    assert int(got.birth.sum()) > 0 and int(got.los_change.sum()) > 0


def test_torch_detector_zero_sweeps_and_numpy_input():
    z = np.zeros((4, 0), np.float32)
    tracks = Tracks(z, z, z, z.astype(bool), np.ones(4, bool), 0)
    got = change_detection.detect_scene_changes(tensor_tracks(tracks))
    want = jax_cd.detect_scene_changes_jax(tracks)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.shape == w.shape
        assert g.numpy().dtype == np.asarray(w).dtype
    with pytest.raises(TypeError, match="detect_scene_changes_np"):
        change_detection.detect_scene_changes(tracks)


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


@pytest.mark.parametrize("params", [(3, 3, 5.0), (2, 2, 4.0), (1, 5, 2.5), (4, 1, 8.0)],
                         ids=lambda p: "persist{}_gone{}_jump{}".format(*p))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_incremental_detector_matches_jax_and_batch(seed, params):
    tracks = seeded_tracks(seed)
    mp, mg, jd = params
    times = np.cumsum(np.random.default_rng(seed).integers(50_000, 70_000,
                                                           tracks.observed.shape[1]))
    kw = dict(min_persist=mp, min_gone=mg, jump_deg=jd)
    ours = change_detection.IncrementalChangeDetector(tracks.observed.shape[0], **kw)
    ref = jax_cd.IncrementalChangeDetector(tracks.observed.shape[0], **kw)
    rows = []
    for s in range(tracks.observed.shape[1]):
        col = (tracks.pos_aoa[:, s], tracks.pos_aod[:, s], tracks.power[:, s],
               tracks.observed[:, s] & tracks.created, times[s])
        got, want = ours.step(*col), ref.step(*col)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        rows.append(got)
    assert ours.n_sweeps == tracks.observed.shape[1]
    batch = change_detection.scene_change_events(
        change_detection.detect_scene_changes_np(tracks, **kw), tracks, times)
    np.testing.assert_array_equal(np.concatenate(rows), batch)
    assert len(batch) > 0


def test_incremental_detector_keeps_the_jump_literal():
    """The jump threshold is float32(jump_deg) ** 2, as the batch detector
    squares it: a displacement at that value is not a jump."""
    det = change_detection.IncrementalChangeDetector(1, min_persist=1, min_gone=9,
                                                     jump_deg=0.3)
    on = np.ones(1, bool)
    det.step([0.0], [0.0], [1.0], on, 0)
    j2 = np.float32(0.3) ** 2
    step = np.sqrt(j2, dtype=np.float32)
    ev = det.step([step], [0.0], [1.0], on, 1)
    assert np.float32(step) * np.float32(step) <= j2 and len(ev) == 0
    ev = det.step([2 * step + np.float32(0.01)], [0.0], [1.0], on, 2)
    assert ev[:, 2].tolist() == [2.0]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_clk_unwrapper_matches_batch_and_jax(seed):
    """Anchors with wraps (drops past 2^29), small decreases (resets) and
    empty sweeps (-1)."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(40_000, 80_000, 60)
    steps[rng.random(60) < 0.1] = -int(rng.integers(1, 1 << 16))        # a reset
    raw = (np.cumsum(steps) + (1 << 30) - int(rng.integers(1, 500_000))) % (1 << 30)
    raw[rng.random(60) < 0.15] = -1
    ours, ref = ClkUnwrapper(), jax_ts.ClkUnwrapper()
    got = [ours.push(t) for t in raw]
    assert got == [ref.push(t) for t in raw]
    np.testing.assert_array_equal(got, unwrap_clk_anchors(raw))
    np.testing.assert_array_equal(got, jax_ts.unwrap_clk_anchors(raw))
    assert ours.odd == ref.odd > 0
    assert max(got) >= 1 << 30                    # the counter wrapped
