"""Port tracker block (kernel K6's plain version) and tracking == JAX's.

``ops/tracker.track_block_plain`` against ``track_block_pallas(...,
interpret=True)`` and the numpy oracle ``track_sweep_step_np`` lane by
lane, exactly: random blocks, any split of the sweep axis into blocks,
``m_eff = 0`` (a carry no-op), ``m_eff`` past s1, planted exact ties (the
lowest flat index ``t * K + k`` wins), costs exactly at and just past
``gate2``, and the largest block (T = 16, K = 20) with ties on a grid.  Then
``models/tracking.track_paths`` against ``track_paths_jax`` and
``track_paths_np``, and the copied numpy code against the JAX package's.
``tests/test_pallas_tracker.py`` is the model.
"""

import numpy as np
import pytest
import torch

from slam_process_tpu_torch.models import tracking
from slam_process_tpu_torch.ops.tracker import track_block, track_block_plain


def random_case(rng, s_n, k_n):
    aoa = rng.uniform(-45, 45, (s_n, k_n)).astype(np.float32)
    aod = rng.uniform(-45, 45, (s_n, k_n)).astype(np.float32)
    pw = rng.uniform(0, 1, (s_n, k_n)).astype(np.float32)
    return aoa, aod, pw, rng.random((s_n, k_n)) < 0.6


def run_blocks(fn, aoa, aod, pw, val, t_n, gate, s1, splits):
    """Feed the sweeps through ``fn`` in consecutive blocks of s1 lanes,
    the first ``m`` of each live.  Returns ([T, S] columns, pos, created,
    count) as numpy."""
    pos = torch.zeros((t_n, 2), dtype=torch.float32)
    created = torch.zeros(t_n, dtype=torch.bool)
    count = torch.tensor(0, dtype=torch.int32)
    cols, off = [], 0
    for m in splits:
        def blk(a):
            return torch.from_numpy(np.concatenate(
                [a[off:off + m], np.zeros((s1 - m,) + a.shape[1:], a.dtype)]))
        out = fn(blk(aoa), blk(aod), blk(pw), blk(val), torch.tensor(m, dtype=torch.int32),
                 pos, created, count, gate)
        *c, pos, created, count = out
        cols.append([x.numpy()[:m] for x in c])
        off += m
    return ([np.concatenate([c[i] for c in cols]).T for i in range(4)], pos.numpy(),
            created.numpy(), int(count))


def run_pallas(aoa_l, aod_l, pow_l, val_l, m_eff, pos, created, count, gate):
    import jax.numpy as jnp

    from slam_process_tpu.ops.pallas_tracker import track_block_pallas

    out = track_block_pallas(aoa_l.numpy(), aod_l.numpy(), pow_l.numpy(),
                             val_l.numpy().astype(np.int32), jnp.int32(int(m_eff)),
                             jnp.asarray(pos.numpy()), jnp.asarray(created.numpy()),
                             jnp.int32(int(count)), gate_deg=gate, interpret=True)
    return tuple(torch.from_numpy(np.array(x)) for x in out)


def assert_tracks(got, ref):
    (oa, od, op, oo), pos, created, count = got
    np.testing.assert_array_equal(oa, ref.pos_aoa)
    np.testing.assert_array_equal(od, ref.pos_aod)
    np.testing.assert_array_equal(op, ref.power)
    np.testing.assert_array_equal(oo, ref.observed)
    np.testing.assert_array_equal(created, ref.created)
    assert count == ref.n_tracks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_matches_pallas_and_oracle(seed):
    rng = np.random.default_rng(seed)
    for _ in range(4):
        s_n, k_n, t_n = int(rng.integers(1, 20)), int(rng.integers(1, 6)), int(rng.integers(2, 10))
        gate = float(rng.uniform(3, 30))
        aoa, aod, pw, val = random_case(rng, s_n, k_n)
        ref = tracking.track_paths_np(aoa, aod, pw, val, max_tracks=t_n, gate_deg=gate)
        s1 = s_n + int(rng.integers(0, 4))
        assert_tracks(run_blocks(track_block_plain, aoa, aod, pw, val, t_n, gate, s1, [s_n]),
                      ref)
        assert_tracks(run_blocks(run_pallas, aoa, aod, pw, val, t_n, gate, s1, [s_n]), ref)


def test_block_split_invariance():
    """Any split of the sweep axis gives the same columns and carry: sweeps
    close in arbitrary counts per window."""
    rng = np.random.default_rng(42)
    s_n, k_n, t_n, gate, s1 = 30, 3, 8, 10.0, 12
    aoa, aod, pw, val = random_case(rng, s_n, k_n)
    ref = tracking.track_paths_np(aoa, aod, pw, val, max_tracks=t_n, gate_deg=gate)
    for splits in ([12, 12, 6], [0, 5, 1, 12, 0, 7, 5], [1] * 30):
        assert_tracks(run_blocks(track_block, aoa, aod, pw, val, t_n, gate, s1, splits), ref)


def test_meff_zero_is_carry_noop():
    rng = np.random.default_rng(5)
    t_n, k_n, s1 = 8, 3, 16
    aoa, aod, pw, val = (torch.from_numpy(x) for x in random_case(rng, s1, k_n))
    pos = torch.from_numpy(rng.uniform(-45, 45, (t_n, 2)).astype(np.float32))
    created = torch.from_numpy(rng.random(t_n) < 0.5)
    count = torch.tensor(int(created.sum()), dtype=torch.int32)
    for fn in (track_block_plain, run_pallas):
        ca, cd, cp, co, npos, ncreated, ncount = fn(aoa, aod, pw, val,
                                                    torch.tensor(0, dtype=torch.int32), pos,
                                                    created, count, 10.0)
        assert torch.equal(npos, pos) and torch.equal(ncreated, created)
        assert int(ncount) == int(count)
        assert torch.equal(ca, pos[:, 0].expand(s1, t_n)) and not co.any() and not cp.any()


def test_planted_ties_and_gate_boundary():
    """Sweep 0 opens tracks at (0, 0) and (10, 0).  Sweep 1: path 0 at (5,
    0) costs 25 from both tracks (the tie goes to track 0: flat 0 < flat
    3), path 2 at (13, 4) costs exactly 25 = gate2 from track 1 (accepted),
    path 1 at (3, 4.0001) costs just past gate2 from track 0 and opens
    track 2.  Sweep 2: track 2 takes path 2 first (4.9996), then flats 0,
    1 and 3 all cost exactly 25 and flat 0 wins; path 1 opens track 3."""
    f32 = np.float32
    aoa = np.array([[0, 10, 0], [5, 3, 13], [8, 2, 5]], f32)
    aod = np.array([[0, 0, 0], [0, 4.0001, 4], [4, -4, 5]], f32)
    pw = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], f32)
    val = np.array([[1, 1, 0], [1, 1, 1], [1, 1, 1]], bool)
    ref = tracking.track_paths_np(aoa, aod, pw, val, max_tracks=4, gate_deg=5.0)
    np.testing.assert_array_equal(ref.observed[:, 1:], [[1, 1], [1, 0], [1, 1], [0, 1]])
    np.testing.assert_array_equal(ref.pos_aoa[:, 1:], [[5, 8], [13, 13], [3, 5], [0, 2]])
    np.testing.assert_array_equal(ref.power[:, 1:], [[4, 7], [6, 0], [5, 9], [0, 8]])
    for fn in (track_block_plain, run_pallas):
        assert_tracks(run_blocks(fn, aoa, aod, pw, val, 4, 5.0, 3, [3]), ref)


@pytest.mark.parametrize("grid,extra_lanes", [(False, 0), (True, 1), (True, 0)])
def test_block_at_the_limits_matches_pallas_and_oracle(grid, extra_lanes):
    """T = 16 tracks and K = 20 paths, the largest block the kernel takes
    (320 pairs, ten per thread of its one warp).  On an integer grid many
    costs tie exactly, so the lowest flat index must win across pairs that
    different threads hold.  ``extra_lanes = 1`` leaves one dead lane after
    the live ones (m_eff = s1 - 1)."""
    rng = np.random.default_rng(16 + 20 * grid + extra_lanes)
    s_n, k_n, t_n = 12, 20, 16
    gate = 6.0 if grid else 15.0
    aoa, aod, pw, val = random_case(rng, s_n, k_n)
    if grid:
        aoa = rng.integers(-4, 5, (s_n, k_n)).astype(np.float32)
        aod = rng.integers(-4, 5, (s_n, k_n)).astype(np.float32)
    ref = tracking.track_paths_np(aoa, aod, pw, val, max_tracks=t_n, gate_deg=gate)
    assert ref.n_tracks >= t_n - 1 and ref.observed[:, 1:].sum() > 3 * (s_n - 1)
    for fn in (track_block_plain, track_block, run_pallas):
        assert_tracks(run_blocks(fn, aoa, aod, pw, val, t_n, gate, s_n + extra_lanes, [s_n]),
                      ref)


def test_meff_past_s1_runs_every_lane():
    """m_eff > s1 (more sweeps closed than the block holds) runs all s1
    lanes, as m_eff = s1 does."""
    rng = np.random.default_rng(8)
    s1, k_n, t_n = 9, 5, 8
    lanes = [torch.from_numpy(x) for x in random_case(rng, s1, k_n)]
    carry = (torch.zeros((t_n, 2)), torch.zeros(t_n, dtype=torch.bool),
             torch.tensor(0, dtype=torch.int32))
    want = track_block_plain(*lanes, torch.tensor(s1, dtype=torch.int32), *carry, 10.0)
    assert int(want[6]) > 0
    for fn in (track_block_plain, run_pallas):
        got = fn(*lanes, torch.tensor(s1 + 7, dtype=torch.int32), *carry, 10.0)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("s_n,k_n,t_n", [(25, 3, 8), (7, 5, 3), (0, 3, 8)])
def test_track_paths_matches_jax_and_oracle(s_n, k_n, t_n):
    import jax

    from slam_process_tpu.models.tracking import track_paths_jax

    rng = np.random.default_rng(s_n + 10 * k_n)
    aoa, aod, pw, val = random_case(rng, s_n, k_n)
    got = tracking.track_paths(*(torch.from_numpy(x) for x in (aoa, aod, pw, val)),
                               max_tracks=t_n, gate_deg=12.0)
    want = jax.device_get(track_paths_jax(aoa, aod, pw, val, max_tracks=t_n, gate_deg=12.0))
    ref = tracking.track_paths_np(aoa, aod, pw, val, max_tracks=t_n, gate_deg=12.0)
    for name in ("pos_aoa", "pos_aod", "power", "observed", "created"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(ref, name))
    assert int(got.n_tracks) == int(want.n_tracks) == ref.n_tracks


def test_numpy_copies_match_jax():
    from slam_process_tpu.models import tracking as jax_tracking

    rng = np.random.default_rng(3)
    aoa, aod, pw, val = random_case(rng, 40, 3)
    ours = tracking.track_paths_np(aoa, aod, pw, val, max_tracks=6, gate_deg=8.0)
    theirs = jax_tracking.track_paths_np(aoa, aod, pw, val, max_tracks=6, gate_deg=8.0)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    times = np.cumsum(rng.integers(60_000, 62_000, 40)).astype(np.int64)
    times[5] = -1
    times[6:9] = times[5 - 1]                # a degenerate stretch of equal times
    for scale in (None, 1e6):
        for a, b in zip(tracking.track_velocities(ours, times, scale),
                        jax_tracking.track_velocities(theirs, times, scale)):
            np.testing.assert_array_equal(a, b)
