"""Port corrector (slam_process_tpu_torch) == the JAX package's corrector.

``correct_rows`` against ``correct_rows_jax`` exactly (corrected_bs, keep,
overflow) on synthetic sessions, a > 4,096-frame group and adversarial
masked rows; past the static bounds only the overflow flag is compared
(JAX's values there are sums of colliding one-hot payloads).  The plain
``baseline_plane_verdicts`` against the Pallas corrector kernel in
interpret mode, and the five corrector specs of
``slam_process_tpu/ops/correct.py::self_test`` with every row valid.  The
plain verdicts on the seeded edge inputs of
``utils/synthetic.verdict_edge_cases`` (the ones kernel K2's windowed
search is held to on the card) against the JAX package's
``baseline_plane_verdicts`` and, where the table fits its 128 groups, the
Pallas kernel in interpret mode.
"""

import functools

import numpy as np
import pytest
import torch

from slam_process_tpu.config import CorrectConfig as JaxCorrectConfig
from slam_process_tpu.ops.correct import baseline_plane_verdicts as jax_plane_verdicts
from slam_process_tpu.ops.correct import correct_rows_jax
from slam_process_tpu.ops.pallas_correct import correct_planes_pallas
from slam_process_tpu_torch.config import CorrectConfig
from slam_process_tpu_torch.ops.correct import (
    baseline_plane_verdicts, baseline_table, correct_rows)
from slam_process_tpu_torch.ops.decode import decode_rows
from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, verdict_edge_cases
from tests.test_pallas_correct import BMAX, CYCLE, G_PAD, TOL, _pack


def rows_of(**kw):
    raw = synthetic_session_bytes(**kw)
    rows, valid, _ = decode_rows(torch.from_numpy(raw))
    return rows.numpy(), valid.numpy()


def run_both(frames, valid, max_groups, bmax, cycle=61_000, tol=500):
    import jax
    import jax.numpy as jnp

    jax_fn = jax.jit(functools.partial(correct_rows_jax, max_groups=max_groups,
                                       max_baselines_per_group=bmax,
                                       cfg=JaxCorrectConfig(cycle=cycle, tol=tol)))
    want = jax_fn(jnp.asarray(frames), jnp.asarray(valid))
    got = correct_rows(torch.from_numpy(frames), torch.from_numpy(valid),
                       max_groups=max_groups, max_baselines_per_group=bmax,
                       cfg=CorrectConfig(cycle=cycle, tol=tol))
    return got, [np.asarray(w) for w in want]


SESSIONS = {
    "seed0": dict(n_groups=4, frames_per_beam=2, baselines_per_group=6, junk_frac=0.1, seed=0),
    "seed1": dict(n_groups=5, frames_per_beam=1, baselines_per_group=3, junk_frac=0.3, seed=1),
    "group_over_4096": dict(n_groups=2, frames_per_beam=2, baselines_per_group=5,
                            big_group=4200, seed=2),
}


@pytest.mark.parametrize("name", sorted(SESSIONS))
@pytest.mark.parametrize("cycle,tol", [(61_000, 500), (60_000, 300)])
def test_correct_rows_matches_jax(name, cycle, tol):
    frames, valid = rows_of(**SESSIONS[name])
    (bs, keep, ovf), (w_bs, w_keep, w_ovf) = run_both(frames, valid, 16, 64, cycle, tol)
    assert bs.dtype == torch.int32 and keep.dtype == torch.bool
    np.testing.assert_array_equal(bs.numpy(), w_bs)
    np.testing.assert_array_equal(keep.numpy(), w_keep)
    assert not bool(ovf) and not bool(w_ovf)
    if (cycle, tol) == (61_000, 500):
        assert keep.any()


def adversarial_rows(seed: int, f: int = 768):
    """Masked rows with frequent flag pairs, equal RSS, UE resets and gaps."""
    rng = np.random.default_rng(seed)
    flag = (rng.random(f) < 0.3).astype(np.int32)
    ue = np.cumsum(rng.integers(0, 2, f)) % 64
    ue[rng.random(f) < 0.02] = 0
    bs = rng.integers(0, 64, f)
    rss = rng.integers(0, 4, f)
    clk = (rng.integers(0, 40, f) * CYCLE + rng.integers(-700, 700, f)) % (1 << 30)
    frames = np.stack([flag, ue, bs, rss, clk], axis=1).astype(np.int32)
    valid = rng.random(f) < 0.8
    frames[~valid] = 0
    return frames, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_correct_rows_matches_jax_adversarial(seed):
    frames, valid = adversarial_rows(seed)
    (bs, keep, ovf), (w_bs, w_keep, w_ovf) = run_both(frames, valid, 512, 256)
    np.testing.assert_array_equal(bs.numpy(), w_bs)
    np.testing.assert_array_equal(keep.numpy(), w_keep)
    assert bool(ovf) == bool(w_ovf) is False


@pytest.mark.parametrize("max_groups,bmax", [(4, 64), (16, 4), (6, 6), (8, 8)])
def test_overflow_flag_matches_jax(max_groups, bmax):
    frames, valid = rows_of(**SESSIONS["seed1"])     # 5 groups x 3 baselines
    frames2, valid2 = rows_of(n_groups=2, frames_per_beam=1, baselines_per_group=6, seed=9)
    frames = np.concatenate([frames, frames2])
    valid = np.concatenate([valid, valid2])           # 7 groups, up to 6 baselines
    (_, _, ovf), (_, _, w_ovf) = run_both(frames, valid, max_groups, bmax)
    assert bool(ovf) == bool(w_ovf)
    assert bool(ovf) == (max_groups < 7 or bmax < 6)


@pytest.mark.parametrize("seed", [0, 1])
def test_plane_verdicts_match_pallas(seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    f = 256
    gid = np.sort(rng.integers(0, 64, f)).astype(np.int32)
    clk = rng.integers(0, 1 << 30, f).astype(np.int32)
    tbl_clk = rng.integers(0, 1 << 30, (G_PAD, BMAX)).astype(np.int32)
    g3 = int(gid[3])
    tbl_clk[g3, :4] = (clk[3] - np.array([TOL, TOL + 1, -TOL, -(TOL + 1)])) & ((1 << 30) - 1)
    tbl_bs = rng.integers(0, 64, (G_PAD, BMAX)).astype(np.int32)
    n_cap = rng.integers(0, BMAX + 1, G_PAD).astype(np.int32)
    n_cap[g3] = max(n_cap[g3], 4)
    packed = _pack(tbl_clk, tbl_bs, n_cap)

    want = correct_planes_pallas(jnp.asarray(gid), jnp.asarray(clk), jnp.asarray(packed),
                                 bmax=BMAX, cycle=CYCLE, tol=TOL, interpret=True,
                                 block_f=128)
    got = baseline_plane_verdicts(torch.from_numpy(gid), torch.from_numpy(clk),
                                  torch.from_numpy(packed), bmax=BMAX, cycle=CYCLE, tol=TOL)
    for g, w in zip(got, want):       # bit-exact, including rows with has False
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[0][3]) and got[0].any() and not got[0].all()


EDGE_CASES = verdict_edge_cases()


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_plane_verdicts_edge_cases_match_jax(name):
    """Every row's (has, k_best, bs_best), the rows without a verdict
    included, against the JAX XLA verdicts on the one-hot selection and,
    for tables of at most 128 groups, the Pallas kernel (interpret mode,
    on the first 512 rows: its interpreter unrolls each 256-row block)."""
    import jax.numpy as jnp

    gid, clk, packed, kw = EDGE_CASES[name]
    got = [g.numpy() for g in baseline_plane_verdicts(
        torch.from_numpy(gid), torch.from_numpy(clk), torch.from_numpy(packed), **kw)]
    inside = (gid >= 0) & (gid < packed.shape[0])
    sel = np.where(inside[:, None], packed[np.clip(gid, 0, packed.shape[0] - 1)], 0.0)
    want = jax_plane_verdicts(jnp.asarray(sel), jnp.asarray(clk), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[0].any()
    if packed.shape[0] <= G_PAD:
        table = np.zeros((G_PAD, packed.shape[1]), np.float32)
        table[:packed.shape[0]] = packed
        f = min(512, len(gid))
        rows = -(-f // 256) * 256
        g_p = np.full(rows, -1, np.int32)
        c_p = np.zeros(rows, np.int32)
        g_p[:f], c_p[:f] = np.where(inside[:f], gid[:f], -1), clk[:f]
        want = correct_planes_pallas(jnp.asarray(g_p), jnp.asarray(c_p), jnp.asarray(table),
                                     interpret=True, block_f=256, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[:f], np.asarray(w)[:f])


# The reference's embedded corrector specs (ops/correct.py::self_test).
CYC, TOLR, MOD = 61_000, 500, 64
SPEC_GROUP = [(0, 0, 10, 42, 1_000_000), (1, 1, 12, 42, 1_000_100),
              (0, 2, 99, 42, 1_000_000 + CYC + 50), (0, 3, 99, 42, 1_000_000 + 2 * CYC - 480),
              (0, 4, 99, 42, 1_000_000 + 3 * CYC + 600), (0, 5, 99, 42, 1_000_000 - CYC + 100)]


def correct_all_valid(rows):
    frames = torch.tensor(rows, dtype=torch.int32)
    valid = torch.ones(len(rows), dtype=torch.bool)
    bs, keep, ovf = correct_rows(frames, valid)
    assert not bool(ovf)
    return frames, bs, keep


def test_spec_baseline_identification():
    frames = torch.tensor(SPEC_GROUP, dtype=torch.int32)
    gid, packed, _ = baseline_table(frames, torch.ones(6, dtype=torch.bool))
    b = 256
    assert int(packed[0, 3 * b]) == 1 and not packed[1:, 3 * b].any()
    clk_b, bs_b = SPEC_GROUP[0][4], 12
    assert int(packed[0, 0]) * 256 + int(packed[0, b]) == clk_b % CYC
    assert int(packed[0, 2 * b]) == (bs_b - clk_b // CYC) % MOD


def test_spec_correction_logic():
    _, bs, _ = correct_all_valid(SPEC_GROUP)
    assert bs[1] == 12 and bs[2] == (12 + 1) % MOD and bs[3] == (12 + 2) % MOD


def test_spec_boundary_tolerance():
    c0 = 5_000_000
    rows = [(0, 0, 3, 7, c0), (1, 1, 8, 7, c0 + 10), (0, 2, 0, 7, c0 + CYC + TOLR),
            (0, 3, 0, 7, c0 + CYC + TOLR + 1)]
    _, bs, _ = correct_all_valid(rows)
    assert bs[2] == (8 + 1) % MOD and bs[3] == rows[3][2]


def test_spec_negative_diff():
    c0 = 7_000_000
    _, bs, _ = correct_all_valid([(0, 0, 60, 13, c0), (1, 1, 5, 13, c0 + 1),
                                  (0, 2, 0, 13, c0 - CYC + 10)])
    assert bs[2] == (5 - 1) % MOD


def test_spec_filter_only_corrected_rows():
    c0 = 2_000_000
    frames, bs, keep = correct_all_valid([(0, 0, 10, 21, c0), (1, 1, 12, 21, c0 + 50),
                                          (0, 2, 99, 21, c0 + CYC + 20),
                                          (0, 3, 99, 21, c0 + CYC + TOLR + 10)])
    filtered = torch.stack([frames[keep, 1], bs[keep], frames[keep, 3], frames[keep, 4]], 1)
    assert filtered.tolist() == [[0, 12, 21, c0], [2, 13, 21, c0 + CYC + 20]]


def test_packed_range_is_checked():
    frames, valid = rows_of(**SESSIONS["seed0"])
    with pytest.raises(ValueError):
        correct_rows(torch.from_numpy(frames), torch.from_numpy(valid),
                     max_baselines_per_group=4096, cfg=CorrectConfig(tol=500))
