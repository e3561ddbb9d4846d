"""Port per-sweep sums (slam_process_tpu_torch) == the JAX package's.

``sweep_sums_plain`` (kernel K4's plain version) and
``intensity_per_sweep_sums`` against JAX's ``intensity_per_sweep_sums_jax``
scan form and the Pallas kernel ``sweep_sums_pallas`` in interpret mode, on
the seeded streams of ``tests/test_pallas_sweep_sums.py``: random rows with
out-of-range ids at 8, 24 and 65 sweeps, the sorted narrow-window stream
and the spill stream; and on the edge inputs of
``utils/synthetic.sweep_sums_edge_cases``, the contract kernel K4 is held to
on the card (one cell over many tiles, sorted p with -1 runs and a -1 tail,
S = 1, a cell at 2^24 - 1; the n_beams other than 64, which the JAX forms
do not take, against an int64 numpy sum).  RSS is an integer < 2^18 and
every cell sum stays below 2^24, so all three compute exact integers:
equality is required.
"""

import numpy as np
import pytest
import torch

from slam_process_tpu.config import SceneConfig as JaxSceneConfig
from slam_process_tpu_torch.config import SceneConfig
from slam_process_tpu_torch.ops.scene import (
    intensity_per_sweep, intensity_per_sweep_sums, sweep_sums_plain)
from slam_process_tpu_torch.utils.synthetic import sweep_sums_edge_cases


def random_rows(seed, s):
    rng = np.random.default_rng(seed)
    f = 1024
    ue = rng.integers(-1, 66, f).astype(np.int32)       # incl. out-of-range
    bs = rng.integers(0, 64, f).astype(np.int32)
    rss = rng.integers(0, 1 << 18, f).astype(np.int32)
    gid = np.sort(rng.integers(-1, s + 2, f)).astype(np.int32)
    valid = rng.random(f) < 0.8
    return ue, bs, rss, gid, valid


def narrow_rows(s=65):
    rng = np.random.default_rng(7)
    f = 8192
    gid = np.sort(rng.integers(0, 10, f)).astype(np.int32)
    gid[-1024:] = np.sort(rng.integers(s - 3, s, 1024)).astype(np.int32)
    ue = rng.integers(0, 64, f).astype(np.int32)
    bs = rng.integers(0, 64, f).astype(np.int32)
    rss = rng.integers(0, 1 << 18, f).astype(np.int32)
    valid = rng.random(f) < 0.9
    return ue, bs, rss, gid, valid


def spill_rows(s=65):
    rng = np.random.default_rng(11)
    f = 2048
    gid = np.sort(rng.integers(0, s, f)).astype(np.int32)
    ue = rng.integers(0, 64, f).astype(np.int32)
    bs = rng.integers(0, 64, f).astype(np.int32)
    rss = rng.integers(0, 1 << 18, f).astype(np.int32)
    return ue, bs, rss, gid, np.ones(f, bool)


CASES = {
    "seed0_S8": (lambda: random_rows(0, 8), 8),
    "seed1_S24": (lambda: random_rows(1, 24), 24),
    "seed2_S65": (lambda: random_rows(2, 65), 65),
    "sorted_narrow_window_S65": (narrow_rows, 65),
    "spill_S65": (spill_rows, 65),
}


def kernel_stream(ue, bs, gid, valid, s):
    keep = (valid & (ue >= 0) & (ue < 64) & (bs >= 0) & (bs < 64) & (gid >= 0) & (gid < s))
    return np.where(keep, gid * 64 + ue, -1).astype(np.int32), keep


@pytest.mark.parametrize("name", sorted(CASES))
def test_sweep_sums_match_jax_scan_and_pallas(name):
    import jax.numpy as jnp

    from slam_process_tpu.ops.pallas_sweep_sums import sweep_sums_pallas
    from slam_process_tpu.ops.scene import intensity_per_sweep_sums_jax

    make, s = CASES[name]
    ue, bs, rss, gid, valid = make()
    scan = intensity_per_sweep_sums_jax(
        jnp.asarray(ue), jnp.asarray(bs), jnp.asarray(rss, jnp.float32), jnp.asarray(gid),
        jnp.asarray(valid), max_sweeps=s, cfg=JaxSceneConfig(), engine="scan")
    p, keep = kernel_stream(ue, bs, gid, valid, s)
    pallas = sweep_sums_pallas(jnp.asarray(p), jnp.asarray(bs), jnp.asarray(rss),
                               max_sweeps=s, interpret=True)
    plain = sweep_sums_plain(*(torch.from_numpy(x) for x in (p, bs, rss)), s)
    port = intensity_per_sweep_sums(*(torch.from_numpy(x) for x in (ue, bs, rss, gid, valid)),
                                    max_sweeps=s)
    for got in (plain, port):
        for g, w_scan, w_pallas in zip(got, scan, pallas):
            assert g.dtype == torch.float32 and g.shape == (s, 64, 64)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_scan))
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_pallas))
    assert float(plain[1].sum()) == float(keep.sum())


K4_EDGES = sweep_sums_edge_cases()


@pytest.mark.parametrize("name", sorted(K4_EDGES))
def test_sweep_sums_edge_cases_match_jax(name):
    import jax.numpy as jnp

    from slam_process_tpu.ops.pallas_sweep_sums import sweep_sums_pallas
    from slam_process_tpu.ops.scene import intensity_per_sweep_sums_jax

    p, bs, val, s, nb = K4_EDGES[name]
    keep = (p >= 0) & (p < s * nb) & (bs >= 0) & (bs < nb)
    want = [np.zeros(s * nb * nb + 1, np.int64) for _ in range(2)]
    cell = np.where(keep, p.astype(np.int64) * nb + bs, s * nb * nb)
    np.add.at(want[0], cell, np.where(keep, val, 0))
    np.add.at(want[1], cell, keep.astype(np.int64))
    want = [w[:-1].reshape(s, nb, nb).astype(np.float32) for w in want]
    plain = sweep_sums_plain(*(torch.from_numpy(x) for x in (p, bs, val)), s, nb)
    for g, w in zip(plain, want):
        assert g.dtype == torch.float32 and g.shape == (s, nb, nb)
        np.testing.assert_array_equal(g.numpy(), w)
    if name == "one_cell_2^24-1":
        assert float(plain[0].max()) == 2 ** 24 - 1
    if nb != 64:
        return
    ue, gid = np.where(keep, p % 64, 0), np.where(keep, p // 64, -1)
    scan = intensity_per_sweep_sums_jax(
        jnp.asarray(ue), jnp.asarray(bs), jnp.asarray(val, jnp.float32), jnp.asarray(gid),
        jnp.asarray(keep), max_sweeps=s, cfg=JaxSceneConfig(), engine="scan")
    pad = -len(p) % 1024                 # the Pallas kernel takes whole 1,024-row blocks
    pallas = sweep_sums_pallas(*(jnp.asarray(np.pad(x, (0, pad), constant_values=c))
                                 for x, c in ((p, -1), (bs, 0), (val, 0))),
                               max_sweeps=s, interpret=True)
    for g, w_scan, w_pallas in zip(plain, scan, pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_scan))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_pallas))


def test_intensity_per_sweep_matches_jax():
    import jax.numpy as jnp

    from slam_process_tpu.ops.scene import intensity_per_sweep_jax

    ue, bs, rss, gid, valid = random_rows(5, 12)
    want_mean, want_counts = intensity_per_sweep_jax(
        *(jnp.asarray(x) for x in (ue, bs, rss, gid, valid)), max_sweeps=12)
    mean, counts = intensity_per_sweep(*(torch.from_numpy(x) for x in (ue, bs, rss, gid, valid)),
                                       max_sweeps=12)
    assert counts.dtype == torch.int32 and mean.dtype == torch.float32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(mean.numpy(), np.asarray(want_mean))   # NaN == NaN here


def test_sweep_sums_edges_exact():
    """Out-of-range p and bs drop, F = 0 gives zeros, a sum just under
    2^24 in one cell stays exact."""
    p = torch.tensor([-1, 0, 64 * 3, 64 * 3 - 1, 5, 5], dtype=torch.int32)
    bs = torch.tensor([0, -1, 0, 63, 64, 2], dtype=torch.int32)
    val = torch.tensor([9, 9, 9, 7, 9, 11], dtype=torch.int32)
    sums, counts = sweep_sums_plain(p, bs, val, 3)
    assert float(counts.sum()) == 2 and float(sums[2, 63, 63]) == 7 and float(sums[0, 5, 2]) == 11
    empty = torch.zeros(0, dtype=torch.int32)
    for t in sweep_sums_plain(empty, empty, empty, 4):
        assert t.shape == (4, 64, 64) and not t.any()
    n = 64
    val = torch.full((n,), ((1 << 24) - 1) // n, dtype=torch.int32)
    sums, counts = sweep_sums_plain(torch.full((n,), 70, dtype=torch.int32),
                                    torch.full((n,), 3, dtype=torch.int32), val, 2)
    assert float(sums[1, 6, 3]) == float(val[0]) * n < 2 ** 24 and float(counts[1, 6, 3]) == n


def test_per_sweep_sums_guards():
    i32 = torch.zeros(4, dtype=torch.int32)
    ones = torch.ones(4, dtype=torch.bool)
    # The pre-log sums are float64 (ln(RSS), rows of RSS <= 0 dropped), not K4's.
    sums, counts = intensity_per_sweep_sums(i32, i32, i32, i32, ones, 2,
                                            SceneConfig(log_transform=True))
    assert sums.dtype == counts.dtype == torch.float64 and not counts.any()
    with pytest.raises(ValueError, match="integer RSS"):
        intensity_per_sweep_sums(i32, i32, i32.float(), i32, ones, 2)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        intensity_per_sweep_sums(*(t.to("meta") for t in (i32, i32, i32, i32, ones)), 2)
