"""Port masked-row compaction (kernel K5's plain version) == the JAX package's.

``ops/compact.compact_rows_plain`` against ``compact_rows_pallas(...,
interpret=True)`` (the Pallas kernel as the JAX suite runs it on the CPU)
and the ``rows[mask][:capacity]`` zero-padded oracle, exactly: pure
integer data movement.  Cases as ``tests/test_pallas_compact.py``, plus
masked counts above the capacity and no masked row; then the append form
(an output buffer and a device-side offset) that the emit ring uses, and
the two-destination form (``compact_rows_multi``) that gives the emit ring
and the online paths their rows from one pass.
"""

import numpy as np
import pytest
import torch

from slam_process_tpu_torch.ops.compact import (
    compact_rows, compact_rows_multi, compact_rows_multi_plain, compact_rows_plain)


def case(seed, f, dens):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 30, (f, 5)).astype(np.int32)
    rows[:, 0] = rng.integers(0, 2, f)          # realistic field ranges
    return rows, rng.random(f) < dens


@pytest.mark.parametrize("seed,f,cap,dens", [
    (0, 2048, 512, 0.2),
    (1, 4096, 4096, 0.6),
    (2, 1024, 256, 0.9),      # masked count > capacity
    (3, 1024, 1024, 0.0),     # nothing masked
    (4, 8192, 512, 0.9),      # later blocks start past the capacity
    (5, 3072, 3000, 0.97),    # tail of a few zero rows
])
def test_compact_matches_pallas_and_gather(seed, f, cap, dens):
    import jax.numpy as jnp

    from slam_process_tpu.ops.pallas_compact import compact_rows_pallas

    rows, mask = case(seed, f, dens)
    want = np.asarray(compact_rows_pallas(jnp.asarray(rows), jnp.asarray(mask), capacity=cap,
                                          interpret=True))
    ref = np.zeros((cap, 5), np.int32)
    sel = rows[mask][:cap]
    ref[:len(sel)] = sel
    np.testing.assert_array_equal(want, ref)
    for fn in (compact_rows_plain, compact_rows):
        out, count = fn(torch.from_numpy(rows), torch.from_numpy(mask), cap)
        assert out.dtype == torch.int32 and count.dtype == torch.int32 and count.dim() == 0
        np.testing.assert_array_equal(out.numpy(), want)
        assert int(count) == int(mask.sum())


@pytest.mark.parametrize("offset,cap", [(0, 600), (37, 600), (590, 600), (600, 600),
                                        (10, 400)])
def test_append_at_offset_keeps_other_rows(offset, cap):
    """The emit-ring form: masked rows land at out[offset:] while below
    ``capacity``; rows of ``out`` outside them are untouched."""
    rows, mask = case(9, 700, 0.5)
    ring = np.random.default_rng(1).integers(-5, 5, (650, 4)).astype(np.int32)
    want = ring.copy()
    sel = rows[mask][:, 1:]
    take = max(0, min(len(sel), cap - offset))
    want[offset:offset + take] = sel[:take]
    out = torch.from_numpy(ring.copy())
    got, count = compact_rows(torch.from_numpy(np.ascontiguousarray(rows[:, 1:])),
                              torch.from_numpy(mask), cap, out=out,
                              offset=torch.tensor(offset, dtype=torch.int32))
    assert got is out
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(count) == int(mask.sum())


@pytest.mark.parametrize("seed,f,dens,ring_rows,offset,cap_ring", [
    (10, 4096, 0.5, 5000, 17, 5000),    # both destinations hold every masked row
    (11, 3072, 0.9, 2000, 1500, 2000),  # the ring fills: rows past its capacity drop
    (12, 2048, 0.0, 100, 100, 100),     # nothing masked, offset at the capacity
    (13, 1024, 1.0, 8, 0, 8),
])
def test_compact_multi_matches_plain_calls_and_pallas(seed, f, dens, ring_rows, offset,
                                                      cap_ring):
    """The two-destination form (the stream's emit-ring append and its
    paths' fresh buffer): equal to one ``compact_rows_plain`` call per
    destination, and its fresh destination to the Pallas kernel."""
    import jax.numpy as jnp

    from slam_process_tpu.ops.pallas_compact import compact_rows_pallas

    rows, mask = case(seed, f, dens)
    ring = np.random.default_rng(seed).integers(-5, 5, (ring_rows, 5)).astype(np.int32)
    off = torch.tensor(offset, dtype=torch.int32)
    want_ring, n_ring = compact_rows_plain(torch.from_numpy(rows), torch.from_numpy(mask),
                                           cap_ring, out=torch.from_numpy(ring.copy()),
                                           offset=off)
    want_fresh, n_fresh = compact_rows_plain(torch.from_numpy(rows), torch.from_numpy(mask), f)
    pallas = np.asarray(compact_rows_pallas(jnp.asarray(rows), jnp.asarray(mask), capacity=f,
                                            interpret=True))
    np.testing.assert_array_equal(want_fresh.numpy(), pallas)
    for fn in (compact_rows_multi_plain, compact_rows_multi):
        out = torch.from_numpy(ring.copy())
        (got_ring, got_fresh), count = fn(torch.from_numpy(rows), torch.from_numpy(mask),
                                          [(cap_ring, out, off), (f, None, None)])
        assert got_ring is out and count.dtype == torch.int32 and count.dim() == 0
        np.testing.assert_array_equal(got_ring.numpy(), want_ring.numpy())
        np.testing.assert_array_equal(got_fresh.numpy(), pallas)
        assert int(count) == int(n_ring) == int(n_fresh) == int(mask.sum())


def test_compact_multi_takes_one_or_two_destinations():
    rows, mask = case(14, 64, 0.5)
    rows, mask = torch.from_numpy(rows), torch.from_numpy(mask)
    (one,), count = compact_rows_multi(rows, mask, [(64, None, None)])
    want, _ = compact_rows_plain(rows, mask, 64)
    assert torch.equal(one, want) and int(count) == int(mask.sum())
    for dests in ([], [(64, None, None)] * 3):
        with pytest.raises(ValueError, match="one or two destinations"):
            compact_rows_multi(rows, mask, dests)
