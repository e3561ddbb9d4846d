"""The stream axes' plain versions (kernels K1 and K6 over S streams) ==
the JAX package's functions, stream by stream.

``ops/decode.decode_rows_streams_plain`` against ``decode_rows_jax`` on
each stream with its limit, and ``ops/tracker.track_block_streams_plain``
against the JAX package's tracker step (``make_track_sweep_step`` under
``lax.scan``, from each stream's carry, lanes past ``m_eff`` all invalid)
and, where the block is small, ``track_block_pallas`` in interpret mode:
exactly, on the seeded inputs of ``utils/synthetic.decode_stream_cases`` and
``track_stream_cases`` that the card's kernels are held to (ragged limits of
0, mid-frame, exactly n and past n; widths that are multiples of neither 11
nor 16; one long stream; chains over several staging tiles; T = 16, K = 20;
planted ties; a NaN cost; m_eff of 0 and past s1).  Tensors stay on the
CPU, where the plain versions run.
"""

import functools

import numpy as np
import pytest
import torch

from slam_process_tpu.ops.decode import decode_frames_np, decode_rows_jax
from slam_process_tpu_torch.ops.decode import decode_rows_streams, decode_rows_streams_plain
from slam_process_tpu_torch.ops.tracker import track_block_streams, track_block_streams_plain
from slam_process_tpu_torch.utils.synthetic import decode_stream_cases, track_stream_cases


@functools.lru_cache(maxsize=None)
def decode_cases(size: str) -> dict:
    return decode_stream_cases() if size == "full" else decode_stream_cases(7, 20_011, seed=1)


DECODE_PARAMS = [("small", name) for name in sorted(decode_stream_cases(2, 2_000))] + [
    ("full", "ragged_limits"), ("full", "width_not_multiple_of_16")]


@pytest.mark.parametrize("size,name", DECODE_PARAMS)
def test_decode_streams_plain_matches_jax_per_stream(size, name):
    """Rows, valid and count of every stream equal ``decode_rows_jax`` on
    that stream with its limit; on the small inputs the count also equals
    the host engine's frames below the limit."""
    import jax.numpy as jnp

    b, limits = decode_cases(size)[name]
    lim_t = None if limits is None else torch.from_numpy(limits)
    got = decode_rows_streams_plain(torch.from_numpy(b), n_valid=lim_t)
    assert [tuple(g.shape) for g in got] == [(b.shape[0], -(-b.shape[1] // 11), 5),
                                             (b.shape[0], -(-b.shape[1] // 11)), (b.shape[0],)]
    same = decode_rows_streams(torch.from_numpy(b), n_valid=lim_t)
    for g, w in zip(same, got):
        assert torch.equal(g, w)
    for s in range(b.shape[0]):
        lim = None if limits is None else int(limits[s])
        want = decode_rows_jax(jnp.asarray(b[s]), n_valid=None if lim is None else jnp.int32(lim))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[s].numpy(), np.asarray(w))
        if size == "small":
            inside = b[s] if lim is None else b[s, :lim]
            assert int(got[2][s]) == decode_frames_np(inside).valid
    assert int(got[2][torch.from_numpy(limits) > 0].min() if limits is not None
               else got[2].min()) > 0
    if limits is not None:
        assert int(got[2][torch.from_numpy(limits) == 0].sum()) == 0


def jax_block(aoa, aod, pw, val, m_eff, pos, created, count, gate):
    """One stream's block through the JAX package's tracker step: a
    ``lax.scan`` from the carry, every path of a lane past ``m_eff`` invalid."""
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.models.tracking import make_track_sweep_step

    s1, k_n = aoa.shape
    live = np.arange(s1) < max(0, min(int(m_eff), s1))
    step = make_track_sweep_step(k_n, pos.shape[0], gate)
    (pos, created, count), ys = jax.lax.scan(
        step, (jnp.asarray(pos), jnp.asarray(created), jnp.int32(count)),
        (jnp.asarray(aoa), jnp.asarray(aod), jnp.asarray(pw), jnp.asarray(val & live[:, None])))
    return (*ys, pos, created, count)


TRACK_CASES = track_stream_cases()


@pytest.mark.parametrize("name", sorted(TRACK_CASES))
def test_track_streams_plain_matches_jax_per_stream(name):
    """The four [S, s1, T] columns and the new carry of every stream equal
    the JAX tracker step's, bit for bit (NaN where it is NaN)."""
    *arrays, gate = TRACK_CASES[name]
    args = [torch.from_numpy(a) for a in arrays]
    got = track_block_streams_plain(*args, gate)
    same = track_block_streams(*args, gate)
    for g, w in zip(same, got):
        assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                           w.view(torch.int32) if w.is_floating_point() else w)
    for s in range(arrays[0].shape[0]):
        want = jax_block(*(a[s] for a in arrays), gate)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[s].numpy(), np.asarray(w))
    if name == "planted_ties_and_nan":
        assert np.isnan(got[0][1].numpy()).any() and not np.isnan(got[0][0].numpy()).any()
    if name == "long_chains_K3":
        assert int(got[6][0]) == 8 and int(got[3][2].sum()) == 0


def test_planted_ties_and_nan_match_pallas_interpret():
    """The planted block against ``track_block_pallas`` in interpret mode,
    stream by stream."""
    import jax.numpy as jnp

    from slam_process_tpu.ops.pallas_tracker import track_block_pallas

    *arrays, gate = TRACK_CASES["planted_ties_and_nan"]
    got = track_block_streams_plain(*(torch.from_numpy(a) for a in arrays), gate)
    for s in range(arrays[0].shape[0]):
        aoa, aod, pw, val, m_eff, pos, created, count = (a[s] for a in arrays)
        want = track_block_pallas(aoa, aod, pw, val.astype(np.int32), jnp.int32(int(m_eff)),
                                  jnp.asarray(pos), jnp.asarray(created),
                                  jnp.int32(int(count)), gate_deg=gate, interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[s].numpy(), np.asarray(w))
