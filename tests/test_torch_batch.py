"""Port batch (``slam_process_tpu_torch.parallel.batch``) == the JAX package's.

``batched_session_pipeline(None, ..., device="cpu")`` against JAX's
``batched_session_pipeline(make_mesh((1, 1)), ...)`` on the same stacked
bytes of four seeded sessions, both ``session_axis`` forms and both
``outputs``, every field under the contract of ``test_torch_pipeline.py``
(integer and bool fields and ``mean_grid`` exactly, the raster within its
bounds there); the port's ``vmap`` and ``scan`` forms bit for bit equal
to each other.  ``run_dataset`` with a small ``quantum`` (three buckets, an
empty session, one past the corrector's bounds) against JAX's, in input
order, with JAX's warning.  The flattened corrector (K2's call for S
sessions, ids offset by ``s * max_groups``) against S separate calls.
"""

import numpy as np
import pytest
import torch

from slam_process_tpu_torch.ops import correct
from slam_process_tpu_torch.ops.raster import colormap_lut
from slam_process_tpu_torch.parallel import batch
from slam_process_tpu_torch.parallel.mesh import make_mesh
from slam_process_tpu_torch.pipeline.device import DeviceSessionOut, session_pipeline
from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes
from test_torch_pipeline import EXACT, assert_outputs_match

SESSIONS = [dict(n_groups=3, frames_per_beam=2, baselines_per_group=5, seed=1),
            dict(n_groups=2, frames_per_beam=3, baselines_per_group=4, junk_frac=0.2, seed=2),
            dict(n_groups=4, frames_per_beam=1, baselines_per_group=6, seed=3),
            dict(n_groups=1, frames_per_beam=2, baselines_per_group=3, junk_frac=0.5, seed=4)]
N_PADDED = 1 << 15
BOUNDS = dict(max_groups=16, max_baselines_per_group=32)


@pytest.fixture(scope="module")
def stacked():
    raws = [synthetic_session_bytes(**c) for c in SESSIONS]
    return batch.stack_sessions(raws, N_PADDED)


@pytest.fixture(scope="module")
def lut():
    return colormap_lut("viridis")


@pytest.fixture(scope="module")
def jax_out(stacked, lut):
    """JAX's one-device batch of the four sessions, full outputs."""
    from slam_process_tpu.parallel.batch import batched_session_pipeline
    from slam_process_tpu.parallel.mesh import make_mesh

    fn = batched_session_pipeline(make_mesh((1, 1)), N_PADDED, **BOUNDS)
    return fn(*stacked, lut)


def port(stacked, lut, **kw):
    return batch.batched_session_pipeline(None, N_PADDED, device="cpu", **BOUNDS, **kw)(
        *stacked, lut)


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (NaN payloads included)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def row(out, i):
    return type(out)(*(None if x is None else x[i] for x in out))


@pytest.mark.parametrize("session_axis", ["vmap", "scan"])
def test_batched_pipeline_matches_jax(stacked, lut, jax_out, session_axis):
    got = port(stacked, lut, session_axis=session_axis)
    assert isinstance(got, DeviceSessionOut) and got.n_discarded is None
    assert all(getattr(got, f).shape[0] == len(SESSIONS) for f in EXACT)
    for i in range(len(SESSIONS)):
        want = row(jax_out, i)
        assert int(want.n_kept) > 0 and not bool(want.correct_overflow)
        assert_outputs_match(row(got, i), want)


@pytest.mark.parametrize("session_axis", ["vmap", "scan"])
def test_summary_outputs_match_full(stacked, lut, jax_out, session_axis):
    """``outputs="summary"`` keeps the per-session fields of the full form,
    and against JAX's summary program."""
    from slam_process_tpu.parallel.batch import batched_session_pipeline
    from slam_process_tpu.parallel.mesh import make_mesh

    got = port(stacked, lut, session_axis=session_axis, outputs="summary")
    full = port(stacked, lut, session_axis=session_axis)
    assert isinstance(got, batch.SessionSummaryOut)
    for f in got._fields:
        assert same_bits(getattr(got, f), getattr(full, f)), f
    want = batched_session_pipeline(make_mesh((1, 1)), N_PADDED, outputs="summary",
                                    session_axis=session_axis, **BOUNDS)(*stacked, lut)
    assert type(want).__name__ == "SessionSummaryOut" and want._fields == got._fields
    for f in ("n_frames", "correct_overflow", "n_kept", "counts", "mean_grid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_scan_bitwise_equals_vmap(stacked, lut):
    """JAX's ``test_scan_sessions_bitwise_equals_vmap``: the loop of single
    sessions and the batch give the same bits, NaN included."""
    vmap, scan = port(stacked, lut), port(stacked, lut, session_axis="scan")
    for f in DeviceSessionOut._fields:
        a, b = getattr(vmap, f), getattr(scan, f)
        if a is None:
            assert b is None
            continue
        assert same_bits(a, b), f


def test_batch_equals_single_sessions(stacked, lut):
    """Each row of the batch is the single-session pipeline's output."""
    got = port(stacked, lut)
    lut_t = torch.from_numpy(lut)
    for i in range(len(SESSIONS)):
        one = session_pipeline(torch.from_numpy(stacked[0][i]), lut_t, **BOUNDS)
        for f in DeviceSessionOut._fields:
            if f != "n_discarded":
                assert same_bits(getattr(got, f)[i], getattr(one, f)), f


def test_run_dataset_matches_jax():
    """Three buckets at a 16 KiB quantum, an empty session and one past the
    corrector's bounds (30 groups against 16): per-session summaries in
    input order, and JAX's warning naming the overflowing session."""
    from slam_process_tpu.parallel.batch import run_dataset as jax_run_dataset
    from slam_process_tpu.parallel.mesh import make_mesh

    raws = [synthetic_session_bytes(**SESSIONS[0]), np.zeros(0, np.uint8),
            synthetic_session_bytes(n_groups=30, frames_per_beam=1, baselines_per_group=1,
                                    seed=5),
            synthetic_session_bytes(**SESSIONS[1]), synthetic_session_bytes(**SESSIONS[3])]
    kw = dict(quantum=1 << 14, **BOUNDS)
    assert len({-(-len(r) // kw["quantum"]) for r in raws}) >= 3
    with pytest.warns(RuntimeWarning) as ours:
        got = batch.run_dataset(None, raws, device="cpu", **kw)
    with pytest.warns(RuntimeWarning) as ref:
        want = jax_run_dataset(make_mesh((1, 1)), raws, **kw)
    assert [str(w.message) for w in ours] == [str(w.message) for w in ref]
    assert "sessions [2]" in str(ours[0].message)
    assert len(got) == len(want) == len(raws)
    for g, w in zip(got, want):
        assert isinstance(g, batch.SessionSummaryOut) and isinstance(g.counts, np.ndarray)
        for f in ("n_frames", "correct_overflow"):
            assert g._asdict()[f].dtype == np.asarray(getattr(w, f)).dtype, f
            np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(w, f)), err_msg=f)
        # Past the bounds the corrector's other outputs are unusable in both.
        if not bool(g.correct_overflow):
            np.testing.assert_array_equal(g.n_kept, np.asarray(w.n_kept))
            np.testing.assert_array_equal(g.counts, np.asarray(w.counts))
            np.testing.assert_array_equal(g.mean_grid, np.asarray(w.mean_grid))
            fin = np.isfinite(np.asarray(w.blurred))
            np.testing.assert_allclose(g.blurred[fin], np.asarray(w.blurred)[fin], rtol=1e-5)
    assert int(got[1].n_frames) == 0 and not np.isfinite(got[1].blurred).any()
    assert int(got[0].n_frames) == 64 * 3 * 2


def test_run_dataset_grouped_layout():
    """The low-level form: one entry per bucket, rows in that bucket's input
    order, and its summaries equal ``run_dataset``'s."""
    raws = [synthetic_session_bytes(**c) for c in SESSIONS]
    grouped = batch.run_dataset_batched_grouped(None, raws, quantum=1 << 14, device="cpu",
                                                **BOUNDS)
    assert sorted(i for idxs, _ in grouped for i in idxs) == list(range(len(raws)))
    flat = batch.run_dataset(None, raws, quantum=1 << 14, device="cpu", **BOUNDS)
    for idxs, out in grouped:
        for r, i in enumerate(idxs):
            np.testing.assert_array_equal(out.counts[r].numpy(), flat[i].counts)
            assert int(out.n_frames[r]) == int(flat[i].n_frames)


def test_mesh_and_options_are_refused(stacked, lut):
    cpu_mesh = make_mesh((1, 1), devices=["cpu"])
    with pytest.raises(ValueError, match="pass mesh= or device=, not both"):
        batch.batched_session_pipeline(cpu_mesh, N_PADDED, device="cpu")
    with pytest.raises(ValueError, match="pass mesh= or device=, not both"):
        batch.run_dataset(cpu_mesh, [np.zeros(10, np.uint8)], device="cpu")
    with pytest.raises(ValueError, match="outputs"):
        batch.batched_session_pipeline(None, N_PADDED, outputs="x", device="cpu")
    with pytest.raises(ValueError, match="session_axis"):
        batch.batched_session_pipeline(None, N_PADDED, session_axis="x", device="cpu")
    with pytest.raises(ValueError, match=r"\[S, 32768\]"):
        batch.batched_session_pipeline(None, N_PADDED, device="cpu")(stacked[0][:, :100],
                                                                    stacked[1], lut)


def test_flattened_corrector_equals_separate_calls(stacked):
    """One ``correct_verdicts`` call on the S sessions' rows with ids offset
    by ``s * max_groups`` and the stacked table equals S separate calls;
    the batched ``correct_rows`` equals per-session calls, each session's
    overflow its own.  Sessions of 1-3 groups, so 256-row blocks span two
    sessions and invalid rows sit between them."""
    from slam_process_tpu_torch.ops.decode import decode_rows_streams

    frames, valid, _ = decode_rows_streams(torch.from_numpy(stacked[0]))
    g = BOUNDS["max_groups"]
    gid, packed, overflow = correct.baseline_table(frames, valid, g, 32)
    assert tuple(gid.shape) == tuple(valid.shape) and packed.shape[0] == len(SESSIONS) * g
    clk = frames[..., 4]
    flat = correct.baseline_plane_verdicts(gid.reshape(-1), clk.reshape(-1), packed, bmax=32,
                                           cycle=61_000, tol=500)
    for i in range(len(SESSIONS)):
        gid_i, packed_i, ovf_i = correct.baseline_table(frames[i], valid[i], g, 32)
        torch.testing.assert_close(gid[i], gid_i + i * g, rtol=0, atol=0)
        torch.testing.assert_close(packed[i * g:(i + 1) * g], packed_i, rtol=0, atol=0)
        assert bool(overflow[i]) == bool(ovf_i)
        one = correct.baseline_plane_verdicts(gid_i, clk[i].contiguous(), packed_i, bmax=32,
                                              cycle=61_000, tol=500)
        for a, b in zip(flat, one):
            assert torch.equal(a.view(len(SESSIONS), -1)[i], b)
        rows = correct.correct_rows(frames[i], valid[i], g, 32)
        both = correct.correct_rows(frames, valid, g, 32)
        for a, b in zip(both, rows):
            assert torch.equal(a[i], b)
    # Ids stay sorted across the sessions (K2 stages a block's groups).
    assert bool((gid.reshape(-1)[1:] >= gid.reshape(-1)[:-1]).all())

    # Per-session overflow: 30 groups overflow 16 alone, beside a session
    # that fits.
    over = torch.from_numpy(batch.stack_sessions([
        synthetic_session_bytes(**SESSIONS[0]), synthetic_session_bytes(
            n_groups=30, frames_per_beam=1, baselines_per_group=1, seed=5)], N_PADDED)[0])
    f2, v2, _ = decode_rows_streams(over)
    assert correct.correct_rows(f2, v2, g, 32)[2].tolist() == [False, True]
