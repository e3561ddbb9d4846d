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
The staging buffers: rows written in place equal ``stack_sessions`` byte
for byte (after longer sessions, on a mesh shard with padding rows);
``run_dataset``'s arrays and a call's tensors stay as they were after the
next call and share no memory with the program's buffers; ``run_dataset``
after a call of another row count in the same bucket equals each
session's own pipeline.
"""

import numpy as np
import pytest
import torch

from slam_process_tpu_torch.ops import correct
from slam_process_tpu_torch.ops.raster import colormap_lut
from slam_process_tpu_torch.parallel import batch
from slam_process_tpu_torch.parallel.mesh import make_mesh
from slam_process_tpu_torch.pipeline.device import (
    DeviceSessionOut, bucket_size, device_lut, pad_bytes, session_pipeline)
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


def even_sessions(seeds, n_groups=3):
    """Sessions without junk bytes: one byte length for every seed."""
    return [synthetic_session_bytes(n_groups=n_groups, frames_per_beam=2, baselines_per_group=4,
                                    junk_frac=0.0, seed=s) for s in seeds]


def program_buffers(fn) -> list:
    """The numpy views of a program's staging and copy-back buffers."""
    return [x for st in fn.staging
            for x in (st.bytes_np, None if st.out is None else st.out.numpy()) if x is not None]


@pytest.mark.parametrize("data_rows", [1, 2])
def test_staged_rows_equal_stack_sessions(data_rows):
    """``stage`` writes each session and its zero tail into the staging
    rows in place: after a call of longer sessions the rows equal
    ``stack_sessions`` of the new ones, and on a mesh shard the padding
    rows are all zeros."""
    mesh = (None if data_rows == 1
            else make_mesh((data_rows, 1), devices=[torch.device("cpu")] * data_rows))
    fn = batch.batched_session_pipeline(mesh, N_PADDED, outputs="summary",
                                        device="cpu" if mesh is None else None, **BOUNDS)
    long = [synthetic_session_bytes(n_groups=4, frames_per_beam=3, baselines_per_group=6,
                                    seed=10 + i) for i in range(3)]
    short = [synthetic_session_bytes(**SESSIONS[i]) for i in (3, 1, 0)]
    assert all(len(a) > len(b) for a, b in zip(long, short))
    for sessions in (long, short, short[:1] + long[1:]):
        fn.stage(sessions)
        pad = -len(sessions) % data_rows
        want, _ = batch.stack_sessions(sessions + [np.zeros(0, np.uint8)] * pad, N_PADDED)
        got = np.concatenate([st.bytes_np for st in fn.staging])
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
    if data_rows == 2:
        assert len(fn.staging) == 2 and not fn.staging[1].bytes_np[-1].any()


def test_run_dataset_calls_own_their_arrays():
    """Two ``run_dataset`` calls on campaigns of the same byte lengths and
    other bytes: the first call's arrays are unchanged after the second,
    and no array shares memory with the other call's or the programs'
    buffers; two calls of a program keep their own tensors too."""
    quantum = 1 << 13
    a_raws, b_raws = even_sessions((1, 2, 3)), even_sessions((4, 5, 6))
    a_raws += even_sessions((7,), n_groups=6)
    b_raws += even_sessions((8,), n_groups=6)
    assert [len(r) for r in a_raws] == [len(r) for r in b_raws]
    assert all(x.tobytes() != y.tobytes() for x, y in zip(a_raws, b_raws))
    a = batch.run_dataset(None, a_raws, quantum=quantum, device="cpu", **BOUNDS)
    kept = [{f: getattr(r, f).copy() for f in r._fields} for r in a]
    b = batch.run_dataset(None, b_raws, quantum=quantum, device="cpu", **BOUNDS)
    fns = {batch.batched_session_pipeline(None, bucket_size(len(r), quantum),
                                          outputs="summary", device="cpu", **BOUNDS)
           for r in a_raws}
    assert len(fns) > 1
    buffers = [x for fn in fns for x in program_buffers(fn)]
    for x, y, k in zip(a, b, kept):
        assert all(getattr(x, f).tobytes() == v.tobytes() for f, v in k.items())
        assert any(getattr(x, f).tobytes() != getattr(y, f).tobytes()
                   for f in ("counts", "mean_grid"))
        for f in batch.SessionSummaryOut._fields:
            assert not np.shares_memory(getattr(x, f), getattr(y, f)), f
            assert not any(np.shares_memory(getattr(v, f), buf) for v in (x, y)
                           for buf in buffers), f
    # The program called directly: the first call's tensors stay its own.
    fn = batch.batched_session_pipeline(None, N_PADDED, device="cpu", **BOUNDS)
    lut = device_lut(torch.device("cpu"))
    first = [x for x in fn(*batch.stack_sessions(a_raws, N_PADDED), lut) if x is not None]
    again = [x.clone() for x in first]
    fn(*batch.stack_sessions(b_raws, N_PADDED), lut)
    assert all(same_bits(x, y) for x, y in zip(first, again))
    assert not any(np.shares_memory(x.numpy(), buf) for x in first for buf in program_buffers(fn))


def test_run_dataset_after_another_row_count_equals_each_session():
    """One bucket called with 3, then 2, then 4 sessions: each call remakes
    the staging rows and equals each session's own pipeline, bit for bit."""
    quantum = 1 << 14
    raws = even_sessions(range(20, 24))
    (b,) = {bucket_size(len(r), quantum) for r in raws}
    lut = device_lut(torch.device("cpu"))
    fn = batch.batched_session_pipeline(None, b, outputs="summary", device="cpu", **BOUNDS)
    for n in (3, 2, 4):
        got = batch.run_dataset(None, raws[:n], quantum=quantum, device="cpu", **BOUNDS)
        assert fn.staging[0].rows == n
        for g, raw in zip(got, raws[:n]):
            want = session_pipeline(torch.from_numpy(pad_bytes(raw, b)), lut, **BOUNDS)
            for f in batch.SessionSummaryOut._fields:
                w = getattr(want, f).numpy()
                assert getattr(g, f).dtype == w.dtype and getattr(g, f).tobytes() == w.tobytes(), f
