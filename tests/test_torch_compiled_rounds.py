"""The batch's program and the multi-stream round in the JAX package's block form.

On the CPU (every kernel's plain version) the programs run their eager
bodies, the same code the CUDA graphs capture:

  * ``MultiStreamingSession``'s paths step runs the estimator as the JAX
    package's vmapped step does, on 8-lane blocks up to the largest count of
    closing sweeps (``parallel/streaming_device._lane_groups``).  Three
    crafted streams at 4 KiB windows (``s_step`` 8, two blocks with the last
    one's start clamped, and 6, a single block) give rounds whose largest
    count is 0, 1, 8, 9 and more than s1, with different counts per stream
    in one round: every stream's whole state equals its own
    ``DeviceStreamingSession`` exactly (the rings below ``n_closed``), after
    every round and after the flush, with and without a mesh; and the JAX
    package's ``MultiStreamingSession`` under
    ``tests/test_torch_multi_stream.py``'s bounds;
  * the round's two halves read nothing from the host but the count read
    between them (host reads raise while they run, except inside the
    kernels' plain versions, which are kernel launches on the card), and a
    round reads the counts once per shard (``HOST_SYNCS``);
  * ``batched_session_pipeline`` is cached per argument set and
    ``run_dataset`` goes through it; the host split of a flat output buffer
    (``FlatOutputs``), as ``run_dataset`` makes it on the card, is bit-equal
    to the per-field copy; two calls share no output storage.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from slam_process_tpu_torch.ops import compact, correct, decode, nnls, scene, tracker
from slam_process_tpu_torch.parallel import batch
from slam_process_tpu_torch.parallel import streaming_device as sd
from slam_process_tpu_torch.parallel.mesh import make_mesh
from slam_process_tpu_torch.utils.graphs import FlatOutputs
from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, write_angle_table
from test_torch_streaming import assert_same_paths

CHUNK = 1 << 12
EST = dict(grid_res=2.0)
RINGS = ("est_rings", "valid_ring", "time_ring", "trk_aoa", "trk_aod", "trk_pow", "trk_obs")
# Per 4 KiB round, sweeps closing in streams 0, 1, 2 (measured on these
# bytes): rounds 0-3 at most 1, then 7 / 8 / 8 in stream 0 alone, 10 and 9
# in stream 1 (stream 0 at 7 and 0), 9 and 15 / 16 with stream 2.
MAX_PER_ROUND = [0, 0, 1, 0, 7, 8, 8, 10, 9, 9, 15, 16, 3]


def short_groups(sizes, seed):
    """Sweeps of ``sizes[g]`` frames: each group of a one-frame-per-beam
    session (no junk, so 11 bytes a frame) cut to the run of its frames
    that starts just before its first baseline."""
    raw = synthetic_session_bytes(n_groups=len(sizes), frames_per_beam=1, baselines_per_group=12,
                                  junk_frac=0.0, seed=seed, n_paths=3)
    frames = raw[2:].reshape(-1, 64, 11)
    runs = []
    for g, f in enumerate(sizes):
        a = int(np.argmax(frames[g, :, 0] == 0xCC)) - 1
        assert a + f <= 64
        runs.append(frames[g, a:a + f])
    return np.concatenate(runs).reshape(-1)


def long_groups(n, seed):
    """``n`` sweeps of 512 frames (5,632 bytes: more than a window)."""
    return synthetic_session_bytes(n_groups=n, frames_per_beam=8, baselines_per_group=6,
                                   junk_frac=0.0, seed=seed, n_paths=3)[2:]


@pytest.fixture(scope="module")
def raws():
    """Long sweeps first, then short ones of 48, 41 and 24 frames, starting
    in later rounds stream by stream."""
    return [np.concatenate([long_groups(3, 1), short_groups([48] * 30, 2)]),
            np.concatenate([long_groups(5, 3), short_groups([41] * 30, 4)]),
            np.concatenate([long_groups(7, 5), short_groups([24] * 40, 6)])]


@pytest.fixture(scope="module")
def angles(tmp_path_factory):
    return write_angle_table(tmp_path_factory.mktemp("rounds") / "beam_angle.xlsx")


@pytest.fixture(scope="module")
def specs(angles):
    """{s_step: (JAX spec, the port's spec converted from it)}."""
    from slam_process_tpu.parallel import streaming_device as jsd
    from slam_process_tpu_torch.convert import paths_spec_from_reference

    out = {}
    for s_step in (8, 6):
        jspec = jsd.make_paths_spec(angles, s_step=s_step, **EST)
        out[s_step] = jspec, paths_spec_from_reference(*jspec, device="cpu")
    return out


def rounds(raws):
    """One window per stream and feed: the first ``CHUNK`` bytes, then
    ``CHUNK - 10`` (the carried bytes complete the window); b"" once a
    stream has ended."""
    feeds = [[r[:CHUNK]] + [r[o:o + CHUNK - sd.CARRY_BYTES]
                            for o in range(CHUNK, len(r), CHUNK - sd.CARRY_BYTES)] for r in raws]
    n = max(len(f) for f in feeds)
    return [[f[k] if k < len(f) else b"" for f in feeds] for k in range(n)]


def host(x):
    return np.asarray(x.cpu().numpy())


def assert_same_stream(a, row_a, b, row_b):
    """Stream ``row_a`` of state ``a`` against stream ``row_b`` of state
    ``b`` (None: a single stream's state): every leaf equal, the rings on
    their rows below ``n_closed``."""
    def pick(x, row):
        return x if row is None else x[row]

    n = int(pick(b.paths.n_closed, row_b))
    assert int(pick(a.paths.n_closed, row_a)) == n
    for f in dataclasses.fields(a):
        parts = ([(f.name, getattr(a, f.name), getattr(b, f.name))] if f.name != "paths" else
                 [(p.name, getattr(a.paths, p.name), getattr(b.paths, p.name))
                  for p in dataclasses.fields(a.paths)])
        for name, xa, xb in parts:
            for x, y in zip(sd._leaves(xa), sd._leaves(xb)):
                x, y = host(pick(x, row_a)), host(pick(y, row_b))
                if name in RINGS:
                    x, y = x[:n], y[:n]
                np.testing.assert_array_equal(x, y, err_msg=name)


def assert_stream_state(ms, i, s):
    """Stream ``i`` of ``ms`` against the single stream ``s``."""
    st, row = ms._locate(i)
    assert_same_stream(st, row, s._state, None)


def run_rounds(raws, spec, mesh=None, singles=None):
    """The multi-stream session fed ``rounds(raws)`` and flushed, with each
    stream held against its single stream after every round when
    ``singles`` is given; returns (session, per-round largest count)."""
    ms = sd.MultiStreamingSession(len(raws), chunk_bytes=CHUNK, collect_paths=spec,
                                  emit_capacity=1 << 13, mesh=mesh,
                                  device=None if mesh is not None else "cpu")
    largest = []
    for pieces in rounds(raws):
        before = ms.n_sweeps_closed_all()
        ms.feed(pieces)
        largest.append(int((ms.n_sweeps_closed_all() - before).max()))
        for i, s in enumerate(singles or ()):
            s.feed(pieces[i])
            assert_stream_state(ms, i, s)
    ms.finalize()
    for i, s in enumerate(singles or ()):
        s.finalize()
        assert_stream_state(ms, i, s)
    return ms, largest


def single(spec):
    return sd.DeviceStreamingSession(chunk_bytes=CHUNK, collect_paths=spec, collect_filtered=True,
                                     emit_capacity=1 << 13, device="cpu")


@pytest.fixture(scope="module")
def block_runs(raws, specs):
    """{s_step: the block form's session}, each stream held against its
    single stream after every round."""
    out = {}
    for s_step, (_, spec) in specs.items():
        ms, largest = run_rounds(raws, spec, singles=[single(spec) for _ in raws])
        assert largest == MAX_PER_ROUND
        out[s_step] = ms
    return out


def test_lane_groups_are_the_jax_blocks():
    assert sd._lane_groups(0, 9, False) == () == sd._lane_groups(0, 9, True)
    assert sd._lane_groups(1, 9, False) == ((0, 8),)
    # s1 = 9: the second block starts at 1, so lanes 1..8 run twice.
    assert sd._lane_groups(2, 9, False) == ((0, 8), (1, 8))
    assert sd._lane_groups(2, 9, True) == ((0, 9),)
    assert sd._lane_groups(9, 65, False)[-1] == (57, 8)
    assert sd._lane_groups(5, 65, True) == ((0, 40),)
    assert sd._lane_groups(1, 7, False) == ((0, 7),) == sd._lane_groups(1, 7, True)


@pytest.mark.parametrize("s_step", [8, 6])
def test_block_form_equals_single_streams_every_round(block_runs, s_step):
    """Rounds of largest count 0, 1, 8, 9 and past s1 (an overflow in the
    streams past s_step), each stream equal to its own single stream after
    every round and the flush (in the fixture); the overflow flags are the
    single streams'."""
    ms = block_runs[s_step]
    assert {0, 1, 8, 9} <= set(MAX_PER_ROUND) and max(MAX_PER_ROUND) > s_step + 1
    over = host(ms._state.paths.overflow).tolist()
    assert over == ([False, True, True] if s_step == 8 else [True, True, True])


@pytest.mark.parametrize("s_step", [8, 6])
def test_mesh_form_equals_the_block_form(raws, specs, block_runs, s_step):
    """The block form over a mesh of two CPU positions (streams padded to
    4) leaves the block form's state."""
    want = block_runs[s_step]
    got, _ = run_rounds(raws, specs[s_step][1],
                        mesh=make_mesh((2, 1), devices=[torch.device("cpu")] * 2))
    np.testing.assert_array_equal(got.n_sweeps_closed_all(), want.n_sweeps_closed_all())
    for i in range(len(raws)):
        st, row = got._locate(i)
        assert_same_stream(st, row, want._state, i)


@pytest.mark.parametrize("s_step", [8, 6])
def test_block_form_matches_jax(raws, specs, block_runs, s_step):
    """JAX's vmapped multi-stream session on the same rounds: counts, sums,
    closed-sweep counts and filtered rows equal; the paths and tracks of the
    rings of every stream under test_torch_multi_stream.py's bounds (NN-OMP
    indices, ``n_iters``, ``valid`` and the tracks' positions equal, power
    within rtol 2e-4)."""
    from slam_process_tpu.parallel import streaming_device as jsd

    jms = jsd.MultiStreamingSession(len(raws), chunk_bytes=CHUNK, collect_paths=specs[s_step][0],
                                    emit_capacity=1 << 13)
    for pieces in rounds(raws):
        jms.feed(pieces)
    jms.finalize()
    ms = block_runs[s_step]
    got, want = ms.results(), jms.results()
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(got[3], np.asarray(want[3]).astype(np.int64))
    np.testing.assert_array_equal(got[4], np.asarray(want[4]))
    np.testing.assert_array_equal(ms.n_sweeps_closed_all(), jms.n_sweeps_closed_all())
    for i in range(len(raws)):
        np.testing.assert_array_equal(ms.stream_filtered(i), jms.stream_filtered(i))
    # The rings on their rows below n_closed, read from both states (the
    # readers refuse a session in which a stream overflowed).
    jp, port = jms._state.paths, ms._state.paths
    n = ms.n_sweeps_closed_all()
    for name, got, want in ([(f, getattr(port.est_rings, f), getattr(jp.est_rings, f))
                             for f in port.est_rings._fields]
                            + [(f, getattr(port, f), getattr(jp, f)) for f in RINGS[1:]]):
        for i in range(len(raws)):
            g, w = host(got[i])[:n[i]], np.asarray(want)[i][:n[i]]
            assert g.dtype == w.dtype, name
            if name in ("power", "trk_pow"):
                np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{name} stream {i}")


# The round's kernels' plain versions, K1, K2, K4, K5, K6 and K7.
KERNEL_PLAIN = ((decode, "decode_rows_streams_plain"), (correct, "baseline_plane_verdicts"),
                (scene, "sweep_sums_plain"), (compact, "compact_rows_streams_plain"),
                (tracker, "track_block_streams_plain"), (nnls, "nnls_gram_plain"))


@contextlib.contextmanager
def host_reads_raise():
    """Every host read of a tensor raises, except inside the kernels' plain
    versions (``KERNEL_PLAIN``: kernel launches on the card, which read
    nothing back)."""
    inside = [0]

    def allowed(fn):
        def call(*a, **kw):
            inside[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                inside[0] -= 1
        return call

    def refuse(name):
        original = getattr(torch.Tensor, name)

        def read(self, *a, **kw):
            if not inside[0]:
                raise AssertionError(f"host read Tensor.{name} inside a round's half")
            return original(self, *a, **kw)
        return read

    with pytest.MonkeyPatch.context() as mp:
        for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__float__",
                     "__index__"):
            mp.setattr(torch.Tensor, name, refuse(name))
        for mod, name in KERNEL_PLAIN:
            mp.setattr(mod, name, allowed(getattr(mod, name)))
        yield


def test_round_halves_read_nothing_and_one_count_read_a_round(raws, specs, monkeypatch):
    """Both halves of every round and flush run with host reads raising
    (the count read between them is the only one, ``HOST_SYNCS``: one a
    round and shard); the state equals the block form's."""
    spec = specs[8][1]
    for name in ("_round_pre", "_round_post", "_flush_pre"):
        body = getattr(sd._WindowRound, name)

        def guarded(self, *a, _body=body, **kw):
            with host_reads_raise():
                return _body(self, *a, **kw)
        monkeypatch.setattr(sd._WindowRound, name, guarded)
    for mesh, per_round in ((None, 1), (make_mesh((2, 1), devices=[torch.device("cpu")] * 2), 2)):
        sd.HOST_SYNCS = 0
        ms = sd.MultiStreamingSession(len(raws), chunk_bytes=CHUNK, collect_paths=spec,
                                      emit_capacity=1 << 13, mesh=mesh,
                                      device=None if mesh is not None else "cpu")
        feeds = rounds(raws)
        for pieces in feeds:
            ms.feed(pieces)
        ms.finalize()
        assert sd.HOST_SYNCS == per_round * (len(feeds) + 1)


@pytest.fixture(scope="module")
def sessions():
    return [synthetic_session_bytes(n_groups=g, frames_per_beam=2, baselines_per_group=4, seed=s)
            for s, g in enumerate((2, 3, 1, 4))]


BOUNDS = dict(max_groups=16, max_baselines_per_group=32)


def test_batch_program_is_cached_and_run_dataset_goes_through_it(sessions, monkeypatch):
    fn = batch.batched_session_pipeline(None, 1 << 14, device="cpu", **BOUNDS)
    assert batch.batched_session_pipeline(None, 1 << 14, device="cpu", **BOUNDS) is fn
    assert batch.batched_session_pipeline(None, 1 << 14, device="cpu", session_axis="scan",
                                          **BOUNDS) is not fn
    seen = []
    issue = batch._BatchedPipeline._issue
    monkeypatch.setattr(batch._BatchedPipeline, "_issue",
                        lambda self, *a: seen.append(self) or issue(self, *a))
    for _ in range(2):
        batch.run_dataset(None, sessions, quantum=1 << 12, device="cpu", **BOUNDS)
    buckets = sorted({batch.bucket_size(len(r), 1 << 12) for r in sessions})
    want = [batch.batched_session_pipeline(None, b, outputs="summary", device="cpu", **BOUNDS)
            for b in buckets]
    assert len(buckets) > 1 and seen == want + want


def test_flat_host_split_equals_field_copy_and_calls_share_nothing(sessions):
    """``run_dataset``'s split of a graph's flat output buffer (one copy,
    ``_read_back`` and ``_host_fields`` with its ``FlatOutputs``) against
    the per-field copy, bit for bit; two calls' outputs share no storage."""
    fn = batch.batched_session_pipeline(None, 1 << 14, outputs="summary", device="cpu", **BOUNDS)
    stacked = batch.stack_sessions(sessions, 1 << 14)
    out = fn(*stacked, batch.device_lut(torch.device("cpu")))
    layout = FlatOutputs()
    flat = layout.pack(out)
    got = batch._host_fields(batch._read_back(flat, layout), layout)
    want = batch._host_fields(batch._read_back(out, None), None)
    for f in batch.SessionSummaryOut._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), f
    a = batch.run_dataset(None, sessions, quantum=1 << 12, device="cpu", **BOUNDS)
    b = batch.run_dataset(None, sessions, quantum=1 << 12, device="cpu", **BOUNDS)
    for x, y in zip(a, b):
        for f in batch.SessionSummaryOut._fields:
            assert not np.shares_memory(getattr(x, f), getattr(y, f))
    again = fn(*stacked, batch.device_lut(torch.device("cpu")))
    for x, y in zip(out, again):
        assert x.untyped_storage().data_ptr() != y.untyped_storage().data_ptr()
