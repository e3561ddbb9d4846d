"""Port ``MultiStreamingSession`` == S independent port streams == JAX's.

Three seeded streams of planted multipath (uneven lengths, so some rounds
give a stream an empty piece) at 4 KiB windows with ``collect_paths``
(s_step 8, 2-degree grids) and a fixed emit ring, on the CPU (every kernel's
plain version):

  * against three independent ``DeviceStreamingSession``s of the same bytes,
    exactly: counts, running sums and cell counts, ``stream_filtered``,
    ``stream_paths``, ``stream_tracks`` and ``stream_track_columns``;
  * against the JAX package's ``MultiStreamingSession`` (CPU, no mesh) on the
    same bytes and spec (``convert.paths_spec_from_reference``): counts,
    sums, filtered rows equal; NN-OMP indices, ``n_iters`` and ``valid``
    equal, power within rtol 2e-4; tracks equal where the selections are;
  * a ragged finalize and a reset attaching a new feed, a mid-stream
    checkpoint resume, the errors, one host read per round;
  * the stream-axis plain versions of K1, K5 and K6 equal the single
    stream's per stream, and the flattened K4 call (sweep ids offset by ``s
    * s1``) equals S separate calls.
"""

import numpy as np
import pytest
import torch

from slam_process_tpu_torch.ops import compact, decode, scene, tracker
from slam_process_tpu_torch.parallel import streaming_device as sd
from slam_process_tpu_torch.parallel.mesh import make_mesh
from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, write_angle_table
from test_torch_streaming import assert_same_paths

SESSIONS = [dict(n_groups=5, frames_per_beam=4, baselines_per_group=5, junk_frac=0.05, seed=21,
                 n_paths=3),
            dict(n_groups=3, frames_per_beam=5, baselines_per_group=4, junk_frac=0.1, seed=22,
                 n_paths=3),
            dict(n_groups=6, frames_per_beam=3, baselines_per_group=6, seed=23, n_paths=3)]
CHUNK = 1 << 12
STEP = 6000            # bytes per feed call and stream: two windows
ECAP = 1 << 13
EST = dict(grid_res=2.0)


@pytest.fixture(scope="module")
def raws():
    return [synthetic_session_bytes(**c) for c in SESSIONS]


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    """(JAX spec, the port's spec converted from it)."""
    from slam_process_tpu.parallel import streaming_device as jsd
    from slam_process_tpu_torch.convert import paths_spec_from_reference

    angles = write_angle_table(tmp_path_factory.mktemp("multi") / "beam_angle.xlsx")
    jspec = jsd.make_paths_spec(angles, s_step=8, **EST)
    return jspec, paths_spec_from_reference(*jspec, device="cpu")


def feed_all(ms, raws, step=STEP, start=0):
    for off in range(start, max(len(r) for r in raws), step):
        ms.feed([r[off:off + step] for r in raws])


def multi(spec, **kw):
    return sd.MultiStreamingSession(len(SESSIONS), chunk_bytes=CHUNK, collect_paths=spec,
                                    emit_capacity=ECAP, device="cpu", **kw)


def single(raw, spec):
    s = sd.DeviceStreamingSession(chunk_bytes=CHUNK, collect_paths=spec, collect_filtered=True,
                                  emit_capacity=ECAP, device="cpu")
    for off in range(0, len(raw), STEP):
        s.feed(raw[off:off + STEP])
    s.finalize()
    return s


@pytest.fixture(scope="module")
def port_multi(raws, specs):
    ms = multi(specs[1])
    feed_all(ms, raws)
    ms.finalize()
    return ms


@pytest.fixture(scope="module")
def singles(raws, specs):
    return [single(r, specs[1]) for r in raws]


def multi_readers(ms, i):
    return ms.stream_paths(i), ms.stream_tracks(i)[1], ms.stream_tracks(i)


def single_readers(s):
    return s.sweep_paths(), s.sweep_times(), s.path_tracks()


def assert_stream_equals_single(ms, i, s):
    nf, nk, ng, sums, counts, ovf = ms.results()
    assert not ovf[i]
    assert (nf[i], nk[i], ng[i]) == (s.n_frames, s.n_kept, s.n_groups)
    np.testing.assert_array_equal(sums[i], s._state.sums.numpy())
    np.testing.assert_array_equal(counts[i], s._state.counts.numpy())
    np.testing.assert_array_equal(ms.stream_filtered(i), s.filtered)
    assert_same_paths(multi_readers(ms, i), single_readers(s))
    n = s.n_sweeps_closed
    assert ms.n_sweeps_closed_all()[i] == n
    for got, want in zip(ms.stream_track_columns(i, 1, n), s.track_columns(1, n)):
        np.testing.assert_array_equal(got, want)


def test_multi_stream_equals_independent_sessions(port_multi, singles):
    assert port_multi.results()[0].dtype == np.int32
    for i, s in enumerate(singles):
        assert s.n_sweeps_closed >= 2 and s.path_tracks()[0].n_tracks > 0
        assert_stream_equals_single(port_multi, i, s)


@pytest.fixture(scope="module")
def jax_multi(raws, specs):
    """JAX's vmapped multi-stream session on the same bytes (no mesh)."""
    from slam_process_tpu.parallel import streaming_device as jsd

    ms = jsd.MultiStreamingSession(len(SESSIONS), chunk_bytes=CHUNK, collect_paths=specs[0],
                                   emit_capacity=ECAP)
    feed_all(ms, raws)
    ms.finalize()
    return ms


def test_multi_stream_matches_jax(port_multi, jax_multi):
    got, want = port_multi.results(), jax_multi.results()
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    # JAX's float32 sums are exact below 2^24 per cell, as here.
    assert got[3].max() < 2 ** 24
    np.testing.assert_array_equal(got[3], np.asarray(want[3]).astype(np.int64))
    np.testing.assert_array_equal(got[4], np.asarray(want[4]))
    assert not got[5].any() and not np.asarray(want[5]).any()
    np.testing.assert_array_equal(port_multi.n_sweeps_closed_all(),
                                  jax_multi.n_sweeps_closed_all())
    for i in range(len(SESSIONS)):
        np.testing.assert_array_equal(port_multi.stream_filtered(i), jax_multi.stream_filtered(i))
        assert_same_paths(multi_readers(port_multi, i), multi_readers(jax_multi, i),
                          exact=False)


def test_ragged_finalize_and_reset_attach_a_new_feed(raws, specs, singles):
    """Stream 0 ends early and is finalized alone while the others go on;
    then its slot takes a new feed (stream 2's bytes); every stream equals
    its independent session, the first tenant's results read before the
    reset too."""
    ms = multi(specs[1])
    first = raws[0][:2 * STEP]
    with pytest.raises(RuntimeError, match="still live"):
        ms.reset_streams([0])
    for off in range(0, len(first), STEP):
        ms.feed([first[off:off + STEP], raws[1][off:off + STEP], raws[2][off:off + STEP]])
    ms.finalize_streams([0])
    with pytest.raises(RuntimeError, match="stream 0 already finalized"):
        ms.feed([b"x", b"", b""])
    with pytest.raises(RuntimeError, match="already finalized"):
        ms.finalize_streams([0])
    with pytest.raises(ValueError, match="out of range"):
        ms.finalize_streams([3])
    ref_first = single(first, specs[1])
    assert_stream_equals_single(ms, 0, ref_first)

    ms.reset_streams([0])
    new = raws[2]
    off = len(first)
    for j in range(0, max(len(new), len(raws[1]) - off, len(raws[2]) - off), STEP):
        ms.feed([new[j:j + STEP], raws[1][off + j:off + j + STEP],
                 raws[2][off + j:off + j + STEP]])
    ms.finalize()
    assert_stream_equals_single(ms, 0, singles[2])
    assert_stream_equals_single(ms, 1, singles[1])
    assert_stream_equals_single(ms, 2, singles[2])


def test_checkpoint_resume_equals_uninterrupted(raws, specs, port_multi, tmp_path):
    ms = multi(specs[1])
    feed_all(ms, [r[:2 * STEP] for r in raws])
    ms.finalize_streams([1])
    ms.save_checkpoint(tmp_path / "multi.npz", extra={"cursor": 7})
    back = sd.MultiStreamingSession.restore(tmp_path / "multi.npz", device="cpu")
    assert back.checkpoint_extra == {"cursor": 7}
    assert back._stream_finalized.tolist() == [False, True, False]
    rest = [raws[0], np.zeros(0, np.uint8), raws[2]]
    feed_all(back, rest, start=2 * STEP)
    back.finalize()
    ref = multi(specs[1])
    feed_all(ref, [r[:2 * STEP] for r in raws])
    ref.finalize_streams([1])
    feed_all(ref, rest, start=2 * STEP)
    ref.finalize()
    for a, b in zip(sd._leaves(back._state), sd._leaves(ref._state)):
        assert torch.equal(a, b)
    for i in (0, 2):
        np.testing.assert_array_equal(back.stream_filtered(i), port_multi.stream_filtered(i))
        assert_same_paths(multi_readers(back, i), multi_readers(port_multi, i))
    s = sd.DeviceStreamingSession(device="cpu")
    s.save_checkpoint(tmp_path / "single.npz")
    with pytest.raises(ValueError, match="not a MultiStreamingSession checkpoint"):
        sd.MultiStreamingSession.restore(tmp_path / "single.npz", device="cpu")


def test_errors(raws, specs):
    ms = multi(None)
    with pytest.raises(ValueError, match="expected 3 chunks"):
        ms.feed([b"", b""])
    with pytest.raises(ValueError, match="built without collect_paths"):
        ms.stream_paths(0)
    with pytest.raises(ValueError, match="pass mesh= or device=, not both"):
        sd.MultiStreamingSession(2, mesh=make_mesh((1, 1), devices=["cpu"]), device="cpu")
    with pytest.raises(ValueError, match="emit_capacity=0"):
        sd.MultiStreamingSession(2, device="cpu").stream_filtered(0)
    # A ring of 64 rows overflows on every stream; counts stay exact.
    small = sd.MultiStreamingSession(3, chunk_bytes=CHUNK, emit_capacity=64, device="cpu")
    feed_all(small, raws)
    small.finalize()
    with pytest.raises(RuntimeError, match="emit ring overflowed on stream 1"):
        small.stream_filtered(1)
    full = multi(None)
    feed_all(full, raws)
    full.finalize()
    np.testing.assert_array_equal(small.results()[1], full.results()[1])
    with pytest.raises(RuntimeError, match="session already finalized"):
        full.feed([b"", b"", b""])


def test_one_host_read_per_round(raws, specs, monkeypatch):
    """With ``collect_paths`` a round reads the S closed-sweep counts once,
    and each flush once; the NNLS solver's own syncs are counted apart."""
    rounds = []
    step = sd.MultiStreamingSession._window
    monkeypatch.setattr(sd.MultiStreamingSession, "_window",
                        lambda self, *a: rounds.append(1) or step(self, *a))
    sd.HOST_SYNCS = 0
    ms = multi(specs[1])
    feed_all(ms, raws)
    ms.finalize_streams([0])
    ms.finalize()
    assert len(rounds) >= 5 and sd.HOST_SYNCS == len(rounds) + 2


def test_stream_axis_plain_versions_equal_per_stream():
    """K1, K5 and K6's stream-axis plain versions (what runs on the CPU)
    against the single stream's plain version per stream; K4's flattened
    call against S separate calls."""
    rng = np.random.default_rng(5)
    # K1: three byte streams of one width, each with its own n_valid.
    streams = [synthetic_session_bytes(n_groups=2, frames_per_beam=1, baselines_per_group=2,
                                       junk_frac=0.3, seed=s) for s in range(3)]
    width = max(len(r) for r in streams) + 5
    b = torch.zeros((3, width), dtype=torch.uint8)
    for i, r in enumerate(streams):
        b[i, :len(r)] = torch.from_numpy(r)
    n_valid = torch.tensor([len(streams[0]), len(streams[1]) - 20, 11], dtype=torch.int64)
    rows, valid, count = decode.decode_rows_streams(b, n_valid=n_valid)
    for i in range(3):
        want = decode.decode_rows_plain(b[i], n_valid=int(n_valid[i]))
        for g, w in zip((rows[i], valid[i], count[i]), want):
            assert torch.equal(g, w)
    assert count.tolist()[2] == 0 and int(count[0]) > 0

    # K5: the carry form and the emit-ring + fresh-buffer form.
    rows5 = torch.from_numpy(rng.integers(0, 99, (3, 700, 4)).astype(np.int32))
    mask = torch.from_numpy(rng.random((3, 700)) < 0.4)
    ring = torch.from_numpy(rng.integers(0, 9, (3, 500, 4)).astype(np.int32))
    offs = torch.tensor([0, 250, 480], dtype=torch.int32)
    outs, n = compact.compact_rows_streams(rows5, mask, [(500, ring.clone(), offs), (700, None,
                                                                                      None)])
    for i in range(3):
        w_ring, w_n = compact.compact_rows_plain(rows5[i], mask[i], 500, ring[i].clone(), offs[i])
        w_fresh, _ = compact.compact_rows_plain(rows5[i], mask[i], 700)
        assert torch.equal(outs[0][i], w_ring) and torch.equal(outs[1][i], w_fresh)
        assert int(n[i]) == int(w_n)

    # K6: three trackers from different carries, m_eff 0, 5 and past s1.
    s1, k_n, t_n = 6, 3, 8
    f32 = lambda *shape: torch.from_numpy(rng.normal(0, 15, shape).astype(np.float32))
    lanes = (f32(3, s1, k_n), f32(3, s1, k_n), f32(3, s1, k_n).abs(),
             torch.from_numpy(rng.random((3, s1, k_n)) < 0.7))
    m_eff = torch.tensor([0, 5, s1 + 2], dtype=torch.int32)
    count6 = torch.tensor([0, 3, 8], dtype=torch.int32)
    created = torch.arange(t_n)[None] < count6[:, None]
    pos = f32(3, t_n, 2)
    got = tracker.track_block_streams(*lanes, m_eff, pos, created, count6, 10.0)
    for i in range(3):
        want = tracker.track_block_plain(*(x[i] for x in lanes), m_eff[i], pos[i], created[i],
                                         count6[i], 10.0)
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)

    # K4 flattened: sweep ids offset by s * s1 and max_sweeps S * s1.
    s1 = 9
    f = 900
    ue, bs = (torch.from_numpy(rng.integers(-1, 65, (3, f)).astype(np.int32)) for _ in range(2))
    rss = torch.from_numpy(rng.integers(0, 1 << 18, (3, f)).astype(np.int32))
    ls = torch.from_numpy(np.sort(rng.integers(0, s1 + 2, (3, f)), axis=1).astype(np.int32))
    use = torch.from_numpy(rng.random((3, f)) < 0.9) & (ls < s1)
    gid = ls + (torch.arange(3, dtype=torch.int32) * s1)[:, None]
    sums, counts = scene.intensity_per_sweep_sums(ue.flatten(), bs.flatten(), rss.flatten(),
                                                  gid.flatten(), use.flatten(), 3 * s1)
    for i in range(3):
        w_s, w_c = scene.intensity_per_sweep_sums(ue[i], bs[i], rss[i], ls[i], use[i], s1)
        assert torch.equal(sums[i * s1:(i + 1) * s1], w_s)
        assert torch.equal(counts[i * s1:(i + 1) * s1], w_c)
    assert float(counts.sum()) > 0
