"""The port's multi-host layer (``parallel/multihost.py``) in two real gloo
processes on the CPU, against the port's single-process runs and the JAX
package.

Each check spawns two processes (``multihost.run_local_cluster``: each has
a 120 s limit, and a process past it is killed with its peer), two mesh
positions each:

  * ``run_batched_multihost`` (four sessions, model = 2): each process's
    rows equal the port's single-process batch of the same bytes bit for
    bit, and JAX's batch under ``test_torch_pipeline.py``'s contract;
  * ``estimate_sessions_multihost`` (v1-7, grid 0.5, model = 2): equal to
    the port's ``estimate_sessions`` of all four sessions exactly, and to
    JAX's under ``test_torch_estimate.py``'s contract;
  * ``MultihostMultiStream`` (three streams split 2 / 1, a ragged
    ``finalize_streams``): each local stream equals the port's
    single-process ``MultiStreamingSession`` on the same schedule exactly,
    and JAX's under ``test_torch_multi_stream.py``'s contract;
  * ``cli watch --coordinator`` on three finished captures split 2 / 1,
    with and without ``--events``, ended by SIGINT to both processes once
    each has read its captures to the end (an explicit end, not an idle
    timeout): each capture's filtered, track and change tables and events
    equal a single-process replay's exactly, and the JAX CLI's
    single-process ``watch --logs`` under ``test_torch_watch.py``'s
    contract;
  * the dry-run worker, against the port's and JAX's single-process
    session of the same bytes (the port's stream maker is JAX's byte for
    byte); a peer that never arrives raises at the timeout.

JAX's references run unsharded in this process: its tier-1 tests run no
sharded multi-stream session, and they hold the sharded one equal to it.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_multihost_worker as worker
from slam_process_tpu_torch.parallel import batch
from slam_process_tpu_torch.parallel import streaming_device as sd
from slam_process_tpu_torch.parallel.multihost import run_local_cluster
from slam_process_tpu_torch.utils.synthetic import (
    synthetic_session_bytes, to_hex_text, write_angle_table)

REPO = Path(__file__).resolve().parent.parent
WORKER = str(Path(worker.__file__).resolve())
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def angles(tmp_path_factory):
    return write_angle_table(tmp_path_factory.mktemp("multihost") / "beam_angle.xlsx")


def run_pair(mode, tmp_path, angles):
    """Both processes of ``mode``; their npz results in process order."""
    outs = [tmp_path / f"{mode}_{k}.npz" for k in range(2)]
    res = run_local_cluster(lambda coord: [[sys.executable, WORKER, mode, str(k), "2", coord,
                                            str(outs[k]), str(angles)] for k in range(2)],
                            TIMEOUT_S, cwd=str(REPO))
    for rc, _, err in res:
        assert rc == 0, err[-3000:]
    return [dict(np.load(p)) for p in outs]


def test_two_process_run_batched_multihost(tmp_path, angles):
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.ops.raster import colormap_lut as jax_lut
    from slam_process_tpu.parallel.batch import batched_session_pipeline as jax_pipeline
    from slam_process_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from slam_process_tpu_torch.ops.raster import colormap_lut

    got = run_pair("batched", tmp_path, angles)
    raws = [synthetic_session_bytes(**c) for c in worker.BATCH]
    n = max(len(r) for r in raws)
    stacked = batch.stack_sessions(raws, n)
    want = batch.batched_session_pipeline(None, n, outputs="summary", device="cpu",
                                          **worker.BOUNDS)(*stacked, colormap_lut("viridis"))
    jax_out = jax.device_get(jax_pipeline(jax_make_mesh((1, 1)), n, outputs="summary",
                                          **worker.BOUNDS)(
        jnp.asarray(stacked[0]), jnp.asarray(stacked[1]), jnp.asarray(jax_lut("viridis"))))
    for pid, res in enumerate(got):
        rows = slice(2 * pid, 2 * pid + 2)
        for f in batch.SessionSummaryOut._fields:
            w = getattr(want, f)[rows].numpy()
            assert res[f].dtype == w.dtype and res[f].tobytes() == w.tobytes(), (pid, f)
            j = np.asarray(getattr(jax_out, f))[rows]
            if f in ("n_frames", "correct_overflow", "n_kept", "counts", "mean_grid"):
                np.testing.assert_array_equal(res[f], j, err_msg=f)
        t, w_t = res["norm_t"], np.asarray(jax_out.norm_t)[rows]
        fin = np.isfinite(w_t)
        assert (np.isfinite(t) == fin).all()
        np.testing.assert_allclose(t[fin], w_t[fin], atol=1e-3)
        assert int(res["n_kept"].min()) > 0


def test_two_process_estimate_sessions_multihost(tmp_path, angles):
    from slam_process_tpu.models import batch_estimation as jax_batch
    from slam_process_tpu.pipeline.session import Session as JaxSession
    from slam_process_tpu_torch.models.batch_estimation import estimate_sessions
    from test_torch_estimate import assert_same_paths

    got = run_pair("estimate", tmp_path, angles)
    sessions = [worker.session_from_bytes(synthetic_session_bytes(**c), tmp_path / f"s{k}.txt")
                for k, c in enumerate(worker.ESTIMATE)]
    want = estimate_sessions(sessions, angles, device="cpu", grid_res=0.5)
    jax_sessions = []
    for s in sessions:
        js = JaxSession(name=s.name)
        js.filtered = s.filtered.copy()
        jax_sessions.append(js)
    jax_want = jax_batch.estimate_sessions(jax_sessions, angles, grid_res=0.5)
    for pid, res in enumerate(got):
        for k in range(2):
            i = 2 * pid + k
            for f in want[i]._fields:
                w = np.asarray(getattr(want[i], f))
                assert res[f][k].dtype == w.dtype and res[f][k].tobytes() == w.tobytes(), (i, f)
            mine = type(want[i])(*(res[f][k] for f in want[i]._fields))
            assert_same_paths(mine, jax_want[i], f"session {i} vs JAX")


def stream_reference(angles):
    """The port's single-process MultiStreamingSession of the three streams
    on the workers' schedule."""
    raws = [synthetic_session_bytes(**c) for c in worker.STREAMS]
    ms = sd.MultiStreamingSession(len(raws), chunk_bytes=worker.CHUNK,
                                  collect_paths=sd.make_paths_spec(angles, **worker.SPEC),
                                  emit_capacity=worker.ECAP, device="cpu")
    for chunks, ended in worker.stream_rounds(raws):
        ms.feed(chunks)
        if ended:
            ms.finalize_streams(ended)
    ms.finalize()
    return ms


@pytest.fixture(scope="module")
def jax_stream_reference(angles):
    """JAX's single-process MultiStreamingSession on the same schedule."""
    from slam_process_tpu.parallel import streaming_device as jsd

    raws = [synthetic_session_bytes(**c) for c in worker.STREAMS]
    ms = jsd.MultiStreamingSession(len(raws), chunk_bytes=worker.CHUNK,
                                   collect_paths=jsd.make_paths_spec(angles, **worker.SPEC),
                                   emit_capacity=worker.ECAP)
    for chunks, ended in worker.stream_rounds(raws):
        ms.feed(chunks)
        if ended:
            ms.finalize_streams(ended)
    ms.finalize()
    return ms


def worker_readers(res, k, paths_type):
    """A worker's local stream ``k`` as (sweep_paths, times, path_tracks)
    readers (``test_torch_streaming.assert_same_paths``)."""
    from types import SimpleNamespace

    paths = paths_type(*(res[f"paths_{k}_{f}"] for f in paths_type._fields))
    tracks = SimpleNamespace(**{f: res[f"tracks_{k}_{f}"] for f in (
        "pos_aoa", "pos_aod", "power", "observed", "created", "n_tracks")})
    times = res[f"times_{k}"]
    return (paths, res[f"valid_{k}"]), times, (tracks, times,
                                               tuple(res[f"vel_{k}_{j}"] for j in range(3)))


def test_two_process_multihost_multistream(tmp_path, angles, jax_stream_reference):
    from test_torch_streaming import assert_same_paths

    got = run_pair("stream", tmp_path, angles)
    jax_ref = jax_stream_reference
    jax_results = jax_ref.results()
    ref = stream_reference(angles)
    results = ref.results()
    closed = ref.n_sweeps_closed_all()
    assert closed.min() >= 2
    for pid, res in enumerate(got):
        for k, i in enumerate(worker.STREAM_SPLIT[pid]):
            for j, name in enumerate(("n_frames", "n_kept", "n_groups", "sums", "counts",
                                      "overflow")):
                np.testing.assert_array_equal(res[name][k], results[j][i], err_msg=name)
            assert res["n_closed"][k] == closed[i]
            np.testing.assert_array_equal(res[f"filtered_{k}"], ref.stream_filtered(i))
            paths, valid = ref.stream_paths(i)
            np.testing.assert_array_equal(res[f"valid_{k}"], valid)
            for f in paths._fields:
                w = np.asarray(getattr(paths, f))
                assert res[f"paths_{k}_{f}"].tobytes() == w.tobytes(), f
            tracks, times, _ = ref.stream_tracks(i)
            np.testing.assert_array_equal(res[f"times_{k}"], times)
            for f in ("pos_aoa", "pos_aod", "power", "observed", "created"):
                np.testing.assert_array_equal(res[f"tracks_{k}_{f}"], getattr(tracks, f))
            # JAX's: integer results equal (its float32 sums are exact
            # integers here), NN-OMP power and velocities within the contract.
            for j in (0, 1, 2, 4):
                np.testing.assert_array_equal(res[("n_frames", "n_kept", "n_groups", "sums",
                                                   "counts")[j]][k], jax_results[j][i])
            np.testing.assert_array_equal(res["sums"][k],
                                          np.asarray(jax_results[3][i]).astype(np.int64))
            assert res["n_closed"][k] == jax_ref.n_sweeps_closed_all()[i]
            np.testing.assert_array_equal(res[f"filtered_{k}"], jax_ref.stream_filtered(i))
            assert_same_paths(worker_readers(res, k, type(paths)),
                              (jax_ref.stream_paths(i), jax_ref.stream_tracks(i)[1],
                               jax_ref.stream_tracks(i)), exact=False)
        assert len(res["n_frames"]) == len(worker.STREAM_SPLIT[pid])


WATCH = [dict(n_groups=g, frames_per_beam=2, baselines_per_group=3, seed=s, n_paths=3)
         for g, s in zip((3, 4, 3), (90, 91, 92))]
CHANGES = ["--changes", "--min-persist", "1", "--min-gone", "1", "--jump-deg", "1"]


def read_xlsx(path):
    from slam_process_tpu_torch.io.xlsx import read_xlsx_table

    return read_xlsx_table(path)


@pytest.fixture(scope="module")
def watch_captures(tmp_path_factory):
    """Three finished captures, each ``live.txt`` in a directory of its own."""
    d = tmp_path_factory.mktemp("watch_captures")
    logs = []
    for i, kw in enumerate(WATCH):
        p = d / f"cap{i}" / "live.txt"
        p.parent.mkdir()
        p.write_bytes(to_hex_text(synthetic_session_bytes(**kw)))
        logs.append(p)
    return logs


@pytest.fixture(scope="module")
def jax_watch(watch_captures, angles, tmp_path_factory):
    """The JAX CLI's single-process ``watch --logs`` of the three finished
    captures (exports ``live``, ``live_1``, ``live_2``)."""
    import contextlib
    import io

    from slam_process_tpu.pipeline import cli as jax_cli

    d = tmp_path_factory.mktemp("jax_watch")
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_cli.main(["watch", "--logs", *map(str, watch_captures), "--mapping",
                             str(angles), "--outdir", str(d / "out"), "--poll-interval",
                             "0.05", "--idle-timeout", "1.0", "--engine", "device", "--paths",
                             *CHANGES, "--events", str(d / "events.jsonl")]) == 0
    return d


@pytest.mark.parametrize("events", [False, True], ids=["no_events", "events"])
def test_two_process_cli_watch(tmp_path, angles, watch_captures, jax_watch, events):
    from types import SimpleNamespace

    from slam_process_tpu_torch.io.hexlog import tokenize_hex
    from slam_process_tpu_torch.pipeline import cli
    from test_torch_cli import assert_tables_close, assert_xlsx_equal
    from test_torch_watch import assert_events_close

    logs = watch_captures
    split = (logs[:2], logs[2:])
    out = tmp_path / "out"

    def argv(k, coord):
        extra = ["--events", str(tmp_path / f"events_{k}.jsonl")] if events else []
        return [sys.executable, "-m", "slam_process_tpu_torch.pipeline.cli", "watch", "--logs",
                *map(str, split[k]), "--mapping", str(angles), "--outdir", str(out),
                "--coordinator", coord, "--num-processes", "2", "--process-id",
                str(k), "--local-devices", "2", "--device", "cpu", "--idle-timeout", "0",
                "--poll-interval", "0.05", "--paths", *CHANGES, *extra]

    res = run_local_cluster(lambda coord: [argv(0, coord), argv(1, coord)], TIMEOUT_S,
                            cwd=str(REPO), interrupt_when=cli.WATCH_CAUGHT_UP)
    for rc, _, err in res:
        assert rc == 0, err[-3000:]
    lines = [[json.loads(ln) for ln in r[1].splitlines() if ln.startswith("{")] for r in res]
    assert lines[0][-1]["global_streams"] == 3 and lines[1][-1]["local_streams"] == 1

    # The single-process reference: each finished capture replayed whole.
    spec = sd.make_paths_spec(angles)
    ms = sd.MultiStreamingSession(3, collect_paths=spec, emit_capacity=1 << 18, device="cpu")
    ms.feed([tokenize_hex(p.read_bytes()) for p in logs])
    ms.finalize()
    names = [["p0_live", "p0_live_1"], ["p1_live"]]
    flat = [n for ns in names for n in ns]
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    args = SimpleNamespace(outdir=ref_dir, changes=True, min_persist=1, min_gone=1, jump_deg=1.0)
    nf = ms.results()[0]
    for i, name in enumerate(flat):
        cli._export_tracks(*ms.stream_tracks(i), name, args)
        rows = read_xlsx(out / f"{name}_filtered.xlsx")
        np.testing.assert_array_equal(np.asarray(rows[1], np.int64), ms.stream_filtered(i))
        for kind in ("stream_tracks", "stream_changes"):
            a, b = read_xlsx(out / f"{name}_{kind}.xlsx"), read_xlsx(ref_dir / f"{name}_{kind}.xlsx")
            assert a[0] == b[0]
            np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]), err_msg=kind)
    for pid in range(2):
        for line, name in zip(lines[pid], names[pid]):
            assert line["session"] == name and line["process"] == pid
            assert line["frames"] == int(nf[flat.index(name)])
            assert line["bytes_seen"] == logs[flat.index(name)].stat().st_size
    # JAX's single-process watch: the filtered tables byte for byte, the
    # track and change tables within the NN-OMP power contract.
    jax_names = dict(zip(flat, ["live", "live_1", "live_2"]))
    for name, jname in jax_names.items():
        assert_xlsx_equal(out / f"{name}_filtered.xlsx",
                          jax_watch / "out" / f"{jname}_filtered.xlsx")
        assert_tables_close(out / f"{name}_stream_tracks.xlsx",
                            jax_watch / "out" / f"{jname}_stream_tracks.xlsx",
                            {"Track", "Sweep", "CLK"})
        assert_tables_close(out / f"{name}_stream_changes.xlsx",
                            jax_watch / "out" / f"{jname}_stream_changes.xlsx",
                            {"Sweep", "CLK", "Kind", "Track"})
    if events:
        jax_events = [json.loads(ln) for ln in
                      (jax_watch / "events.jsonl").read_text().splitlines()]
        got = [json.loads(ln) for pid in range(2)
               for ln in (tmp_path / f"events_{pid}.jsonl").read_text().splitlines()]
        for name, jname in jax_names.items():
            mine = [{**e, "session": jname} for e in got if e["session"] == name]
            assert_events_close(mine, [e for e in jax_events if e["session"] == jname])
    if events:
        args = SimpleNamespace(events=tmp_path / "ref_events.jsonl", min_persist=1, min_gone=1,
                               jump_deg=1.0)
        emit = cli._make_multi_event_emitter(args, ms, flat)
        assert emit() > 0
        want = [json.loads(ln) for ln in args.events.read_text().splitlines()]
        got = [json.loads(ln) for pid in range(2)
               for ln in (tmp_path / f"events_{pid}.jsonl").read_text().splitlines()]
        for name in flat:
            assert [e for e in got if e["session"] == name] == \
                [e for e in want if e["session"] == name], name
        assert lines[0][-1]["events"] + lines[1][-1]["events"] == len(want)


def test_dryrun_worker_two_processes():
    from slam_process_tpu.parallel import _dryrun_worker as jax_dry
    from slam_process_tpu.parallel import streaming_device as jsd
    from slam_process_tpu_torch.parallel import _dryrun_worker as dry

    res = run_local_cluster(
        lambda coord: [[sys.executable, "-m", "slam_process_tpu_torch.parallel._dryrun_worker",
                        str(k), "2", coord, "cpu"] for k in range(2)], TIMEOUT_S, cwd=str(REPO))
    streams = [dry.synthetic_stream_bytes(180, seed=10 * pid + i)
               for pid in range(2) for i in range(2)]
    assert streams == [jax_dry.synthetic_stream_bytes(180, seed=10 * pid + i)
                       for pid in range(2) for i in range(2)]
    want = []
    for make in (lambda **kw: sd.MultiStreamingSession(4, device="cpu", **kw),
                 lambda **kw: jsd.MultiStreamingSession(4, **kw)):
        ms = make(chunk_bytes=4096, group_capacity=1024, max_groups=8,
                  max_baselines_per_group=16)
        half = len(streams[0]) // 2
        ms.feed([s[:half] for s in streams])
        ms.feed([s[half:] for s in streams])
        ms.finalize()
        nf, _, ng, _, _, _ = ms.results()
        want.append((np.asarray(nf), np.asarray(ng)))
    for pid, (rc, out, err) in enumerate(res):
        assert rc == 0, err[-3000:]
        line = json.loads(out.strip().splitlines()[-1])
        assert line["ok"] and line["pid"] == pid
        for nf, ng in want:     # the port's single process, then JAX's
            assert line["n_frames"] == nf[2 * pid:2 * pid + 2].tolist()
            assert line["n_groups"] == ng[2 * pid:2 * pid + 2].tolist()


def test_a_peer_that_never_arrives_raises(tmp_path, angles):
    (rc, _, err), = run_local_cluster(
        lambda coord: [[sys.executable, WORKER, "lonely", "0", "2", coord,
                        str(tmp_path / "x.npz"), str(angles)]], TIMEOUT_S, cwd=str(REPO))
    assert rc != 0 and "Timed out" in err
    assert not (tmp_path / "x.npz").exists()


def test_cluster_launcher_kills_peers_on_timeout():
    with pytest.raises(TimeoutError, match="still running after 1"):
        run_local_cluster(lambda coord: [[sys.executable, "-c", "import time; time.sleep(60)"]] * 2,
                          1)


def test_free_ports_are_never_handed_out_twice():
    from slam_process_tpu_torch.parallel.multihost import free_port

    ports = [free_port() for _ in range(64)]
    assert len(set(ports)) == len(ports)


JOIN = ("import sys; from slam_process_tpu_torch.parallel import multihost as mh; "
        "mh.initialize_multihost(sys.argv[1], 2, int(sys.argv[2]), device='cpu', timeout_s=30); "
        "mh.shutdown_multihost(); print('joined')")


def test_a_taken_port_reruns_the_cluster_on_another(monkeypatch):
    """Another program holds the first port picked: process 0 cannot listen,
    its peer is killed, and the cluster runs again on a fresh port."""
    import socket

    from slam_process_tpu_torch.parallel import multihost

    taken = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    taken.bind(("127.0.0.1", 0))
    taken.listen()
    picks = [taken.getsockname()[1]]
    real = multihost.free_port
    monkeypatch.setattr(multihost, "free_port",
                        lambda: picks.pop(0) if picks else real())
    coords = []

    def argvs(coord):
        coords.append(coord)
        return [[sys.executable, "-c", JOIN, coord, str(k)] for k in range(2)]

    try:
        res = multihost.run_local_cluster(argvs, TIMEOUT_S, cwd=str(REPO))
    finally:
        taken.close()
    assert len(coords) == 2 and coords[0] != coords[1]
    assert [(rc, out.strip()) for rc, out, _ in res] == [(0, "joined")] * 2


@pytest.mark.parametrize("when", ["before_the_first_read", "after_reading_to_the_end"])
def test_watch_interrupt_finalizes_with_the_carry_alone(tmp_path, angles, when, monkeypatch):
    """SIGINT's tick reads nothing more and finalizes every live capture
    with its text carry, as the JAX package's multi-host watch does: an
    interrupt before the first read leaves the streams empty, one after
    the captures were read to the end gives their whole-file replay.  One
    process (a cluster of one), in this process."""
    import time

    from slam_process_tpu_torch.io.hexlog import tokenize_hex
    from slam_process_tpu_torch.parallel.multihost import free_port
    from slam_process_tpu_torch.pipeline import cli

    logs = []
    for i, kw in enumerate(WATCH[:2]):
        logs.append(tmp_path / f"cap{i}.txt")
        # A last token cut short: it waits in the text carry until the end.
        logs[-1].write_bytes(to_hex_text(synthetic_session_bytes(**kw)) + b"3")
    args = cli.build_parser().parse_args(
        ["watch", "--logs", *map(str, logs), "--mapping", str(angles), "--outdir",
         str(tmp_path / "out"), "--coordinator", f"127.0.0.1:{free_port()}",
         "--num-processes", "1", "--process-id", "0", "--device", "cpu", "--idle-timeout",
         "0", "--poll-interval", "0"])
    cli.check_watch_flags(args)
    w = cli.MultihostWatch(args)
    try:
        if when == "before_the_first_read":
            w.interrupted = True
        else:   # the SIGINT lands in the poll interval after the first tick
            monkeypatch.setattr(time, "sleep", lambda s: setattr(w, "interrupted", True))
        w.run()
        nf = w.session.local_results()[0]
        filtered = [w.session.local_stream_filtered(i) for i in range(2)]
    finally:
        monkeypatch.undo()
        w.close()
    if when == "before_the_first_read":
        assert w.pos == [0, 0] and nf.tolist() == [0, 0]
        assert all(len(f) == 0 for f in filtered)
        return
    ms = sd.MultiStreamingSession(2, emit_capacity=1 << 18, device="cpu")
    ms.feed([tokenize_hex(p.read_bytes()) for p in logs])
    ms.finalize()
    assert w.pos == [p.stat().st_size for p in logs]
    np.testing.assert_array_equal(nf, ms.results()[0])
    for i in range(2):
        np.testing.assert_array_equal(filtered[i], ms.stream_filtered(i))
