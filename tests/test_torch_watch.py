"""``watch`` of the port's CLI on a growing file against the JAX CLI's
``watch --engine host`` on the finished file, in process.

The outputs of a watch depend only on the bytes, not on when they arrive,
so a writer thread grows the capture in seeded random pieces (some cut in
the middle of a hex token) while the port's watch polls it every 0.05 s
(idle timeout 1 s), and the JAX CLI watches the finished file once:

  * the ``--events`` JSONL: line for line the same keys in the same order,
    power within rtol 2e-4, everything else equal;
  * ``<name>_filtered.xlsx`` byte for byte (sheet and workbook XML), the
    track and change tables with integer columns equal and the rest within
    rtol 2e-4, the summary line equal apart from the PNG's directory;
  * resume: a copy of a mid-stream checkpoint and of the events file at that
    moment, its last line torn in half, resumed by a second watch on the
    finished file, gives the same tables and events, no event twice;
  * a completed checkpoint re-exports; the other engine's checkpoint is
    refused; the flag checks exit with the JAX CLI's messages, the
    multi-host watch's among them;
  * ``watch --logs A B`` (one multi-stream session): the port's watch of a
    complete capture A and a capture B that a writer thread grows, so A
    idles out and is finalized alone while B goes on, against the JAX CLI's
    ``watch --logs A B --engine device`` on the finished files: each
    stream's filtered, track and change tables as above, the one events
    JSONL line for line within each session (the streams' lines interleave
    as the polls found them), the summary lines; and a resume from a
    mid-stream checkpoint of the multi watch.
"""

import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from slam_process_tpu.pipeline import cli as jax_cli
from slam_process_tpu_torch.pipeline import cli
from slam_process_tpu_torch.utils.synthetic import (
    synthetic_session_bytes, to_hex_text, write_angle_table)
from test_torch_cli import assert_tables_close, assert_xlsx_equal, own

SESSION = dict(n_groups=5, frames_per_beam=8, baselines_per_group=9, junk_frac=0.05, seed=3,
               n_paths=3)
CHANGES = ["--changes", "--min-persist", "1", "--min-gone", "1", "--jump-deg", "1"]
POLL = ["--poll-interval", "0.05", "--idle-timeout", "1.0"]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    d = tmp_path_factory.mktemp("watch_inputs")
    text = to_hex_text(synthetic_session_bytes(**SESSION))
    (d / "live.txt").write_bytes(text)
    return text, d / "live.txt", write_angle_table(d / "beam_angle.xlsx")


def grow(path, text, seed, consumed, max_piece=12_000):
    """Write ``text`` to ``path`` in seeded pieces of 1 to ``max_piece``
    bytes, each after the watch has read the one before (``consumed``), so
    every piece meets a poll of its own whatever the machine's speed."""
    rng = np.random.default_rng(seed)
    with open(path, "ab") as f:
        off = 0
        while off < len(text):
            n = int(rng.integers(1, max_piece))
            f.write(text[off:off + n])
            f.flush()
            off += n
            assert consumed.wait(timeout=60), "the watch stopped reading"
            consumed.clear()


def watch_argv(log, angles, outdir, *extra):
    return ["watch", "--log", str(log), "--mapping", str(angles), "--outdir", str(outdir),
            *POLL, *extra]


def run(argv, capsys):
    """(exit code, stdout lines, stderr) of an in-process ``cli.main``."""
    capsys.readouterr()
    rc = cli.main(argv)
    captured = capsys.readouterr()
    return rc, captured.out.splitlines(), captured.err


def events(path):
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def assert_events_close(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert {k: v for k, v in g.items() if k != "power"} == {
            k: v for k, v in w.items() if k != "power"}
        np.testing.assert_allclose(g["power"], w["power"], rtol=2e-4)


def summary(lines, outdir):
    (line,) = [ln for ln in own(lines) if ln.startswith("{")]
    return json.loads(line.replace(str(outdir), "OUT"))


def assert_tables_equal(a, b):
    assert_xlsx_equal(a / "live_filtered.xlsx", b / "live_filtered.xlsx")
    assert_tables_close(a / "live_stream_tracks.xlsx", b / "live_stream_tracks.xlsx",
                        {"Track", "Sweep", "CLK"})
    assert_tables_close(a / "live_stream_changes.xlsx", b / "live_stream_changes.xlsx",
                        {"Sweep", "CLK", "Kind", "Track"})


@pytest.fixture(scope="module")
def jax_watch(capture, tmp_path_factory):
    """The JAX CLI's host-engine watch of the finished capture."""
    import contextlib
    import io

    _, log, angles = capture
    d = tmp_path_factory.mktemp("jax_watch")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_cli.main(watch_argv(log, angles, d / "out", "--paths", *CHANGES,
                                       "--events", str(d / "events.jsonl"))) == 0
    return d, buf.getvalue().splitlines()


@pytest.fixture(scope="module", params=["device", "host"])
def live(request, capture, tmp_path_factory):
    """The port's watch of the growing capture, with a copy of the
    checkpoint and the events file at every periodic save mid-stream."""
    import contextlib
    import io

    text, _, angles = capture
    engine = request.param
    d = tmp_path_factory.mktemp(f"watch_{engine}")
    log = d / "live.txt"
    log.write_bytes(b"")
    saves = []
    save, read_growth = cli.Watch.save_checkpoint, cli.Watch._read_growth
    consumed = threading.Event()

    def signalling_read(self):
        data = read_growth(self)
        if data is not None:
            consumed.set()
        return data

    def copying_save(self):
        save(self)
        if not self.session._finalized and 0 < self.pos < len(text):
            snap = d / f"snap_{len(saves)}"
            snap.mkdir()
            shutil.copy(self.args.checkpoint, snap / "ckpt.npz")
            if self.args.events.exists():
                shutil.copy(self.args.events, snap / "events.jsonl")
            saves.append((snap, self.pos))

    cli.Watch.save_checkpoint = copying_save
    cli.Watch._read_growth = signalling_read
    writer = threading.Thread(target=grow, args=(log, text, 7, consumed))
    buf = io.StringIO()
    try:
        writer.start()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(watch_argv(log, angles, d / "out", "--paths", *CHANGES, "--engine",
                                     engine, "--events", str(d / "events.jsonl"),
                                     "--checkpoint", str(d / "ckpt.npz"),
                                     "--checkpoint-every", "0.1", "--device", "cpu"))
    finally:
        writer.join(timeout=60)
        cli.Watch.save_checkpoint, cli.Watch._read_growth = save, read_growth
    assert rc == 0 and not writer.is_alive()
    return engine, d, buf.getvalue().splitlines(), saves


def test_watch_matches_jax_on_the_finished_file(live, jax_watch, capture):
    engine, d, lines, saves = live
    jd, jlines = jax_watch
    assert_events_close(events(d / "events.jsonl"), events(jd / "events.jsonl"))
    assert_tables_equal(d / "out", jd / "out")
    got, want = summary(lines, d / "out"), summary(jlines, jd / "out")
    assert got == want and got["bytes_seen"] == len(capture[0]) and got["events"] > 3
    assert (d / "out" / "live_watch.png").stat().st_size > 10_000
    assert saves, "no periodic checkpoint was taken mid-stream"


def test_resume_from_a_mid_stream_checkpoint(live, capture, tmp_path, capsys):
    """The last mid-stream checkpoint and events file, the events' last line
    torn in half, resumed on the finished file."""
    engine, d, lines, saves = live
    text, finished, angles = capture
    snap, pos = saves[-1]
    shutil.copy(snap / "ckpt.npz", tmp_path / "ckpt.npz")
    before = (snap / "events.jsonl").read_bytes() if (snap / "events.jsonl").exists() else b""
    kept = before.splitlines(keepends=True)
    assert len(kept) > 1, "the mid-stream events file holds too few events to tear one"
    torn = kept[-1][:len(kept[-1]) // 2] if kept else b""
    (tmp_path / "events.jsonl").write_bytes(b"".join(kept[:-1]) + torn)
    shutil.copy(finished, tmp_path / "live.txt")
    rc, got, err = run(watch_argv(tmp_path / "live.txt", angles, tmp_path / "out", "--paths",
                                  *CHANGES, "--engine", engine, "--events",
                                  str(tmp_path / "events.jsonl"), "--checkpoint",
                                  str(tmp_path / "ckpt.npz"), "--device", "cpu"), capsys)
    assert rc == 0
    assert f"resumed from {tmp_path / 'ckpt.npz'} at byte {pos}" in err
    resumed = (tmp_path / "events.jsonl").read_text().splitlines()
    if torn:
        # The torn fragment stays on a line of its own; its event comes again.
        assert resumed[len(kept) - 1] == torn.decode()
        del resumed[len(kept) - 1]
    rows = [json.loads(ln) for ln in resumed]
    assert len({(e["sweep"], e["kind"], e["track"]) for e in rows}) == len(rows)
    assert rows == events(d / "events.jsonl")
    assert_tables_equal(tmp_path / "out", d / "out")
    want = summary(lines, d / "out")
    got = summary(got, tmp_path / "out")
    assert got["events"] == want["events"] - (len(kept) - (1 if torn else 0))
    assert got["tokens"] < want["tokens"] and got["bytes_seen"] == want["bytes_seen"]
    assert {k: got[k] for k in ("frames", "kept", "sweeps", "png")} == {
        k: want[k] for k in ("frames", "kept", "sweeps", "png")}


def test_completed_checkpoint_reexports(live, capture, tmp_path, capsys):
    engine, d, lines, _ = live
    shutil.copy(d / "ckpt.npz", tmp_path / "ckpt.npz")
    shutil.copy(d / "events.jsonl", tmp_path / "events.jsonl")
    # --logs with one file is --log; --paths comes from the checkpoint.
    rc, got, err = run(["watch", "--logs", str(tmp_path / "moved" / "live.txt"), "--mapping",
                             str(capture[2]), "--outdir", str(tmp_path / "out"), *POLL,
                             *CHANGES, "--engine", engine, "--events",
                             str(tmp_path / "events.jsonl"), "--checkpoint",
                             str(tmp_path / "ckpt.npz"), "--device", "cpu"], capsys)
    assert rc == 0
    assert "is from a COMPLETED watch; re-exporting its results" in err
    assert "note: the restored checkpoint carries online-estimation state" in err
    assert (tmp_path / "events.jsonl").read_bytes() == (d / "events.jsonl").read_bytes()
    assert_tables_equal(tmp_path / "out", d / "out")
    assert summary(got, tmp_path / "out")["frames"] == summary(lines, d / "out")["frames"]


def test_the_other_engines_checkpoint_is_refused(live, capture, tmp_path, caplog):
    engine, d, _, _ = live
    _, log, angles = capture
    other = "host" if engine == "device" else "device"
    shutil.copy(d / "ckpt.npz", tmp_path / "ckpt.npz")
    rc = cli.main(watch_argv(log, angles, tmp_path / "out", "--engine", other, "--checkpoint",
                             str(tmp_path / "ckpt.npz"), "--device", "cpu"))
    assert rc == 1
    assert "checkpoint: kind=" in caplog.text


def test_watch_steps_without_the_png(capture, tmp_path):
    """``Watch``'s steps as ``chip_smoke.py`` drives them (no PNG): the
    finished file, host engine, no checkpoint."""
    from slam_process_tpu_torch.io.angles import load_angle_lut

    _, log, angles = capture
    args = cli.build_parser().parse_args(watch_argv(log, angles, tmp_path, "--engine", "host",
                                                    "--idle-timeout", "0.2"))
    cli.check_watch_flags(args)
    w = cli.Watch(args)
    w.run()
    rendered = w.session.render(load_angle_lut(angles))
    out = w.export()
    assert rendered.rgba.shape[2] == 4 and out["frames"] > 0 and "events" not in out
    assert not (tmp_path / "live_watch.png").exists()


FLAG_CASES = {
    "no_log": [],
    "log_and_logs": ["--log", "a.txt", "--logs", "b.txt"],
    "every_without_checkpoint": ["--log", "a.txt", "--checkpoint-every", "5"],
    "emit_capacity_zero": ["--log", "a.txt", "--emit-capacity", "0"],
    "processes_without_coordinator": ["--log", "a.txt", "--num-processes", "2"],
    "events_without_paths": ["--log", "a.txt", "--events", "e.jsonl"],
    "logs_with_host_engine": ["--logs", "a.txt", "b.txt", "--engine", "host"],
    "logs_events_without_paths": ["--logs", "a.txt", "b.txt", "--engine", "device", "--events",
                                  "e.jsonl"],
    "coordinator_without_process_id": ["--logs", "a.txt", "--coordinator", "localhost:1",
                                       "--num-processes", "2"],
    "coordinator_with_checkpoint": ["--logs", "a.txt", "--coordinator", "localhost:1",
                                    "--num-processes", "2", "--process-id", "0",
                                    "--engine", "device", "--checkpoint", "c.npz"],
    "coordinator_events_without_paths": ["--logs", "a.txt", "--coordinator", "localhost:1",
                                         "--num-processes", "2", "--process-id", "0",
                                         "--engine", "device", "--events", "e.jsonl"],
}


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_flag_checks_exit_as_jax(case, tmp_path):
    argv = ["watch", "--mapping", "m.xlsx", "--outdir", str(tmp_path), *FLAG_CASES[case]]
    with pytest.raises(SystemExit) as ours:
        cli.main(argv)
    with pytest.raises(SystemExit) as ref:
        jax_cli.main(argv)
    assert str(ours.value.code) == str(ref.value.code) and ours.value.code


@pytest.mark.parametrize("extra", [["--log", "a.txt", "--coordinator", "localhost:1"],
                                   ["--logs", "a.txt", "--local-devices", "2", "--coordinator",
                                    "localhost:1", "--num-processes", "2", "--process-id", "0",
                                    "--engine", "host"]],
                         ids=["coordinator", "local_devices"])
def test_multi_stream_and_multi_host_are_not_ported(extra, tmp_path):
    """The multi-host watch's own checks (it runs: tests/test_torch_multihost.py)
    exit before any process group is joined, with the JAX CLI's messages."""
    argv = ["watch", "--mapping", "m.xlsx", "--outdir", str(tmp_path), *extra]
    with pytest.raises(SystemExit) as ours:
        cli.main(argv)
    with pytest.raises(SystemExit) as ref:
        jax_cli.main(argv)
    assert str(ours.value.code) == str(ref.value.code)
    assert "--coordinator requires --logs" in str(ours.value.code) or "--engine device" in str(
        ours.value.code)


def test_helpers():
    assert cli._split_text_carry(b"1A 2B 3") == (b"1A 2B ", b"3")
    assert cli._split_text_carry(b"1A\n2B\r") == (b"1A\n2B\r", b"")
    assert cli._split_text_carry(b"1A2B") == (None, b"1A2B")
    assert cli._split_text_carry(b"") == (None, b"")
    assert cli._dedup_export_names(["x/live.txt", "y/live.txt", "Serial Debug 2026-02-06 "
                                    "091211.txt", "live.txt"]) == [
        "live", "live_1", "2026-02-06 091211", "live_2"]
    paths = [Path(p) for p in ("x/live.txt", "y/live.txt", "z/live.txt")]
    assert cli._dedup_export_names(paths) == jax_cli._dedup_export_names(paths)
    row = np.array([3, 1234567, 2, 1, 12.345678, -7.5, 99.5])
    assert cli._event_json_line(row) == jax_cli._event_json_line(row)


def test_seed_event_keys_quarantines_a_torn_tail(tmp_path):
    path = tmp_path / "e.jsonl"
    path.write_bytes(b'{"sweep": 1, "clk": 5, "kind": "birth", "track": 0}\n'
                     b"not json\n"
                     b'{"sweep": 2, "clk": 6, "kind": "jump", "track": 3}\n'
                     b'{"sweep": 3, "clk": 7, "ki')
    keys = cli._seed_event_keys(path)
    assert keys == {(1, 0, 0), (2, 2, 3)}
    assert path.read_bytes().endswith(b'"ki\n')
    assert cli._seed_event_keys(tmp_path / "missing.jsonl") == set()


# -- watch --logs: several captures, one multi-stream session ------------------

SECOND = dict(SESSION, n_groups=3, seed=4)


def multi_argv(logs, angles, outdir, *extra):
    return ["watch", "--logs", *map(str, logs), "--mapping", str(angles), "--outdir",
            str(outdir), *POLL, *extra]


@pytest.fixture(scope="module")
def multi_captures(capture, tmp_path_factory):
    """Capture A (the single watch's) and a shorter capture B, in two
    directories under one name, so the exports are ``live`` and ``live_1``."""
    text_a, _, angles = capture
    d = tmp_path_factory.mktemp("multi_inputs")
    text_b = to_hex_text(synthetic_session_bytes(**SECOND))
    logs = [d / "a" / "live.txt", d / "b" / "live.txt"]
    for log, text in zip(logs, (text_a, text_b)):
        log.parent.mkdir()
        log.write_bytes(text)
    return (text_a, text_b), logs, angles


@pytest.fixture(scope="module")
def jax_multi_watch(multi_captures, tmp_path_factory):
    """The JAX CLI's multi-stream watch of the finished captures."""
    import contextlib
    import io

    _, logs, angles = multi_captures
    d = tmp_path_factory.mktemp("jax_multi_watch")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_cli.main(multi_argv(logs, angles, d / "out", "--engine", "device",
                                       "--paths", *CHANGES, "--events",
                                       str(d / "events.jsonl"))) == 0
    return d, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def live_multi(multi_captures, tmp_path_factory):
    """The port's multi watch: capture A whole from the start, capture B
    grown by a writer thread in pieces of up to 4,000 bytes, so A idles out
    first; a copy of the checkpoint and the events at every periodic save
    while B is still growing."""
    import contextlib
    import io

    (text_a, text_b), _, angles = multi_captures
    d = tmp_path_factory.mktemp("multi_watch")
    logs = [d / "a" / "live.txt", d / "b" / "live.txt"]
    for log in logs:
        log.parent.mkdir()
    logs[0].write_bytes(text_a)
    logs[1].write_bytes(b"")
    saves = []
    save, read_growth = cli.MultiWatch.save_checkpoint, cli.MultiWatch._read_growth
    consumed = threading.Event()

    def signalling_read(self, i):
        data = read_growth(self, i)
        if data is not None and i == 1:
            consumed.set()
        return data

    def copying_save(self):
        save(self)
        if not self.session._finalized and 0 < self.pos[1] < len(text_b):
            snap = d / f"snap_{len(saves)}"
            snap.mkdir()
            shutil.copy(self.args.checkpoint, snap / "ckpt.npz")
            if self.args.events.exists():
                shutil.copy(self.args.events, snap / "events.jsonl")
            saves.append((snap, list(self.pos), self.session._stream_finalized.tolist()))

    cli.MultiWatch.save_checkpoint = copying_save
    cli.MultiWatch._read_growth = signalling_read
    writer = threading.Thread(target=grow, args=(logs[1], text_b, 11, consumed, 4_000))
    out, err = io.StringIO(), io.StringIO()
    try:
        writer.start()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(multi_argv(logs, angles, d / "out", "--paths", *CHANGES, "--events",
                                     str(d / "events.jsonl"), "--checkpoint",
                                     str(d / "ckpt.npz"), "--checkpoint-every", "0.1",
                                     "--device", "cpu"))
    finally:
        writer.join(timeout=60)
        cli.MultiWatch.save_checkpoint, cli.MultiWatch._read_growth = save, read_growth
    assert rc == 0 and not writer.is_alive()
    return d, out.getvalue().splitlines(), err.getvalue(), saves


def by_session(rows):
    got: dict = {}
    for e in rows:
        got.setdefault(e["session"], []).append(e)
    return got


def assert_multi_events_close(got, want):
    got, want = by_session(got), by_session(want)
    assert sorted(got) == sorted(want) == ["live", "live_1"]
    for name in got:
        assert_events_close(got[name], want[name])


def assert_multi_tables_equal(a, b):
    for name in ("live", "live_1"):
        assert_xlsx_equal(a / f"{name}_filtered.xlsx", b / f"{name}_filtered.xlsx")
        assert_tables_close(a / f"{name}_stream_tracks.xlsx", b / f"{name}_stream_tracks.xlsx",
                            {"Track", "Sweep", "CLK"})
        assert_tables_close(a / f"{name}_stream_changes.xlsx",
                            b / f"{name}_stream_changes.xlsx", {"Sweep", "CLK", "Kind", "Track"})


def summaries(lines, outdir):
    return [json.loads(ln.replace(str(outdir), "OUT")) for ln in own(lines)
            if ln.startswith("{")]


def test_multi_watch_matches_jax_on_the_finished_files(live_multi, jax_multi_watch,
                                                       multi_captures):
    d, lines, err, saves = live_multi
    jd, jlines = jax_multi_watch
    assert "stream(s) [0] finalized (1 still live)" in err
    assert_multi_events_close(events(d / "events.jsonl"), events(jd / "events.jsonl"))
    assert_multi_tables_equal(d / "out", jd / "out")
    got, want = summaries(lines, d / "out"), summaries(jlines, jd / "out")
    assert got == want and len(got) == 3 and got[2]["events"] > 3
    assert [x["bytes_seen"] for x in got[:2]] == [len(t) for t in multi_captures[0]]
    for name in ("live", "live_1"):
        assert (d / "out" / f"{name}_watch.png").stat().st_size > 10_000
    assert saves, "no periodic checkpoint was taken while capture B grew"


def test_multi_watch_resumes_from_a_mid_stream_checkpoint(live_multi, multi_captures, tmp_path,
                                                          capsys):
    """The last checkpoint taken while B grew, and the events file at that
    moment, resumed on the finished captures: the same tables and events,
    no event twice."""
    d, lines, _, saves = live_multi
    _, finished, angles = multi_captures
    snap, pos, fin = saves[-1]
    shutil.copy(snap / "ckpt.npz", tmp_path / "ckpt.npz")
    if (snap / "events.jsonl").exists():
        shutil.copy(snap / "events.jsonl", tmp_path / "events.jsonl")
    logs = [tmp_path / "a" / "live.txt", tmp_path / "b" / "live.txt"]
    for log, src in zip(logs, finished):
        log.parent.mkdir()
        shutil.copy(src, log)
    rc, got, err = run(multi_argv(logs, angles, tmp_path / "out", "--paths", *CHANGES,
                                  "--events", str(tmp_path / "events.jsonl"), "--checkpoint",
                                  str(tmp_path / "ckpt.npz"), "--device", "cpu"), capsys)
    assert rc == 0
    assert f"resumed from {tmp_path / 'ckpt.npz'}: cursors {pos}, {sum(fin)} stream(s)" in err
    rows = events(tmp_path / "events.jsonl")
    assert len({(e["session"], e["sweep"], e["kind"], e["track"]) for e in rows}) == len(rows)
    assert by_session(rows) == by_session(events(d / "events.jsonl"))
    assert_multi_tables_equal(tmp_path / "out", d / "out")
    assert [{k: x[k] for k in ("session", "bytes_seen", "frames", "kept", "sweeps")}
            for x in summaries(got, tmp_path / "out")[:2]] == [
        {k: x[k] for k in ("session", "bytes_seen", "frames", "kept", "sweeps")}
        for x in summaries(lines, d / "out")[:2]]


def test_multi_watch_steps_without_the_png(multi_captures, tmp_path):
    """``MultiWatch``'s steps as ``chip_smoke.py`` drives them (no PNG), and
    a checkpoint of another stream count refused."""
    _, logs, angles = multi_captures
    args = cli.build_parser().parse_args(multi_argv(logs, angles, tmp_path, "--idle-timeout",
                                                    "0.2", "--checkpoint",
                                                    str(tmp_path / "c.npz"), "--device", "cpu"))
    assert cli.check_watch_flags(args) is True
    w = cli.MultiWatch(args)
    w.run()
    rendered = [w.render(i) for i in range(2)]
    out = w.export()
    assert all(r.rgba.shape[2] == 4 for r in rendered) and out[-1] == {
        "streams": 2, "total_frames": out[0]["frames"] + out[1]["frames"]}
    assert not (tmp_path / "live_watch.png").exists()
    args = cli.build_parser().parse_args(multi_argv(logs + logs[:1], angles, tmp_path,
                                                    "--checkpoint", str(tmp_path / "c.npz"),
                                                    "--device", "cpu"))
    assert cli.check_watch_flags(args)
    with pytest.raises(SystemExit, match="holds 2 streams, --logs names 3"):
        cli.MultiWatch(args)
