"""``replay`` of the port's CLI against the JAX CLI's, in process on the
same files.

Two synthetic logs (one named by its timestamp, one by its stem) go through
the port's ``replay --device cpu`` with both engines (the device stream's
plain versions, and the host stream) and through the JAX CLI's ``replay
--engine host`` (its default), at 4 KiB and 64 KiB chunks, with online
paths and change events:

  * ``<name>_filtered.xlsx``: sheet and workbook XML byte for byte;
  * ``<name>_stream_tracks.xlsx`` / ``_stream_changes.xlsx``: integer
    columns equal, the rest within rtol 2e-4;
  * the printed lines: each log's stats line equal apart from
    ``frames_per_sec``, the totals line and the ``changes=`` lines equal;
  * ``<name>_replay.png`` drawn.
"""

import json

import pytest

from slam_process_tpu.pipeline import cli as jax_cli
from slam_process_tpu_torch.pipeline import cli
from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, write_angle_table
from test_torch_cli import assert_tables_close, assert_xlsx_equal, own, run, write_log

LOGS = {"Serial Debug 2026-01-26 164520": dict(n_groups=5, frames_per_beam=8,
                                               baselines_per_group=9, junk_frac=0.05, seed=3,
                                               n_paths=3),
        "live": dict(n_groups=4, frames_per_beam=6, baselines_per_group=7, junk_frac=0.1,
                     seed=4, n_paths=3)}
NAMES = ["2026-01-26 164520", "live"]
CHANGES = ["--changes", "--min-persist", "1", "--min-gone", "1", "--jump-deg", "1"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("replay")
    logs = [write_log(d, stem, synthetic_session_bytes(**kw)) for stem, kw in LOGS.items()]
    return logs, write_angle_table(d / "beam_angle.xlsx")


def replay_argv(logs, angles, outdir, *extra):
    return ["replay", "--logs", *map(str, logs), "--mapping", str(angles), "--outdir",
            str(outdir), *extra]


def stats_lines(lines, outdir):
    """(JSON lines without frames_per_sec, other lines with outdir cut)."""
    js, other = [], []
    for ln in own(lines):
        if ln.startswith("{"):
            d = json.loads(ln)
            d.pop("frames_per_sec", None)
            js.append(d)
        else:
            other.append(ln.replace(str(outdir), "OUT"))
    return js, other


@pytest.fixture(scope="module")
def jax_replays(inputs, tmp_path_factory):
    """The JAX CLI's host-engine replay at each chunk size."""
    logs, angles = inputs
    out = {}
    for chunk in (1 << 12, 1 << 16):
        d = tmp_path_factory.mktemp(f"jax_replay_{chunk}")
        argv = replay_argv(logs, angles, d, "--chunk-bytes", str(chunk), "--paths", *CHANGES)
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jax_cli.main(argv) == 0
        out[chunk] = (d, buf.getvalue().splitlines())
    return out


@pytest.mark.parametrize("chunk", [1 << 12, 1 << 16])
@pytest.mark.parametrize("engine", ["device", "host"])
def test_replay_matches_jax(tmp_path, capsys, inputs, jax_replays, engine, chunk):
    logs, angles = inputs
    jdir, want = jax_replays[chunk]
    rc, got = run(cli.main, replay_argv(logs, angles, tmp_path, "--chunk-bytes", str(chunk),
                                        "--paths", *CHANGES, "--engine", engine,
                                        "--device", "cpu"), capsys)
    assert rc == 0
    got_js, got_other = stats_lines(got, tmp_path)
    want_js, want_other = stats_lines(want, jdir)
    assert got_js == want_js
    assert got_other == want_other and len(got_other) == 2
    assert got_js[-1] == {"sessions": 2, "total_frames": sum(d["frames"] for d in got_js[:2])}
    assert all(d["sweeps"] > 0 and d["kept"] > 0 for d in got_js[:2])
    for name in NAMES:
        assert_xlsx_equal(tmp_path / f"{name}_filtered.xlsx", jdir / f"{name}_filtered.xlsx")
        assert_tables_close(tmp_path / f"{name}_stream_tracks.xlsx",
                            jdir / f"{name}_stream_tracks.xlsx", {"Track", "Sweep", "CLK"})
        assert_tables_close(tmp_path / f"{name}_stream_changes.xlsx",
                            jdir / f"{name}_stream_changes.xlsx",
                            {"Sweep", "CLK", "Kind", "Track"})
        assert (tmp_path / f"{name}_replay.png").stat().st_size > 10_000


def test_replay_options(tmp_path, capsys, inputs):
    """``--decoder pallas`` runs the same decoder as the default; without
    ``--paths``, ``--changes`` warns and no track table is written; a
    ``--render-every`` host replay gives the same files."""
    logs, angles = inputs
    rc, plain = run(cli.main, replay_argv(logs[:1], angles, tmp_path / "a", "--device", "cpu"),
                    capsys)
    rc_p, pallas = run(cli.main, replay_argv(logs[:1], angles, tmp_path / "b", "--decoder",
                                             "pallas", "--changes", "--device", "cpu"), capsys)
    rc_h, host = run(cli.main, replay_argv(logs[:1], angles, tmp_path / "c", "--engine", "host",
                                           "--render-every", "8", "--chunk-bytes", "2048"),
                     capsys)
    assert rc == rc_p == rc_h == 0
    assert stats_lines(plain, "")[0] == stats_lines(pallas, "")[0] == stats_lines(host, "")[0]
    for d in ("b", "c"):
        assert_xlsx_equal(tmp_path / d / f"{NAMES[0]}_filtered.xlsx",
                          tmp_path / "a" / f"{NAMES[0]}_filtered.xlsx")
    assert not list((tmp_path / "b").glob("*_stream_*.xlsx"))


def test_changes_without_paths_warns(tmp_path, capsys, inputs):
    logs, angles = inputs
    capsys.readouterr()
    assert cli.main(replay_argv(logs[:1], angles, tmp_path, "--changes", "--device",
                                "cpu")) == 0
    assert "warning: --changes requires --paths" in capsys.readouterr().err


def test_replay_steps_drive_the_command(tmp_path, inputs):
    """The command's steps (``replay_stream``, ``render``, ``replay_exports``),
    as ``chip_smoke.py`` drives them without the PNG, write the command's
    files.  The device stream runs a window per chunk and, from the second
    chunk on, one of 20 bytes after each full one (the 10 carried bytes and
    10 new ones), as the JAX package's does."""
    from slam_process_tpu_torch.io.angles import load_angle_lut
    from slam_process_tpu_torch.parallel import streaming_device as sd

    logs, angles = inputs
    args = cli.build_parser().parse_args(replay_argv(logs[:1], angles, tmp_path, "--paths",
                                                     "--chunk-bytes", "4096", "--device",
                                                     "cpu"))
    windows = []
    step = sd.DeviceStreamingSession._step
    sd.DeviceStreamingSession._step = lambda self, c, n: windows.append(n) or step(self, c, n)
    try:
        name, s, seconds = cli.replay_stream(args, logs[0])
    finally:
        sd.DeviceStreamingSession._step = step
    n_raw = len(cli_raw(logs[0]))
    full, rest = divmod(n_raw, 4096)
    assert full > 3 and windows == [4096] + [4096, 20] * (full - 1) + ([rest + 10] if rest
                                                                        else [])
    rendered = s.render(load_angle_lut(angles))
    assert rendered.rgba.shape[2] == 4
    stats = cli.replay_exports(args, s, name, seconds)
    assert stats["session"] == NAMES[0] and stats["frames"] == s.n_frames
    assert (tmp_path / f"{NAMES[0]}_filtered.xlsx").exists()
    assert (tmp_path / f"{NAMES[0]}_stream_tracks.xlsx").exists()


def cli_raw(path):
    from slam_process_tpu_torch.io import read_hex_log

    return read_hex_log(path)
