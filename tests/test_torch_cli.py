"""The port's CLI (``slam_process_tpu_torch.pipeline.cli``) against the JAX
package's, both in process on the same files.

``--device cpu`` runs the port's plain versions; the JAX CLI runs its
default host engine under the conftest's CPU pin.  Written xlsx files must
carry byte-equal ``xl/worksheets/sheet1.xml`` and ``xl/workbook.xml``
(the zip's timestamps differ); npz files equal arrays by key, dtype and
value; the printed valid / discarded counts equal, on logs with flag bytes
spliced in and truncated tails.  ``session``'s JSON counters equal JAX's
``--engine host`` counters (the port's host engine) or share their
values (the device engine's ``decode+correct(device)`` counter).  One run
goes through ``python -m`` in a subprocess.
"""

import json
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

from slam_process_tpu.pipeline import cli as jax_cli
from slam_process_tpu_torch.pipeline import cli
from slam_process_tpu_torch.utils.synthetic import (
    legacy_stream_bytes, synthetic_session_bytes, to_hex_text, with_flag_junk,
    write_angle_table)

REPO = Path(__file__).resolve().parent.parent
MEMBERS = ("xl/worksheets/sheet1.xml", "xl/workbook.xml")
LOGS = {
    "clean": lambda: synthetic_session_bytes(n_groups=3, frames_per_beam=2,
                                             baselines_per_group=5, junk_frac=0.3, seed=11),
    "flag_junk": lambda: with_flag_junk(synthetic_session_bytes(
        n_groups=3, frames_per_beam=2, baselines_per_group=5, junk_frac=0.3, seed=12),
        n_bursts=25, cut=4, seed=12),
    "flag_junk_cut_mid_frame": lambda: with_flag_junk(synthetic_session_bytes(
        n_groups=2, frames_per_beam=3, baselines_per_group=4, junk_frac=0.1, seed=13),
        n_bursts=10, cut=7, seed=13),
}


def members(path):
    with zipfile.ZipFile(path) as zf:
        return {m: zf.read(m) for m in MEMBERS}


def assert_xlsx_equal(a, b):
    got, want = members(a), members(b)
    for m in MEMBERS:
        assert got[m] == want[m], f"{m} differs between {a} and {b}"


def assert_npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def run(main, argv, capsys):
    """(exit code, stdout lines) of an in-process CLI call."""
    capsys.readouterr()
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    return rc, capsys.readouterr().out.splitlines()


def counts_line(lines):
    (line,) = [ln for ln in lines if ln.startswith("有效组数=")]
    return line.split(" 输出=")[0]


def write_log(tmp_path, name, raw):
    path = tmp_path / f"{name}.txt"
    path.write_bytes(to_hex_text(raw))
    return path


@pytest.mark.parametrize("log", sorted(LOGS))
def test_decode_matches_jax(tmp_path, capsys, log):
    path = write_log(tmp_path, log, LOGS[log]())
    rc, got = run(cli.main, ["decode", str(path), str(tmp_path / "port.xlsx"),
                             "--device", "cpu"], capsys)
    rc_j, want = run(jax_cli.main, ["decode", str(path), str(tmp_path / "jax.xlsx")], capsys)
    assert rc == rc_j == 0
    assert counts_line(got) == counts_line(want)
    assert_xlsx_equal(tmp_path / "port.xlsx", tmp_path / "jax.xlsx")
    if log != "clean":
        assert not counts_line(got).endswith("丢弃组数=0")


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_decode_legacy_formats_match_jax(tmp_path, capsys, fmt):
    path = write_log(tmp_path, f"legacy_{fmt}", legacy_stream_bytes(fmt, seed=5))
    rc, got = run(cli.main, ["decode", str(path), str(tmp_path / "port.xlsx"), "--format", fmt,
                             "--device", "cpu"], capsys)
    rc_j, want = run(jax_cli.main, ["decode", str(path), str(tmp_path / "jax.xlsx"),
                                    "--format", fmt], capsys)
    assert rc == rc_j == 0
    assert counts_line(got) == counts_line(want)
    assert_xlsx_equal(tmp_path / "port.xlsx", tmp_path / "jax.xlsx")


@pytest.mark.parametrize("mode", ["output", "in_place", "from_txt"])
def test_correct_matches_jax(tmp_path, capsys, mode):
    path = write_log(tmp_path, "corr", LOGS["flag_junk"]())
    assert jax_cli.main(["decode", str(path), str(tmp_path / "parsed.xlsx")]) == 0
    outs = {}
    for who, main, extra in (("port", cli.main, ["--device", "cpu"]),
                             ("jax", jax_cli.main, [])):
        src = tmp_path / "parsed.xlsx"
        if mode == "in_place":
            src = tmp_path / f"parsed_{who}.xlsx"
            src.write_bytes((tmp_path / "parsed.xlsx").read_bytes())
            argv = ["correct", "--input", str(src), "--in-place"]
            outs[who] = src
        else:
            if mode == "from_txt":
                src = path
            outs[who] = tmp_path / f"filtered_{who}.xlsx"
            argv = ["correct", "--input", str(src), "--output", str(outs[who])]
        rc, lines = run(main, argv + extra, capsys)
        assert rc == 0
        outs[who + "_lines"] = [ln.replace(str(outs[who]), "OUT") for ln in lines
                                if ln.startswith("已")]
    assert outs["port_lines"] == outs["jax_lines"]
    assert_xlsx_equal(outs["port"], outs["jax"])


def test_correct_run_tests_exits_zero(capsys):
    rc, lines = run(cli.main, ["correct", "--run-tests", "--device", "cpu"], capsys)
    assert rc == 0
    assert lines[-1] == "corrector self-test: 6/6 specs ok"


@pytest.mark.parametrize("engine", ["device", "host"])
def test_session_matches_jax(tmp_path, capsys, engine):
    path = write_log(tmp_path, "sess", LOGS["flag_junk"]())
    angles = write_angle_table(tmp_path / "angles.xlsx", unmapped=(0, 7, 63))
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    argv = ["session", "--log", str(path), "--mapping", str(angles), "--outdir"]
    rc, got = run(cli.main, argv + [str(port_dir), "--engine", engine, "--device", "cpu"],
                  capsys)
    rc_j, want = run(jax_cli.main, argv + [str(jax_dir), "--engine", "host"], capsys)
    assert rc == rc_j == 0
    for name in ("sess.xlsx", "sess_filtered.xlsx"):
        assert_xlsx_equal(port_dir / name, jax_dir / name)
    assert_npz_equal(port_dir / "sess.npz", jax_dir / "sess.npz")
    assert (port_dir / "sess_heatmap.png").stat().st_size > 10_000
    got = json.loads([ln for ln in got if ln.startswith("{")][-1])
    want = json.loads([ln for ln in want if ln.startswith("{")][-1])
    assert got["session"] == want["session"] == "sess"
    if engine == "host":
        assert got["counters"] == want["counters"]
        assert set(got["timings_s"]) == set(want["timings_s"])
    else:
        assert got["counters"]["correct"] == want["counters"]["correct"]
        assert got["counters"]["decode+correct(device)"] == {
            "bytes": want["counters"]["decode"]["bytes"],
            "valid": want["counters"]["decode"]["valid"],
            "corrected": want["counters"]["correct"]["corrected"]}
        assert set(got["timings_s"]) == {"device_pipeline", "correct", "scene", "render"}


def test_session_profile_writes_a_trace(tmp_path, capsys):
    path = write_log(tmp_path, "prof", LOGS["clean"]())
    angles = write_angle_table(tmp_path / "angles.xlsx")
    rc, _ = run(cli.main, ["session", "--log", str(path), "--mapping", str(angles), "--outdir",
                           str(tmp_path / "out"), "--profile", str(tmp_path / "trace"),
                           "--device", "cpu"], capsys)
    assert rc == 0
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_heatmap_writes_png(tmp_path, capsys):
    path = write_log(tmp_path, "heat", LOGS["clean"]())
    angles = write_angle_table(tmp_path / "angles.xlsx")
    assert jax_cli.main(["decode", str(path), str(tmp_path / "parsed.xlsx")]) == 0
    rc, lines = run(cli.main, ["heatmap", "--input", str(tmp_path / "parsed.xlsx"), "--mapping",
                               str(angles), "--variant", "v2", "--no-logscale",
                               "--device", "cpu"], capsys)
    assert rc == 0
    out = tmp_path / "heatmap_outputs" / "parsed_heatmap.png"
    assert lines[-1] == f"输出PNG: {out}"
    assert out.stat().st_size > 10_000


def test_module_entry_point_runs(tmp_path):
    """``python -m`` with ``--device cpu`` writes what the in-process call
    writes."""
    path = write_log(tmp_path, "mod", LOGS["flag_junk"]())
    assert cli.main(["decode", str(path), str(tmp_path / "inproc.xlsx"), "--device", "cpu"]) == 0
    r = subprocess.run([sys.executable, "-m", "slam_process_tpu_torch.pipeline.cli", "decode",
                        str(path), str(tmp_path / "sub.xlsx"), "--device", "cpu"],
                       capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "有效组数=" in r.stdout
    assert_xlsx_equal(tmp_path / "sub.xlsx", tmp_path / "inproc.xlsx")


def test_cli_errors_return_one(tmp_path, capsys):
    rc, _ = run(cli.main, ["correct", "--input", str(tmp_path / "missing.xlsx"),
                           "--device", "cpu"], capsys)
    assert rc == 1


# ---------------------------------------------------------------------------
# estimate
# ---------------------------------------------------------------------------

EST_LOG = dict(n_groups=8, frames_per_beam=1, baselines_per_group=4, seed=21, n_paths=3)


@pytest.fixture(scope="module")
def estimate_inputs(tmp_path_factory):
    """A multipath log, its filtered xlsx (written by the JAX CLI) and the
    angle table."""
    d = tmp_path_factory.mktemp("estimate")
    path = write_log(d, "mp", synthetic_session_bytes(**EST_LOG))
    assert jax_cli.main(["correct", "--input", str(path), "--output",
                         str(d / "mp_filtered.xlsx")]) == 0
    return {"txt": path, "xlsx": d / "mp_filtered.xlsx",
            "angles": write_angle_table(d / "angles.xlsx")}


def own(lines):
    """The command's own printed lines (log records cut)."""
    return [ln for ln in lines if not ln.startswith(("INFO ", "WARNING ", "ERROR "))]


def table_rows(lines):
    """(AoA, AoD, Power, PathType) rows of the printed paths table."""
    head = lines.index(next(ln for ln in lines if ln.split() == ["AoA", "AoD", "Power",
                                                                  "PathType"]))
    rows = [ln.split() for ln in lines[head + 1:] if not ln.startswith("输出PNG")]
    return (np.array([[float(x) for x in r[:3]] for r in rows]).reshape(-1, 3),
            [r[3] for r in rows])


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("source", ["txt", "xlsx"])
def test_estimate_matches_jax(tmp_path, capsys, estimate_inputs, source, engine):
    from test_torch_estimate import THRESHOLDS_DB, near_threshold

    argv = ["estimate", "--input", str(estimate_inputs[source]), "--mapping",
            str(estimate_inputs["angles"]), "--grid-res", "1.0", "--engine", engine]
    rc, got = run(cli.main, argv + ["--output", str(tmp_path / "port.png"), "--device", "cpu"],
                  capsys)
    rc_j, want = run(jax_cli.main, argv + ["--output", str(tmp_path / "jax.png")], capsys)
    assert rc == rc_j == 0
    got, want = own(got), own(want)
    assert got[-1] == f"输出PNG: {tmp_path / 'port.png'}"
    assert (tmp_path / "port.png").stat().st_size > 10_000
    if engine == "host":
        assert got[:-1] == want[:-1]
        return
    (g, g_type), (w, w_type) = table_rows(got), table_rows(want)
    assert len(g) == len(w) > 1
    np.testing.assert_array_equal(g[:, :2], w[:, :2])
    np.testing.assert_allclose(g[:, 2], w[:, 2], rtol=2e-4)
    los_tie, near = near_threshold(w[:, 2], np.ones(len(w), bool), THRESHOLDS_DB["nn_omp"])
    assert not los_tie
    assert [t for t, n in zip(g_type, near) if not n] == [t for t, n in zip(w_type, near)
                                                          if not n]


def read_table(path):
    from slam_process_tpu_torch.io.xlsx import read_xlsx_table

    return read_xlsx_table(path)


def assert_tables_close(a, b, int_cols):
    (names_a, va), (names_b, vb) = read_table(a), read_table(b)
    assert names_a == names_b and va.shape == vb.shape and len(va) > 0
    for i, name in enumerate(names_a):
        if name in int_cols:
            np.testing.assert_array_equal(va[:, i], vb[:, i], err_msg=name)
        else:
            np.testing.assert_allclose(va[:, i], vb[:, i], rtol=2e-4, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("mode", ["per_sweep", "tracks", "tracks_changes"])
def test_estimate_per_sweep_and_tracks_match_jax(tmp_path, capsys, estimate_inputs, mode):
    extra = {"per_sweep": ["--per-sweep"], "tracks": ["--tracks"],
             "tracks_changes": ["--tracks", "--changes", "--min-persist", "2", "--min-gone",
                                "2", "--jump-deg", "3"]}[mode]
    argv = ["estimate", "--input", str(estimate_inputs["txt"]), "--mapping",
            str(estimate_inputs["angles"]), "--grid-res", "1.0", *extra]
    outs = {who: tmp_path / f"{who}.xlsx" for who in ("port", "jax")}
    rc, got = run(cli.main, argv + ["--output", str(outs["port"]), "--device", "cpu"], capsys)
    rc_j, want = run(jax_cli.main, argv + ["--output", str(outs["jax"])], capsys)
    assert rc == rc_j == 0
    got, want = own(got), own(want)

    def printed(lines, who):
        return [ln.replace(str(outs[who].with_suffix("")), "OUT") for ln in lines]

    assert printed(got, "port") == printed(want, "jax")
    if mode == "per_sweep":
        assert got[-1].startswith("sweeps=8/8 paths=")
        assert_tables_close(outs["port"], outs["jax"], {"Sweep", "CLK", "Path"})
        return
    assert got[0].startswith("tracks=") and not got[0].startswith("tracks=0 ")
    assert_tables_close(outs["port"], outs["jax"], {"Track", "Sweep", "CLK"})
    assert outs["port"].with_suffix(".png").stat().st_size > 10_000
    if mode == "tracks_changes":
        assert got[1].startswith("changes=") and not got[1].startswith("changes=0 ")
        assert_tables_close(tmp_path / "port_changes.xlsx", tmp_path / "jax_changes.xlsx",
                            {"Sweep", "CLK", "Kind", "Track"})
