"""``BENCHMARK.json``, alone and with the parked cells' entries
(``portbench/parked.json``), keeps to the contract's names and units,
every per-layer metric's cells report the end-to-end metric it moves,
every entry has its file, and a configuration, a cell and a per-layer
metric are added as new files and entries alone: a copy with a dummy of
each runs without an edit to a file that was there."""

import io
import json
import re
from pathlib import Path

import pytest

from portbench.harness import run
from portbench.tests.tiny import tiny_root, with_parked

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

def _manifest(parked: bool) -> dict:
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    return with_parked(bench) if parked else bench


MANIFESTS = pytest.mark.parametrize("bench", [False, True], ids=["benchmark", "with_parked"],
                                    indirect=True)


@pytest.fixture
def bench(request):
    return _manifest(request.param)


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@MANIFESTS
def test_names_and_units(bench):
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[key]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(names) == len(set(names))


@MANIFESTS
def test_each_metric_is_reported_where_it_moves(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    assert {c["name"] for c in bench["configs"]} == {w["config"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert _applies(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        assert _applies(e2e["setup_s"], cell)
        assert sum(_applies(m, cell) for m in bench["end_to_end"]) >= 2
        assert any(_applies(m, cell) for m in bench["per_layer"])


@MANIFESTS
def test_every_entry_has_its_file(bench):
    pb = REPO / "portbench"
    for c in bench["configs"]:
        assert (REPO / c["file"]).exists()
    for w in bench["workloads"]:
        wl = json.loads((pb / "workloads" / f"{w['name']}.json").read_text())
        assert (wl["config"], wl["traffic"]["name"]) == (w["config"], w["traffic"])
        assert (pb / "drivers" / f"{wl['driver']}.py").exists()
    for m in bench["per_layer"]:
        assert (pb / "metrics" / f"{m['name']}.py").exists()


DUMMY_METRIC = '''"""dummy.rounds_per_s: window rounds a second (a test's metric)."""


def read(ctx):
    return ctx.stats["rounds"] / ctx.trace.window_s
'''


@pytest.mark.parametrize("trace", [False, True])
def test_new_files_and_entries_alone_add_a_cell(tmp_path, trace):
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "campaign19_live.json").read_text())
    cfg["name"] = "dummy_cfg"
    (pb / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    (pb / "workloads" / "dummy.cell.json").write_text(json.dumps({
        "name": "dummy.cell", "config": "dummy_cfg", "driver": "live", "limits": {},
        "traffic": {"name": "dummy.mix", "streams": 3, "chunk_bytes": 16384, "paths": False,
                    "warmup_rounds": 1}, "why": "a test's cell"}))
    (pb / "metrics" / "dummy.rounds_per_s.py").write_text(DUMMY_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy_cfg", "source": "a test", "reduced": [],
                             "file": "portbench/configs/dummy_cfg.json", "why": "a test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                               "traffic": "dummy.mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy.rounds_per_s", "unit": "1/s", "better": "higher",
                               "source": "program_counter", "layer": "Multi-stream round",
                               "moves": "frames_per_s", "workloads": ["dummy.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "log_result_ms_p95":
            m["workloads"].append("dummy.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out, err = io.StringIO(), io.StringIO()
    assert run("dummy.cell", 11, 1.0, trace, device="cpu", root=root, out=out, err=err) == 0, \
        err.getvalue()[-2000:]
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"]
    if trace:
        assert line["metrics"]["dummy.rounds_per_s"]["value"] > 0
    else:
        assert {"frames_per_s", "log_result_ms_p95", "setup_s"} <= set(line["metrics"])
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
