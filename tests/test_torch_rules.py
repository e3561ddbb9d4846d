"""Rules of the port package (slam_process_tpu_torch).

  * It imports torch and numpy, never jax, the JAX package
    (``slam_process_tpu`` as a whole module name) or pandas: checked by
    AST over every file (and over the multi-process workers the tests and
    ``chip_smoke.py`` start) and by importing every module in a fresh
    interpreter.  pandas is imported nowhere, not even inside a function
    (the estimator's table is ``models/registry.PathsTable``).  matplotlib (which the card's machine lacks) is imported
    only inside function bodies of ``render/*.py``, never at module level
    and never in ``chip_smoke.py``; so importing every module loads none.
  * Entry points take ``device=None`` meaning CUDA, and raise when there is
    no CUDA device instead of moving to the CPU; the streaming commands
    (``replay``, ``watch``, ``run-config``) too, at their default
    ``--device``.  The host streaming engine (``--engine host``) makes no
    ``torch.cuda`` call at all.
  * The kernel wrappers launch or raise: a CPU tensor handed to one raises.
  * Every "ROADMAP ... queue N item M" that the port or ``chip_smoke.py``
    cites names an item that exists in ``ROADMAP.md``.
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "slam_process_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "slam_process_tpu", "matplotlib", "pandas"}
# Forbidden roots a function body may import, and the directory whose
# modules may do so.
FUNCTION_ONLY = {"matplotlib": PORT / "render"}
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_roots(path: Path, source=None):
    """(root module name, inside a function body) of every import in
    ``path`` (or in ``source``, read as if it were ``path``)."""
    tree = ast.parse(path.read_text() if source is None else source, filename=str(path))
    functions = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

    def walk(node, in_function):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                yield from ((alias.name.split(".")[0], in_function) for alias in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                yield child.module.split(".")[0], in_function
            elif (isinstance(child, ast.Call) and getattr(child.func, "attr", None)
                  == "import_module" and child.args and isinstance(child.args[0], ast.Constant)):
                yield str(child.args[0].value).split(".")[0], in_function
            yield from walk(child, in_function or isinstance(child, functions))

    yield from walk(tree, False)


def forbidden_imports(path: Path, source=None):
    return sorted({root for root, in_function in imported_roots(path, source)
                   if root in FORBIDDEN and not (in_function and path.parent
                                                 == FUNCTION_ONLY.get(root))})


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    assert not forbidden_imports(path)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_pandas_is_imported_nowhere(path):
    """No module of the port, and not ``chip_smoke.py``, imports pandas:
    neither at module level nor inside a function or method."""
    assert "pandas" not in {root for root, _ in imported_roots(path)}


@pytest.mark.parametrize("where,source,bad", [
    ("render/figures.py", "def f():\n    import matplotlib.pyplot as plt\n", []),
    ("render/figures.py", "def f():\n    from matplotlib.colors import LogNorm\n", []),
    ("render/figures.py", "import matplotlib\n", ["matplotlib"]),
    ("render/figures.py", "class A:\n    import matplotlib\n", ["matplotlib"]),
    ("ops/raster.py", "def f():\n    import matplotlib\n", ["matplotlib"]),
    ("render/heatmap.py", "def f():\n    import pandas, jax\n", ["jax", "pandas"]),
    ("models/registry.py", "class T:\n    def to_pandas(self):\n        import pandas\n",
     ["pandas"]),
    ("render/estimation.py", "def f():\n    from pandas import DataFrame\n", ["pandas"]),
    ("../chip_smoke.py", "def f():\n    import matplotlib\n", ["matplotlib"]),
    ("render/sub/x.py", "def f():\n    import matplotlib\n", ["matplotlib"]),
])
def test_matplotlib_only_inside_render_functions(where, source, bad):
    """The rule itself: matplotlib inside a function of ``render/*.py`` and
    nowhere else; the other roots nowhere."""
    assert forbidden_imports((PORT / where).resolve(), source) == bad


def spawned_workers():
    """The worker programs the port's multi-process checks start: the tests'
    two-process worker and the one ``chip_smoke.py`` writes (its source is a
    string there)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return [(REPO / "tests" / "_torch_multihost_worker.py", None),
            (REPO / "build" / "chip_smoke_multihost_worker.py", chip_smoke.MULTIHOST_WORKER)]


def test_spawned_workers_import_no_jax():
    for path, source in spawned_workers():
        roots = {root for root, _ in imported_roots(path, source)}
        assert not roots & FORBIDDEN, (path, roots & FORBIDDEN)
        assert "slam_process_tpu_torch" in roots or path.name.startswith("_torch")


def test_importing_every_module_loads_no_jax():
    modules = sorted(".".join(p.relative_to(REPO).with_suffix("").parts).replace(
        ".__init__", "") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n    importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
            "print(len(bad), bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.startswith("0 "), out


def test_entry_points_need_cuda_without_falling_back(monkeypatch, tmp_path):
    from slam_process_tpu_torch.pipeline.device import run_session_on_device
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, to_hex_text

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = synthetic_session_bytes(n_groups=1, frames_per_beam=1, baselines_per_group=1)
    path = tmp_path / "s.txt"
    path.write_bytes(to_hex_text(raw))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_session_on_device(raw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session.from_log(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_session_on_device(raw, device="cuda")
    assert int(run_session_on_device(raw, device="cpu").n_frames) == 64
    # The compiled programs (CUDA graphs on the card) raise too, and build
    # their eager bodies only where the caller names the CPU.
    from slam_process_tpu_torch.pipeline.device import (
        compiled_session_pipeline, compiled_text_session_pipeline)

    for factory in (compiled_session_pipeline, compiled_text_session_pipeline):
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                factory(3 << 18, device=device)
        assert factory(3 << 18, device="cpu").device == torch.device("cpu")

    from slam_process_tpu_torch.utils.synthetic import write_angle_table

    s = Session.from_log(path, device="cpu")
    angles = write_angle_table(tmp_path / "angles.xlsx")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s.sweep_paths(angles)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s.sweep_intensity()
    for engine in ("host", "device"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            s.path_tracks(angles, engine=engine)
    assert s.sweep_intensity(device="cpu")[1].sum() == len(s.filtered)

    from slam_process_tpu_torch.parallel.streaming_device import (
        DeviceStreamingSession, replay_log_device)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceStreamingSession()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replay_log_device(raw)
    assert replay_log_device(raw, device="cpu").n_frames == 64

    # A mesh names CUDA devices unless the caller names others; a CUDA mesh
    # raises without a card, and a mesh never moves to the CPU on its own.
    from slam_process_tpu_torch.parallel.mesh import make_mesh
    from slam_process_tpu_torch.parallel.multihost import initialize_multihost

    with pytest.raises(RuntimeError, match="device="):
        make_mesh((1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((2, 1), devices=["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_multihost("127.0.0.1:1", 2, 0)

    from slam_process_tpu_torch.ops.correct import self_test
    from slam_process_tpu_torch.pipeline import cli

    host = Session.from_log(path, engine="host")
    for call in (host.correct, host.intensity, lambda: host.render_heatmap(angles),
                 lambda: self_test(verbose=False)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert host.filtered is None
    host.export_parsed(tmp_path / "parsed.xlsx")
    parsed = Session.from_parsed_xlsx(tmp_path / "parsed.xlsx")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parsed.correct()
    s.export_filtered(tmp_path / "filtered.xlsx", device="cpu")
    estimate = ["estimate", "--mapping", str(angles), "--grid-res", "2.0"]
    for argv in (["decode", str(path), str(tmp_path / "p.xlsx")],
                 ["correct", "--input", str(tmp_path / "parsed.xlsx")],
                 ["correct", "--run-tests"],
                 ["heatmap", "--input", str(tmp_path / "parsed.xlsx"), "--mapping", str(angles),
                  "--variant", "v1"],
                 ["session", "--log", str(path), "--mapping", str(angles), "--outdir",
                  str(tmp_path / "out")],
                 estimate + ["--input", str(path)],
                 estimate + ["--input", str(tmp_path / "filtered.xlsx")],
                 estimate + ["--input", str(tmp_path / "filtered.xlsx"), "--per-sweep"],
                 estimate + ["--input", str(tmp_path / "filtered.xlsx"), "--tracks"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)
    assert parsed.correct(device="cpu") is parsed.filtered

    # The session estimator: the scene is built on the host, the estimate
    # and the figure's background need the card.
    from slam_process_tpu_torch.models import run_estimator
    from slam_process_tpu_torch.models.batch_estimation import estimate_sessions
    from slam_process_tpu_torch.render.estimation import rbf_background

    for call in (lambda: run_estimator("nn_omp", s, angles, grid_res=2.0),
                 lambda: run_estimator("nn_omp_v1", s, angles, device="cuda", grid_res=2.0),
                 lambda: estimate_sessions([s], angles, grid_res=2.0),
                 lambda: rbf_background(np.ones((4, 4)), np.arange(4.0), np.arange(4.0))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert len(run_estimator("nn_omp", s, angles, device="cpu", grid_res=2.0)) > 0

    # This slice's entry points: the text path, the device tokenizer, the
    # dataset's per-sweep paths, SM-SIC and the pre-log session.
    from slam_process_tpu_torch.ops.tokenize import tokenize_device
    from slam_process_tpu_torch.pipeline.device import run_session_from_text
    from slam_process_tpu_torch.pipeline.session import sweep_paths_dataset

    text = to_hex_text(raw, "shipped")
    for call in (lambda: run_session_from_text(text),
                 lambda: run_session_from_text(to_hex_text(raw)),
                 lambda: tokenize_device(text),
                 lambda: run_session_on_device(raw, log_transform_scene=True),
                 lambda: sweep_paths_dataset([s], angles),
                 lambda: s.sweep_paths(angles, estimator="sm_sic"),
                 lambda: run_estimator("sm_sic", s, angles),
                 lambda: cli.main(estimate + ["--input", str(path), "--model", "sm_sic"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert bool(run_session_from_text(text, device="cpu").tokenize_regular)
    assert len(run_estimator("sm_sic", s, angles, device="cpu")) > 0

    # The eleventh slice's estimator families (geometric is host only).
    for name in ("svd", "omp_dense", "lasso_refine", "peak_picking", "fusion", "nn_omp_v13"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_estimator(name, s, angles, grid_res=2.0)
        assert run_estimator(name, s, angles, device="cpu", grid_res=2.0) is not None
    with pytest.warns(RuntimeWarning, match="no device engine"):
        assert len(run_estimator("geometric", s, angles)) > 0


ROADMAP_REF = re.compile(r"ROADMAP(?:\.md)?[\s\"'#f+]*queue[\s\"'#f+]*(\d+)[\s\"'#f+]*item"
                         r"[\s\"'#f+]*(\d+(?:\.\d+)*)")


def roadmap_items(text: str) -> set:
    """("queue", "item") pairs of ROADMAP.md: the numbered items under each
    "### Queue N" heading, and their numbered sub-items as "M.K"."""
    items, queue, top = set(), None, None
    for line in text.splitlines():
        head = re.match(r"### Queue (\d+)\b", line)
        if head:
            queue, top = head.group(1), None
            continue
        if line.startswith("#"):
            queue = None
            continue
        if queue is None:
            continue
        m = re.match(r"(\d+)\. ", line)
        if m:
            top = m.group(1)
            items.add((queue, top))
            continue
        m = re.match(r" {2,}(\d+)\. ", line)
        if m and top is not None:
            items.add((queue, f"{top}.{m.group(1)}"))
    return items


def roadmap_refs(source: str) -> set:
    return {m.groups() for m in ROADMAP_REF.finditer(source)}


@pytest.mark.parametrize("source,items,stale", [
    ('raise X("not ported (ROADMAP.md queue 1 "\n f"item 8); use nn_omp")', {("1", "8")}, []),
    ("# see ROADMAP queue 1 item 2.1\n", {("1", "2")}, [("1", "2.1")]),
    ('"(ROADMAP queue 1 item 9)"', {("1", "8")}, [("1", "9")]),
    ('"ROADMAP.md queue 3 item 1"', {("1", "1")}, [("3", "1")]),
])
def test_roadmap_reference_rule(source, items, stale):
    """The rule itself: references split across string pieces and comment
    lines are found; one naming no item is stale."""
    assert sorted(roadmap_refs(source) - items) == stale


def test_roadmap_items_are_parsed():
    items = roadmap_items("### Queue 1 — x\n\n1. **a**\n   1. b\n   2. c\n8. **d**\n"
                          "### Queue 2 — y\n1. e\n## Other\n5. f\n")
    assert items == {("1", "1"), ("1", "1.1"), ("1", "1.2"), ("1", "8"), ("2", "1")}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_roadmap_references_name_existing_items(path):
    """Every "ROADMAP ... queue N item M" in the port and ``chip_smoke.py``
    names a numbered item (or sub-item) of ROADMAP.md's queue N."""
    items = roadmap_items((REPO / "ROADMAP.md").read_text())
    assert not sorted(roadmap_refs(path.read_text()) - items)


def test_roadmap_references_are_pinned():
    """The port's current references, each to an item that exists."""
    refs = {str(p.relative_to(PORT)): roadmap_refs(p.read_text()) for p in PORT.rglob("*.py")}
    cited = {k: v for k, v in refs.items() if v}
    assert cited == {}
    items = roadmap_items((REPO / "ROADMAP.md").read_text())
    assert ("1", "9") in items and ("1", "4") in items


def stream_inputs(tmp_path):
    """A multipath log, a data directory holding it, and the angle table."""
    from slam_process_tpu_torch.utils.synthetic import (
        synthetic_session_bytes, to_hex_text, write_angle_table)

    (tmp_path / "data").mkdir()
    log = tmp_path / "data" / "live.txt"
    log.write_bytes(to_hex_text(synthetic_session_bytes(
        n_groups=3, frames_per_beam=2, baselines_per_group=3, seed=2, n_paths=3)))
    return log, write_angle_table(tmp_path / "angles.xlsx")


def test_stream_commands_need_cuda_without_falling_back(monkeypatch, tmp_path):
    from slam_process_tpu_torch.io import read_hex_log
    from slam_process_tpu_torch.parallel.streaming_device import DeviceStreamingSession
    from slam_process_tpu_torch.pipeline import cli

    log, angles = stream_inputs(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    common = ["--mapping", str(angles), "--outdir", str(tmp_path / "out")]
    s = DeviceStreamingSession(device="cpu", collect_filtered=True)
    s.feed(read_hex_log(log)[:3000])
    s.save_checkpoint(tmp_path / "device.ckpt")
    for argv in (["replay", "--logs", str(log), *common],
                 ["replay", "--logs", str(log), "--paths", *common],
                 ["watch", "--log", str(log), "--idle-timeout", "0.1", *common],
                 ["watch", "--log", str(log), "--checkpoint", str(tmp_path / "device.ckpt"),
                  *common],
                 *(["run-config", name, "--data-dir", str(tmp_path / "data"), "--mapping",
                    str(angles), "--outdir", str(tmp_path / "cfg")]
                   for name in ("serial_hex_to_excel_v3", "bs_beam_correction",
                                "batched_session", "streaming_replay"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)
    assert not (tmp_path / "out" / "live_filtered.xlsx").exists()


def test_host_engine_makes_no_cuda_call(monkeypatch, tmp_path):
    """``replay`` / ``watch --engine host`` (at the default ``--device
    cuda``) and the host session's readers, checkpoint and ``render()``
    with every ``torch.cuda`` entry point raising."""
    from slam_process_tpu_torch.io import read_hex_log
    from slam_process_tpu_torch.io.angles import load_angle_lut
    from slam_process_tpu_torch.parallel.streaming import StreamingSession, replay_log
    from slam_process_tpu_torch.parallel.streaming_device import make_paths_spec
    from slam_process_tpu_torch.pipeline import cli

    log, angles = stream_inputs(tmp_path)
    spec = make_paths_spec(angles, grid_res=2.0)

    def forbidden(*a, **k):
        raise AssertionError("the host engine called torch.cuda")

    for name in ("is_available", "device_count", "synchronize", "current_stream", "device",
                 "init", "_lazy_init", "get_device_name", "set_device", "current_device"):
        monkeypatch.setattr(torch.cuda, name, forbidden)
    common = ["--mapping", str(angles), "--engine", "host", "--paths", "--changes"]
    assert cli.main(["replay", "--logs", str(log), "--outdir", str(tmp_path / "r"),
                     *common]) == 0
    assert cli.main(["watch", "--log", str(log), "--outdir", str(tmp_path / "w"),
                     "--idle-timeout", "0.1", "--poll-interval", "0.02", "--events",
                     str(tmp_path / "e.jsonl"), "--checkpoint", str(tmp_path / "h.ckpt"),
                     *common]) == 0
    assert (tmp_path / "w" / "live_stream_tracks.xlsx").exists()
    s = replay_log(read_hex_log(log), collect_paths=spec)
    s.save_checkpoint(tmp_path / "s.ckpt")
    r = StreamingSession.restore(tmp_path / "s.ckpt")
    assert r.path_tracks()[0].n_tracks >= 0 and len(r.sweep_times()) == r.n_sweeps_closed
    assert r.render(load_angle_lut(angles)).rgba.shape[2] == 4


def test_estimator_entry_points_need_cuda_without_falling_back(monkeypatch, tmp_path):
    """The estimator programs and the entry points that run them (each a
    CUDA graph per shape on the card) raise without a card at their
    default device, naming ``device='cpu'``, and run their eager bodies
    only where the caller names the CPU."""
    from slam_process_tpu_torch.config import OmpConfig, SmSicConfig
    from slam_process_tpu_torch.models import (
        batch_estimation, fusion, lasso_refine, nn_omp, omp_dense, peak_picking, registry,
        sm_sic, sweep_estimation, tracking)
    from slam_process_tpu_torch.models.dictionary import make_dictionary
    from slam_process_tpu_torch.pipeline.session import Session, sweep_paths_dataset
    from slam_process_tpu_torch.utils.graphs import clear_programs
    from slam_process_tpu_torch.utils.synthetic import (
        synthetic_session_bytes, to_hex_text, write_angle_table)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clear_programs()
    factories = [(nn_omp.nn_omp_program, (OmpConfig(),)),
                 (batch_estimation.batched_program, (OmpConfig(),)),
                 (sweep_estimation.sweep_program, (("nn_omp", OmpConfig(), "positive", False),)),
                 (sm_sic.sm_sic_program, (SmSicConfig(),)), (tracking.track_program, ()),
                 (lasso_refine.lasso_program, (10.0, 0.1)),
                 (omp_dense.omp_dense_program, ()), (fusion.fusion_program, (True,)),
                 (peak_picking.peak_program, (90.0,))]
    for factory, args in factories:
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                factory(*args, device=device)
        assert factory(*args, device="cpu").device == torch.device("cpu")

    path = tmp_path / "s.txt"
    path.write_bytes(to_hex_text(synthetic_session_bytes(
        n_groups=2, frames_per_beam=2, baselines_per_group=3, seed=2, n_paths=3)))
    angles = write_angle_table(tmp_path / "angles.xlsx")
    s = Session.from_log(path, device="cpu")
    matrix, ue, bs = registry.build_scene(s, angles, False)
    d = make_dictionary(ue, bs)
    packed = batch_estimation.pack_scenes([matrix], [d])
    calls = [lambda: nn_omp.run_nn_omp(d, matrix),
             lambda: sm_sic.run_sm_sic(d, matrix, SmSicConfig()),
             lambda: batch_estimation._batched_nn_omp(packed, OmpConfig()),
             lambda: batch_estimation.nn_omp_sessions_device(packed, OmpConfig()),
             lambda: batch_estimation.estimate_sessions([s], angles),
             lambda: sweep_paths_dataset([s], angles),
             lambda: omp_dense.run_omp_dense(ue[:4], bs[:4], matrix[0, :4], ue, bs)]
    calls += [lambda name=name: registry.run_estimator(name, s, angles)
              for name in ("nn_omp", "nn_omp_v1", "sm_sic", "svd", "omp_dense",
                           "lasso_refine", "peak_picking", "fusion", "nn_omp_v13")]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert len(registry.run_estimator("nn_omp", s, angles, device="cpu")) > 0
    clear_programs()


def test_path_tracks_defaults_to_the_device_tracker(monkeypatch, tmp_path):
    """With its defaults, ``Session.path_tracks`` associates through
    ``models/tracking.track_paths`` (the body of ``track_program``: kernel
    K6 in a CUDA graph on the card), never numpy."""
    from slam_process_tpu_torch.models import tracking
    from slam_process_tpu_torch.pipeline import session as session_mod
    from slam_process_tpu_torch.utils.synthetic import (
        synthetic_session_bytes, to_hex_text, write_angle_table)

    path = tmp_path / "s.txt"
    path.write_bytes(to_hex_text(synthetic_session_bytes(
        n_groups=2, frames_per_beam=2, baselines_per_group=3, seed=2, n_paths=3)))
    calls = []
    real = tracking.track_paths
    monkeypatch.setattr(tracking, "track_paths",
                        lambda *a, **k: calls.append(a[0].device) or real(*a, **k))
    monkeypatch.setattr(session_mod, "track_paths_np",
                        lambda *a, **k: pytest.fail("the default went to the numpy tracker"))
    s = session_mod.Session.from_log(path, device="cpu")
    tracks, _, _ = s.path_tracks(write_angle_table(tmp_path / "angles.xlsx"), device="cpu",
                                 grid_res=2.0)
    assert calls == [torch.device("cpu")] and tracks.n_tracks > 0


def test_kernel_wrappers_refuse_cpu_tensors():
    from slam_process_tpu_torch.ops import (
        cuda_compact, cuda_correct, cuda_decode, cuda_nnls, cuda_raster, cuda_sweep_sums,
        cuda_tracker)

    kernels = (cuda_decode, cuda_correct, cuda_raster, cuda_sweep_sums, cuda_compact,
               cuda_tracker, cuda_nnls)
    for m in kernels:
        m.LAUNCHES = 0
    with pytest.raises(ValueError, match="CUDA"):
        cuda_decode.decode_rows_cuda(torch.zeros(22, dtype=torch.uint8), 22, 0xCC, 0x33)
    i32 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_correct.correct_verdicts_cuda(i32, i32, torch.zeros(2, 4), bmax=1, cycle=61_000,
                                           tol=500)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_raster.raster_tiles_cuda(torch.zeros(1, 4, 4), torch.zeros(256, 4),
                                      torch.ones(1, 1), True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sweep_sums.sweep_sums_cuda(i32, i32, i32, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_compact.compact_rows_cuda(torch.zeros(4, 5, dtype=torch.int32),
                                       torch.ones(4, dtype=torch.bool), 4)
    f32 = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_tracker.track_block_cuda(f32, f32, f32, f32 > 0, torch.tensor(3, dtype=torch.int32),
                                      torch.zeros(4, 2), torch.zeros(4, dtype=torch.bool),
                                      torch.tensor(0, dtype=torch.int32), 10.0)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_nnls.nnls_gram_cuda(torch.eye(3)[None], torch.ones(1, 3))
    assert [m.LAUNCHES for m in kernels] == [0] * 7


def test_dispatch_refuses_other_devices():
    from slam_process_tpu_torch.ops.decode import decode_rows

    with pytest.raises(ValueError, match="CUDA or CPU"):
        decode_rows(torch.zeros(22, dtype=torch.uint8, device="meta"))


def test_synthetic_session_is_seeded_and_exact():
    from slam_process_tpu.ops.correct import correct_frames_np
    from slam_process_tpu.ops.decode import decode_frames_np
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes

    kw = dict(n_groups=3, frames_per_beam=2, baselines_per_group=7, junk_frac=0.5,
              big_group=300, seed=4)
    a, b = synthetic_session_bytes(**kw), synthetic_session_bytes(**kw)
    np.testing.assert_array_equal(a, b)
    res = decode_frames_np(a)
    assert res.valid == 64 * (5 + 2 + 2)
    corr = correct_frames_np(res.frames)
    assert corr.n_groups == 3 and corr.n_baselines == 3 * 7


def test_batch_and_multi_stream_need_cuda_without_falling_back(monkeypatch, tmp_path):
    """The batch, the multi-stream session and ``watch --logs`` at their
    default device raise without a card, and run with ``device="cpu"``."""
    from slam_process_tpu_torch.parallel import batch
    from slam_process_tpu_torch.parallel.streaming_device import MultiStreamingSession
    from slam_process_tpu_torch.pipeline import cli

    log, angles = stream_inputs(tmp_path)
    other = tmp_path / "other" / "live.txt"
    other.parent.mkdir()
    other.write_bytes(log.read_bytes())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = np.zeros(100, np.uint8)
    for call in (lambda: batch.run_dataset(None, [raw]),
                 lambda: batch.batched_session_pipeline(None, 256),
                 lambda: MultiStreamingSession(2),
                 lambda: cli.main(["watch", "--logs", str(log), str(other), "--mapping",
                                   str(angles), "--outdir", str(tmp_path / "out"),
                                   "--idle-timeout", "0.1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert int(batch.run_dataset(None, [raw], device="cpu")[0].n_frames) == 0
    assert MultiStreamingSession(2, device="cpu").results()[0].tolist() == [0, 0]


def test_stream_axis_wrappers_refuse_cpu_tensors():
    from slam_process_tpu_torch.ops import cuda_compact, cuda_decode, cuda_tracker

    for m in (cuda_decode, cuda_compact, cuda_tracker):
        m.LAUNCHES = 0
    with pytest.raises(ValueError, match="CUDA"):
        cuda_decode.decode_rows_streams_cuda(torch.zeros((2, 22), dtype=torch.uint8), None,
                                             0xCC, 0x33)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_compact.compact_rows_streams_cuda(torch.zeros((2, 4, 5), dtype=torch.int32),
                                               torch.ones((2, 4), dtype=torch.bool),
                                               [(4, None, None)])
    f32 = torch.zeros(2, 3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_tracker.track_block_streams_cuda(
            f32, f32, f32, f32 > 0, torch.tensor([3, 3], dtype=torch.int32),
            torch.zeros(2, 4, 2), torch.zeros((2, 4), dtype=torch.bool),
            torch.zeros(2, dtype=torch.int32), 10.0)
    assert [m.LAUNCHES for m in (cuda_decode, cuda_compact, cuda_tracker)] == [0] * 3
