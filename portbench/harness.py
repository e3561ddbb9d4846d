"""One run of one benchmark cell: set-up, the measured window, the check.

``run`` reads the cell from ``portbench/workloads/<cell>.json``, its
configuration from ``portbench/configs/<config>.json`` and the metrics the
cell reports from ``BENCHMARK.json``; the cell names its driver
(``portbench/drivers/<driver>.py``), and each per-layer metric is read by
``portbench/metrics/<metric>.py`` from the traced window and the kernels'
counts (``portbench/counts/<kernel>.py``).  So a cell, a configuration or a
metric is added as files and entries only.

A driver is a class ``Cell(config, workload, seed, device)`` with
``setup()`` (make the traffic, warm up every shape the window uses),
``window(seconds, spans)`` (run units until the deadline, finish the one in
flight; returns a dict with ``attempted``, ``failed`` and its end-to-end
measures), ``tail()`` (finish the units still in flight, outside the
window), ``release()`` (drop the program's state), ``judge()`` (the
reference's comparison: ``[(name, value, limit), ...]``) and
``traffic_stats()`` (what the last window fed, for the counts).  A
``--trace 1`` run calls ``window`` twice where the cell has a per-layer
metric timed by the host's clock: untraced for that metric, then traced.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "slam_process_tpu")
# Per-layer metrics whose numbers the host's clock gives.
HOST_SOURCES = ("host_clock", "program_span")
# A --trace 1 run measures (and traces) a window of at most this many
# seconds: its per-layer metrics need no more, and reading the trace of a
# longer one would take minutes.
TRACE_SECONDS = 10.0


class NoDevice(RuntimeError):
    """The run cannot measure: no CUDA device, too few, or no program."""


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path) -> ModuleType:
    """A module from a file of the benchmark (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_file_{abs(hash(str(path)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(name: str, root: Path = ROOT):
    """(benchmark manifest, workload, configuration) of cell ``name``."""
    bench = load_json(root / "BENCHMARK.json")
    wl_path = root / "portbench" / "workloads" / f"{name}.json"
    if not wl_path.exists():
        raise SystemExit(f"portbench: no workload file {wl_path.relative_to(root)}")
    wl = load_json(wl_path)
    cfg = load_json(root / "portbench" / "configs" / f"{wl['config']}.json")
    return bench, wl, cfg


def cell_metrics(bench: dict, name: str):
    """(end-to-end entries, per-layer entries) the cell reports."""
    def applies(m):
        return "workloads" not in m or name in m["workloads"]
    return ([m for m in bench["end_to_end"] if applies(m)],
            [m for m in bench["per_layer"] if applies(m)])


def quantile(values, q: float) -> float:
    """The q quantile by linear interpolation between order statistics."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = q * (len(v) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache of the run inside the checkout, at fixed
    paths (the kernels' own build goes to ``<checkout>/build``)."""
    base = root / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def device_check(chips: int, device: Optional[str]):
    """The CUDA device to run on; raises ``NoDevice`` without one (there is
    no fall-back to the CPU)."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False: this benchmark measures a CUDA card")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} CUDA devices; {torch.cuda.device_count()} "
                       "are visible")
    return torch.device("cuda", 0)


def power_limit() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a per-layer metric's reader reads: the traced window (``trace``),
    its spans and counts (``spans``, ``stats``), the kernels' least times
    (``bound_s``: kernel name -> seconds, from ``portbench/counts``) and the
    spans of the untraced window that runs before it where the cell has a
    per-layer metric timed by the host's clock (``host_spans``)."""

    def __init__(self, trace, stats: dict, bound_s: dict, spans, host_spans):
        self.trace = trace
        self.stats = stats
        self.bound_s = bound_s
        self.spans = spans
        self.host_spans = host_spans


def kernel_bounds(stats: dict, root: Path = ROOT) -> dict:
    """{kernel: least seconds} of every ``portbench/counts/<kernel>.py``
    whose ``work(stats)`` finds its traffic in ``stats``."""
    peaks = load_module(root / "portbench" / "counts" / "peaks.py")
    out = {}
    for path in sorted((root / "portbench" / "counts").glob("*.py")):
        if path.stem in ("peaks", "__init__"):
            continue
        work = load_module(path).work(stats)
        if work is not None:
            out[path.stem] = peaks.least_seconds(*work)
    return out


def run(name: str, seed: int, seconds: float, trace: bool, *, device=None,
        root: Path = ROOT, t_start: Optional[float] = None, out=sys.stdout,
        err=sys.stderr) -> int:
    """One run of cell ``name``; prints the result line and returns the
    exit code (0 only where a result was printed).  ``device`` set (a
    test's "cpu") skips the look for a card."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench, wl, cfg = cell_files(name, root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        print(f"portbench: {name} is not a cell of BENCHMARK.json", file=err)
        return 2
    e2e, per_layer = cell_metrics(bench, name)
    cache_dirs(root)
    try:
        import slam_process_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as exc:
        print(f"portbench: the program is not in this checkout: {exc}", file=err)
        return 3
    import torch

    try:
        dev = device_check(entry["chips"], device)
    except NoDevice as exc:
        print(f"portbench: {exc}", file=err)
        return 3
    from portbench.trace import SENTINEL_LAUNCHES, Spans, Trace, profiled

    files = root / "portbench"
    driver = load_module(files / "drivers" / f"{wl['driver']}.py")
    cell = driver.Cell(cfg, wl, seed, dev)
    cell.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    spans = Spans(trace and dev.type == "cuda")
    # Per-layer metrics timed by the host's clock are read from a window of
    # their own that runs untraced, before the traced one: the profiler's
    # cost per operation would otherwise be in them.
    host_spans = Spans(False)
    host_window = trace and any(m["source"] in HOST_SOURCES for m in per_layer)
    traced = None
    try:
        if host_window:
            cell.window(min(seconds, TRACE_SECONDS), host_spans)
        if trace and dev.type == "cuda":
            with profiled(dev) as holder:
                stats = cell.window(min(seconds, TRACE_SECONDS), spans)
            traced = holder.trace
        else:
            t0 = time.perf_counter()
            stats = cell.window(seconds, spans)
            if trace:      # a CPU test's run: the readers see no device activity
                traced = Trace([], [], time.perf_counter() - t0, None)
        cell.tail()
        stats.update(attempted=cell.attempted, failed=cell.failed)
    except Exception as exc:   # a unit raised: the run is not correct, and says why
        import traceback

        traceback.print_exc(file=err)
        stats = {"attempted": getattr(cell, "attempted", 1), "failed": max(1, getattr(
            cell, "failed", 1)), "error": f"{type(exc).__name__}: {exc}"}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    cell.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = [] if "error" in stats else cell.judge()
    correct = ("error" not in stats and stats["attempted"] > 0 and stats["failed"] == 0
               and all(v <= lim for _, v, lim in checks))
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": entry["chips"], "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device_info["power_limit_w"] = power_limit()
    metrics, breakdown = {}, None
    if trace:
        ctx = None
        if traced is not None and traced.sentinel_lost == SENTINEL_LAUNCHES:
            print(f"portbench: the trace lost all {SENTINEL_LAUNCHES} sentinel activities, so it "
                  "may have lost the window's first ones too: no per-layer metric is read from it",
                  file=err)
            return 5
        if traced is not None and "error" not in stats:
            device_info["busy_s"] = traced.busy_s
            device_info["window_s"] = traced.window_s
            device_info["trace_sentinel_lost"] = traced.sentinel_lost
            tstats = cell.traffic_stats()
            ctx = Context(traced, {**stats, **tstats}, kernel_bounds(tstats, root), spans,
                          host_spans)
            top = sorted(traced.by_name().items(), key=lambda kv: -kv[1])[:10]
            gaps = sorted(traced.idle_gaps().items(), key=lambda kv: -kv[1])[:10]
            breakdown = {"device_ops": [[n[:120], s] for n, s in top],
                         "idle_gaps": [[n, s] for n, s in gaps]}
        for m in per_layer:
            if ctx is None:
                continue
            value = load_module(files / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measures = {**stats, "setup_s": setup_s}
        for m in e2e:
            if m["name"] in measures and math.isfinite(measures[m["name"]]):
                metrics[m["name"]] = {"value": measures[m["name"]], "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}; the port's benchmark may load neither "
              "JAX nor the JAX package", file=err)
        return 4
    spent = {k: [len(v), round(sum(v), 6)] for k, v in spans.seconds.items()}
    print(f"window: {json.dumps({k: v for k, v in stats.items() if isinstance(v, (int, float))})} "
          f"spans (calls, host s): {json.dumps(spent)}", file=err)
    for n, v, lim in checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=err)
    if "error" in stats:
        print(f"check error: {stats['error']}", file=err)
    result = {"correct": bool(correct), "attempted": int(stats["attempted"]),
              "failed": int(stats["failed"]), "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                        for n, v, lim in checks}
    print(json.dumps(result), file=out, flush=True)
    return 0
