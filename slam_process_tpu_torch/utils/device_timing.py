"""Device time of a callable on the card, from ``torch.profiler`` traces.

The counterpart of ``slam_process_tpu/utils/device_timing.py``.  A host
clock around a call measures the host's issue as much as the device's
work, so the device seconds come from the profiler's CUDA activities
(CUPTI): each kernel, copy and memset with its begin and end on the
device.  A run's device seconds are the union of the intervals of the
device activities it launched (categories ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` of the Chrome trace; not the profiler's own "Activity
Buffer" rows, nor ``gpu_user_annotation`` spans, which would count
kernels twice), so work that overlaps on several streams counts once.

Attribution is by correlation id, not by time: every device activity
carries the correlation id of the host call that launched it (a
``cuda_runtime`` or ``cuda_driver`` event), and the activity belongs to
each named range (``utils/profiling.annotate``, a ``user_annotation``
event) whose host interval holds that launch.  So the calls need no
synchronization between them: run i's kernels count for run i even where
they run on the device after run i + 1 was issued.

  * ``measure_device_time(call, n)`` runs ``call(i)`` n times in one
    profiler window, each inside ``annotate(RUN_RANGE)``, after a sentinel
    of small device operations that shows what the window lost, and
    returns the per-run device seconds (``DeviceTiming``);
    ``device="cpu"`` gives wall seconds per call on the host instead, as
    the JAX package's CPU branch does.
  * ``module_device_times(trace_dir)``: per-run device seconds of every
    named range in a trace that ``utils/profiling.trace`` or
    ``measure_device_time(trace_dir=...)`` wrote.
  * ``op_device_times(trace_dir)``: total device seconds per activity name;
    ``op_device_counts(trace_dir)``: how many activities of each name ran.
  * ``interval_union``: the length of a union of intervals.
"""

from __future__ import annotations

import bisect
import json
import shutil
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

import torch

from slam_process_tpu_torch.utils.profiling import annotate

__all__ = [
    "DeviceTiming",
    "TraceLostError",
    "interval_union",
    "measure_device_time",
    "module_device_times",
    "op_device_counts",
    "op_device_times",
]

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
RUN_RANGE = "measure_device_time"    # the range around each run of measure_device_time
SENTINEL_RANGE = "measure_device_time_sentinel"   # the range before a window's runs
SENTINEL_LAUNCHES = 256              # one-element adds in the sentinel range


class TraceLostError(RuntimeError):
    """The profiler's trace lost device activities of a window: every
    sentinel activity, or every activity of some runs but not of others."""


class DeviceTiming(NamedTuple):
    """Result of ``measure_device_time``."""

    runs: List[float]                      # device seconds per call, in order
    module: str                            # the activity-name filter ("<all>": none)
    all_modules: Dict[str, List[float]]    # activity name -> device seconds per call
    lost: Optional[int] = None             # sentinel activities the trace lost (None: none run)

    @property
    def median(self) -> float:
        s = sorted(self.runs)
        return s[len(s) // 2]

    @property
    def total(self) -> float:
        return sum(self.runs)


class _Activity(NamedTuple):
    name: str
    start: float      # us, the trace's clock
    end: float
    launch: Optional[float]   # us, host time of the launching call (None: not in the trace)


def interval_union(intervals: Iterable) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, reach = 0.0, float("-inf")
    for lo, hi in sorted(intervals, key=lambda iv: iv[0]):
        lo = max(lo, reach)
        total += max(hi - lo, 0.0)
        reach = max(reach, hi)
    return total


def _trace_events(paths) -> list:
    events = []
    for path in paths:
        data = json.loads(Path(path).read_text())
        if isinstance(data, dict):
            data = data.get("traceEvents", [])
        events.extend(e for e in data if isinstance(e, dict))
    return events


def _trace_dir_events(trace_dir) -> list:
    """The events of every Chrome trace (``*.json``) under ``trace_dir``."""
    return _trace_events(sorted(Path(trace_dir).rglob("*.json")))


def _activities(events) -> List[_Activity]:
    launches = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATEGORIES and corr is not None:
            launches[corr] = float(e["ts"])
    out = []
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
                and not str(e.get("name", "")).startswith("Activity Buffer")):
            ts = float(e["ts"])
            out.append(_Activity(e["name"], ts, ts + float(e.get("dur", 0.0)),
                                 launches.get(e.get("args", {}).get("correlation"))))
    return out


def _by_range(events):
    """({range name: [activities launched inside each occurrence, in time
    order]}, activities launched inside no range)."""
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                    for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    starts = [lo for lo, _, _ in ranges]
    per = [[] for _ in ranges]
    outside = []
    for a in _activities(events):
        hit = False
        if a.launch is not None:
            for i in range(bisect.bisect_right(starts, a.launch)):
                if ranges[i][1] >= a.launch:
                    per[i].append(a)
                    hit = True
        if not hit:
            outside.append(a)
    out: Dict[str, list] = defaultdict(list)
    for (_, _, name), acts in zip(ranges, per):
        out[name].append(acts)
    return dict(out), outside


def _seconds(acts) -> float:
    return interval_union((a.start, a.end) for a in acts) / 1e6


def module_device_times(trace_dir) -> Dict[str, List[float]]:
    """Device seconds of every named range in the Chrome traces under
    ``trace_dir``: {range name: [seconds per occurrence, in time order]},
    each the union of the intervals of the device activities launched
    inside that occurrence (a range with no device work gives 0.0)."""
    runs, _ = _by_range(_trace_dir_events(trace_dir))
    return {name: [_seconds(acts) for acts in occ] for name, occ in runs.items()}


def _measured(events) -> List[_Activity]:
    """The device activities of ``events`` but those launched inside a
    ``measure_device_time`` sentinel range."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") == SENTINEL_RANGE]
    return [a for a in _activities(events)
            if a.launch is None or not any(lo <= a.launch <= hi for lo, hi in spans)]


def op_device_times(trace_dir) -> Dict[str, float]:
    """Total device seconds per activity name (kernel, copy, memset) across
    the Chrome traces under ``trace_dir``, but a ``measure_device_time``
    sentinel's."""
    out: Dict[str, float] = defaultdict(float)
    for a in _measured(_trace_dir_events(trace_dir)):
        out[a.name] += (a.end - a.start) / 1e6
    return dict(out)


def op_device_counts(trace_dir) -> Dict[str, int]:
    """Device activities per activity name across the Chrome traces under
    ``trace_dir`` (how many kernels, copies and memsets ran), but a
    ``measure_device_time`` sentinel's."""
    out: Dict[str, int] = defaultdict(int)
    for a in _measured(_trace_dir_events(trace_dir)):
        out[a.name] += 1
    return dict(out)


def _timing(events, n: int, module: Optional[str]) -> DeviceTiming:
    """``measure_device_time``'s result from its window's events."""
    runs, outside = _by_range(events)
    occ = runs.get(RUN_RANGE, [])
    sentinel = runs.get(SENTINEL_RANGE)
    lost = None if sentinel is None else SENTINEL_LAUNCHES - sum(map(len, sentinel))
    if lost == SENTINEL_LAUNCHES:
        raise TraceLostError(f"the trace lost all {SENTINEL_LAUNCHES} sentinel activities "
                             "that ran before the runs, so it may have lost some of the runs'")
    if len(occ) != n:
        raise RuntimeError(f"the trace holds {len(occ)} '{RUN_RANGE}' ranges for {n} runs")
    if not any(occ):
        raise RuntimeError(f"no device activity captured in {n} runs; does the callable "
                           "launch work on the CUDA device?")
    if not all(occ):
        raise TraceLostError(f"no device activity captured in runs "
                             f"{[i for i, acts in enumerate(occ) if not acts]} of {n} while "
                             "the others hold some: the trace lost activities")
    if outside:
        names = sorted({a.name[:60] for a in outside})[:5]
        raise RuntimeError(f"{len(outside)} device activities could not be attributed to a run "
                           f"by their launch's correlation id: {names}")
    if module is not None:
        occ = [[a for a in acts if module in a.name] for acts in occ]
        if not any(occ):
            raise RuntimeError(f"no device activity matching {module!r}; saw "
                               f"{sorted({a.name[:60] for acts in runs[RUN_RANGE] for a in acts})}")
    names = sorted({a.name for acts in runs[RUN_RANGE] for a in acts})
    all_modules = {name: [_seconds([a for a in acts if a.name == name])
                          for acts in runs[RUN_RANGE]] for name in names}
    return DeviceTiming(runs=[_seconds(acts) for acts in occ],
                        module="<all>" if module is None else module, all_modules=all_modules,
                        lost=lost)


def measure_device_time(call: Callable[[int], object], n: int = 3, module: Optional[str] = None,
                        trace_dir=None, device=None) -> DeviceTiming:
    """Device seconds of each of ``n`` runs of ``call(i)`` (each index
    called exactly once), on the CUDA ``device`` (None: CUDA).

    The runs share one ``torch.profiler`` window (CPU and CUDA activities),
    each inside ``annotate(RUN_RANGE)``, with one synchronization before
    the window and one at its end; a run's device seconds are the union of
    the intervals of the device activities it launched, attributed by
    correlation id (module docstring).  Warm ``call`` up first: the first
    call of a shape may build kernels or plan cuBLAS work.  ``module``
    keeps only activities whose name holds it (None: all); ``all_modules``
    maps every activity name to its seconds per run.  ``trace_dir`` keeps
    the window's Chrome trace there (``trace.json``) for
    ``module_device_times`` / ``op_device_times``.

    Late in a process, a ``torch.profiler`` window on the card has been
    seen to drop the first device activities it records, a number that
    grows with the process's age (``tools/diag_torch_profiler_window.py``).
    So before the runs the window runs ``SENTINEL_LAUNCHES`` one-element
    adds in the range ``SENTINEL_RANGE``: the runs' activities come after
    them, and ``lost`` is how many of them the trace dropped.

    Raises ``TraceLostError`` where the trace lost every sentinel activity
    or every activity of some runs but not of others (every run of one
    callable launches work), and ``RuntimeError`` where there is no CUDA
    device (unless ``device="cpu"``), where the window captured no device
    activity in any run, and where an activity cannot be attributed to a
    run: it never returns host time for device time, nor a run's 0 for a
    lost trace.
    ``device="cpu"`` gives wall seconds per call on the host (``module``
    "<cpu-wall>"), the JAX package's CPU measure.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        runs = []
        for i in range(n):
            t0 = time.perf_counter()
            call(i)
            runs.append(time.perf_counter() - t0)
        return DeviceTiming(runs=runs, module="<cpu-wall>", all_modules={"<cpu-wall>": runs})
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"measure_device_time needs a CUDA device, not {dev}; pass "
                           "device='cpu' for wall seconds per call on the host")
    from torch.profiler import ProfilerActivity, profile

    own = trace_dir is None
    out_dir = Path(tempfile.mkdtemp(prefix="slam_devtime_")) if own else Path(trace_dir)
    try:
        sentinel = torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with annotate(SENTINEL_RANGE):
                for _ in range(SENTINEL_LAUNCHES):
                    sentinel.add_(1.0)
            for i in range(n):
                with annotate(RUN_RANGE):
                    call(i)
            torch.cuda.synchronize(dev)
        out_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out_dir / "trace.json"))
        return _timing(_trace_events([out_dir / "trace.json"]), n, module)
    finally:
        if own:
            shutil.rmtree(out_dir, ignore_errors=True)
