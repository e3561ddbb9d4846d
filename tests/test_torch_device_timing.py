"""The port's device timing (slam_process_tpu_torch/utils/device_timing.py)
and ``utils/profiling.annotate``.

On the CPU: ``measure_device_time(device="cpu")`` gives n wall times, each
``call(i)`` run exactly once, with ``median`` and ``total``; without a card
``measure_device_time()`` raises and calls nothing.  ``op_device_times``
and ``module_device_times`` (and ``op_device_counts``) read a small
handwritten Chrome trace in the
layout ``torch.profiler`` exports: device activities (kernels, a copy, a
memset) with the correlation ids of their launches, ``annotate`` ranges,
nested ranges, overlapping intervals (counted once), the profiler's own
buffer rows and ``gpu_user_annotation`` spans (not counted), an activity
launched outside every range; and the per-run attribution of
``measure_device_time`` on such a trace, which refuses a window with no
device work, an activity it cannot attribute, and a filter matching
nothing.  A real CPU trace of ``annotate`` ranges gives the ranges with no
device time.  The card's run: ``tests/test_torch_cuda.py``.
"""

import json

import pytest
import torch

from slam_process_tpu_torch.utils import device_timing
from slam_process_tpu_torch.utils.device_timing import (
    RUN_RANGE, DeviceTiming, interval_union, measure_device_time, module_device_times,
    op_device_counts, op_device_times)
from slam_process_tpu_torch.utils.profiling import annotate, trace


def test_measure_on_cpu_calls_each_index_once():
    seen = []

    def call(i):
        seen.append(i)
        return torch.ones(64) * i

    t = measure_device_time(call, n=4, device="cpu")
    assert seen == [0, 1, 2, 3]
    assert isinstance(t, DeviceTiming) and len(t.runs) == 4
    assert t.module == "<cpu-wall>" and t.all_modules == {"<cpu-wall>": t.runs}
    assert all(r >= 0 for r in t.runs)
    assert t.median == sorted(t.runs)[2]
    assert t.total == pytest.approx(sum(t.runs))


def test_measure_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = []
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            measure_device_time(seen.append, device=device)
    assert seen == []


@pytest.mark.parametrize("intervals,length", [
    ([], 0.0), ([(0, 5)], 5.0), ([(0, 5), (3, 8)], 8.0), ([(0, 10), (2, 4)], 10.0),
    ([(6, 9), (0, 2)], 5.0), ([(0, 4), (0, 1), (0, 4)], 4.0), ([(1, 1), (2, 3)], 1.0)],
    ids=["none", "one", "overlap", "nested", "unsorted", "equal_starts", "empty_interval"])
def test_interval_union(intervals, length):
    assert interval_union(intervals) == length


def x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": dur,
            "args": args}


def launch(name, ts, corr):
    return x("cuda_runtime", name, ts, 2.0, cbid=211, correlation=corr)


def handwritten(range_name="step"):
    """Two occurrences of ``range_name`` (the second holding an "inner"
    range) and one activity launched outside both; times in us."""
    return [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "args": {"name": "python"}},
        x("user_annotation", range_name, 100.0, 50.0), x("cpu_op", "aten::mm", 105.0, 20.0),
        launch("cudaLaunchKernel", 110.0, 1), launch("cudaLaunchKernel", 120.0, 2),
        launch("cudaMemcpyAsync", 130.0, 3),
        x("user_annotation", range_name, 200.0, 50.0), x("user_annotation", "inner", 210.0, 10.0),
        x("cuda_driver", "cuLaunchKernel", 215.0, 2.0, correlation=4),
        launch("cudaMemsetAsync", 230.0, 5), launch("cudaLaunchKernel", 400.0, 6),
        # Device side: k_a and k_b overlap (15 us of union), then a copy.
        x("kernel", "k_a", 1000.0, 10.0, device=0, stream=7, correlation=1),
        x("kernel", "k_b", 1005.0, 10.0, device=0, stream=8, correlation=2),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1020.0, 5.0, correlation=3),
        x("kernel", "k_a", 2000.0, 8.0, device=0, stream=7, correlation=4),
        x("gpu_memset", "Memset (Device)", 2004.0, 8.0, correlation=5),
        x("gpu_user_annotation", range_name, 2000.0, 12.0),
        x("gpu_memcpy", "Activity Buffer Request", 2100.0, 40.0),
        x("kernel", "k_c", 3000.0, 7.0, correlation=6),
        {"ph": "s", "id": 1, "pid": 1, "tid": 1, "ts": 110.0, "cat": "ac2g", "name": "ac2g"},
        {"ph": "f", "id": 1, "pid": 0, "tid": 7, "ts": 1000.0, "cat": "ac2g", "name": "ac2g",
         "bp": "e"},
    ]


def write(path, events):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": events}))


def test_module_and_op_device_times_on_a_handwritten_trace(tmp_path):
    write(tmp_path / "run" / "trace.json", handwritten())
    (tmp_path / "notes.json").write_text(json.dumps({"other": 1}))   # not a trace
    got = module_device_times(tmp_path)
    assert set(got) == {"step", "inner"}
    assert got["step"] == pytest.approx([20e-6, 12e-6], abs=1e-12)
    assert got["inner"] == pytest.approx([8e-6], abs=1e-12)
    assert op_device_counts(tmp_path) == {"k_a": 2, "k_b": 1, "k_c": 1, "Memset (Device)": 1,
                                          "Memcpy DtoH (Device -> Pageable)": 1}
    ops = op_device_times(tmp_path)
    assert ops == pytest.approx({"k_a": 18e-6, "k_b": 10e-6, "k_c": 7e-6,
                                 "Memcpy DtoH (Device -> Pageable)": 5e-6,
                                 "Memset (Device)": 8e-6}, abs=1e-12)


def test_measure_attribution_on_a_handwritten_trace():
    events = [e for e in handwritten(RUN_RANGE) if e.get("name") not in ("k_c",)]
    t = device_timing._timing(events, 2, None)
    assert t.module == "<all>"
    assert t.runs == pytest.approx([20e-6, 12e-6], abs=1e-12)
    assert t.median == pytest.approx(20e-6) and t.total == pytest.approx(32e-6)
    assert t.all_modules == pytest.approx({
        "k_a": [10e-6, 8e-6], "k_b": [10e-6, 0.0], "Memcpy DtoH (Device -> Pageable)": [5e-6, 0.0],
        "Memset (Device)": [0.0, 8e-6]}, abs=1e-12)
    only = device_timing._timing(events, 2, "k_")
    assert only.module == "k_" and only.runs == pytest.approx([15e-6, 8e-6], abs=1e-12)
    assert only.all_modules == t.all_modules


def test_measure_refuses_what_it_cannot_attribute():
    events = handwritten(RUN_RANGE)
    with pytest.raises(RuntimeError, match="could not be attributed"):
        device_timing._timing(events, 2, None)          # k_c: launched outside the runs
    with pytest.raises(RuntimeError, match="3 runs"):
        device_timing._timing(events, 3, None)
    host_only = [e for e in events if e.get("cat") not in device_timing.DEVICE_CATEGORIES]
    with pytest.raises(RuntimeError, match="no device activity"):
        device_timing._timing(host_only, 2, None)
    kept = [e for e in events if e.get("name") != "k_c"]
    with pytest.raises(RuntimeError, match="no device activity matching 'gemm'"):
        device_timing._timing(kept, 2, "gemm")
    # A launch the trace lost: the activity cannot be placed in a run.
    lost = [e for e in kept if e.get("args", {}).get("correlation") != 5
            or e.get("cat") != "cuda_runtime"]
    with pytest.raises(RuntimeError, match="could not be attributed"):
        device_timing._timing(lost, 2, None)


def test_measure_refuses_a_run_whose_activities_the_trace_lost():
    """A run with no device activity beside runs with some is a lost trace,
    not a run of 0 s."""
    kept = [e for e in handwritten(RUN_RANGE) if e.get("name") != "k_c"]
    lost = [e for e in kept if e.get("cat") not in device_timing.DEVICE_CATEGORIES
            or e.get("args", {}).get("correlation") not in (4, 5)]
    with pytest.raises(device_timing.TraceLostError,
                       match=r"runs \[1\] of 2 .* lost activities"):
        device_timing._timing(lost, 2, None)


def test_measure_counts_and_refuses_a_lost_sentinel(tmp_path):
    """The sentinel range before the runs: how many of its activities the
    trace dropped is ``lost``; a trace that dropped them all raises; the
    per-name totals leave the sentinel out."""
    kept = [e for e in handwritten(RUN_RANGE) if e.get("name") != "k_c"]
    n = device_timing.SENTINEL_LAUNCHES
    sentinel = [x("user_annotation", device_timing.SENTINEL_RANGE, 10.0, 50.0)]
    for i in range(3):
        sentinel += [launch("cudaLaunchKernel", 20.0 + i, 100 + i),
                     x("kernel", "add", 500.0 + i, 0.5, correlation=100 + i)]
    t = device_timing._timing(kept + sentinel, 2, None)
    assert t.lost == n - 3 and t.runs == pytest.approx([20e-6, 12e-6], abs=1e-12)
    write(tmp_path / "trace.json", kept + sentinel)
    assert "add" not in op_device_counts(tmp_path) and "add" not in op_device_times(tmp_path)
    assert device_timing._timing(kept, 2, None).lost is None
    none_left = [e for e in sentinel if e.get("cat") != "kernel"]
    with pytest.raises(device_timing.TraceLostError, match=f"lost all {n} sentinel"):
        device_timing._timing(kept + none_left, 2, None)


def test_annotate_ranges_in_a_cpu_trace(tmp_path):
    with trace(tmp_path):
        for _ in range(2):
            with annotate("window"):
                torch.ones(16).mul_(2)
        with annotate("flush"):
            torch.zeros(4).add_(1)
    assert module_device_times(tmp_path) == {"window": [0.0, 0.0], "flush": [0.0]}
    assert op_device_times(tmp_path) == {} and op_device_counts(tmp_path) == {}
    with annotate("outside a trace"):
        pass
