#!/usr/bin/env python3
"""Does ``torch.profiler`` lose device activities late in a long process?

    python3 tools/diag_torch_profiler_window.py [--seconds 420] [--every 60]

On the card, a tiny CUDA graph program (``utils/graphs.GraphProgram`` of a
4096-float multiply-add) and its eager body are profiled in windows of
three annotated runs, as ``utils/device_timing.measure_device_time`` does,
at process ages 0, ``--every``, ... ``--seconds`` (the process sleeps in
between).  For each window it prints one JSON line: the device activities
the trace holds and those it attributes to each run, and the clock gaps the
trace shows, in microseconds:

  * ``launch_to_start_min``: the least (activity start - its launching
    call's host start); a kernel cannot start before its launch, so a
    negative value is the device clock reading behind the host's;
  * ``last_end_after_sync``: the last activity's end minus the end of the
    window's final ``cudaDeviceSynchronize``; a positive value is the device
    clock reading ahead of the host's.

Each age runs the bare window (``pad_ms`` [0, 0]), with ``--pad-ms`` of
host sleep after the window opens, and with it before the window closes;
then ``measure_device_time`` itself, whose window runs a sentinel before
the runs: how many of the sentinel's activities the trace lost (``lost``),
the activities of each run, or the error it raised.  The header line
records the environment's ``TEARDOWN_CUPTI`` (the profiler's switch for
tearing CUPTI down after each trace).  One JSON line a window on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def window(torch, call, pad_start_ms: float, pad_end_ms: float, n: int = 3) -> dict:
    """One profiler window of ``n`` annotated runs of ``call()``, with host
    sleeps of ``pad_start_ms`` after it opens and ``pad_end_ms`` before it
    closes."""
    from torch.profiler import ProfilerActivity, profile

    from slam_process_tpu_torch.utils.device_timing import (
        LAUNCH_CATEGORIES, RUN_RANGE, _activities, _by_range, _trace_events)
    from slam_process_tpu_torch.utils.profiling import annotate

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_start_ms / 1e3)
            for _ in range(n):
                with annotate(RUN_RANGE):
                    call()
            torch.cuda.synchronize()
            time.sleep(pad_end_ms / 1e3)
        prof.export_chrome_trace(str(Path(d) / "trace.json"))
        events = _trace_events([Path(d) / "trace.json"])
    acts = _activities(events)
    runs, outside = _by_range(events)
    syncs = [float(e["ts"]) + float(e.get("dur", 0.0)) for e in events
             if e.get("cat") in LAUNCH_CATEGORIES and "Synchronize" in str(e.get("name", ""))]
    gaps = [a.start - a.launch for a in acts if a.launch is not None]
    return {"pad_ms": [pad_start_ms, pad_end_ms], "activities": len(acts),
            "per_run": [len(x) for x in runs.get(RUN_RANGE, [])], "unattributed": len(outside),
            "launch_to_start_min": min(gaps) if gaps else None,
            "last_end_after_sync": (max(a.end for a in acts) - max(syncs)
                                    if acts and syncs else None)}


def measured(torch, call, n: int = 3) -> dict:
    """``measure_device_time`` of ``n`` runs of ``call()``: the sentinel
    activities the trace lost, the activities of each run, each run's
    device us, or the error it raised."""
    from slam_process_tpu_torch.utils.device_timing import (
        RUN_RANGE, _by_range, _trace_events, measure_device_time)

    with tempfile.TemporaryDirectory() as d:
        try:
            t = measure_device_time(lambda i: call(), n=n, trace_dir=d)
        except RuntimeError as e:
            return {"measure_device_time": str(e)[:160]}
        runs, _ = _by_range(_trace_events([Path(d) / "trace.json"]))
    return {"measure_device_time": "ok", "lost": t.lost,
            "per_run": [len(x) for x in runs[RUN_RANGE]], "runs_us": [r * 1e6 for r in t.runs]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--seconds", type=float, default=420.0)
    ap.add_argument("--every", type=float, default=60.0)
    ap.add_argument("--pad-ms", type=float, default=20.0)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    from slam_process_tpu_torch.utils.graphs import GraphProgram

    if not torch.cuda.is_available():
        raise SystemExit("diag_torch_profiler_window: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    prog = GraphProgram(lambda x: x * 2.0 + 1.0, dev, 1)
    x = torch.arange(4096, dtype=torch.float32, device=dev)
    prog(x)
    forms = {"graph": lambda: prog(x), "eager": lambda: prog.body(x)}
    t0 = time.monotonic()
    print(json.dumps({"card": card.strip(), "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI")}), flush=True)
    while True:
        age = time.monotonic() - t0
        for form, call in forms.items():
            for pads in ((0.0, 0.0), (args.pad_ms, 0.0), (0.0, args.pad_ms)):
                row = {"age_s": round(age, 1), "form": form, **window(torch, call, *pads)}
                print(json.dumps(row), flush=True)
            row = {"age_s": round(age, 1), "form": form, **measured(torch, call)}
            print(json.dumps(row), flush=True)
        if age + args.every > args.seconds:
            break
        time.sleep(max(0.0, t0 + age + args.every - time.monotonic()))


if __name__ == "__main__":
    main()
