#!/usr/bin/env python3
"""Two device-time instruments on one full-size session call, on the card.

    python3 tools/diag_torch_device_time.py

In a fresh process, for the eager body (``session_pipeline``) and for its
CUDA graph (``compiled_session_pipeline``), both on the full session's
padded bytes already on the card: ``chip_smoke.device_profile``'s busy ms
and activities of one call, and ``utils/device_timing.measure_device_time``'s
ms per run (3 runs) with the activities it placed, the activity names most
often seen and the longest activities.  Prints one JSON line per form.
``chip_smoke.py``'s ``profile`` phase runs the same ``device_profile`` late
in a long process; this tool gives the fresh-process reading beside it.
"""

from __future__ import annotations

import collections
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> None:
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as cs
    from slam_process_tpu_torch.pipeline.device import (
        bucket_size, compiled_session_pipeline, device_lut, pad_bytes, session_pipeline)
    from slam_process_tpu_torch.utils.device_timing import (
        _activities, _trace_events, measure_device_time)
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes

    if not torch.cuda.is_available():
        raise SystemExit("diag_torch_device_time: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    raw = synthetic_session_bytes(**cs.FULL)
    n = bucket_size(len(raw))
    padded = torch.from_numpy(pad_bytes(raw, n)).to(dev)
    lut = device_lut(dev)
    fn = compiled_session_pipeline(n, device=dev)
    for form, call in (("eager", lambda: session_pipeline(padded, lut)),
                       ("graph", lambda: fn(padded, lut))):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        busy, acts, top = cs.device_profile(torch, call)
        with tempfile.TemporaryDirectory() as d:
            t = measure_device_time(lambda i: call(), n=3, trace_dir=d)
            placed = _activities(_trace_events([Path(d) / "trace.json"]))
        names = collections.Counter(a.name[:50] for a in placed)
        print(json.dumps({
            "form": form, "device_profile_busy_ms": busy, "device_profile_activities": acts,
            "device_profile_top_us": top[:5],
            "measure_device_time_runs_ms": [r * 1e3 for r in t.runs],
            "measure_device_time_activities_per_run": len(placed) / 3,
            "names": names.most_common(8),
            "longest_us": sorted(((round(a.end - a.start, 1), a.name[:40]) for a in placed),
                                 reverse=True)[:6]}), flush=True)


if __name__ == "__main__":
    main()
