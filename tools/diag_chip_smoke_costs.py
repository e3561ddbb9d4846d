#!/usr/bin/env python3
"""``chip_smoke.py`` with the host time of its CUDA graphs' captures, its
stream sessions and ``torch.cuda.empty_cache`` counted phase by phase.

    python3 tools/diag_chip_smoke_costs.py [CHECKOUT]

Runs ``chip_smoke.main()`` of CHECKOUT (default: this repo) unchanged,
with host-clock accounting wrapped around ``GraphRunner``'s warm-up and
capture, the stream sessions' ``__init__`` / ``feed`` / ``finalize``,
``streaming_device._drain``, the batch's ``_issue`` and
``torch.cuda.empty_cache``.  After each phase line of ``chip_smoke.py``
(its standard output, unchanged) it writes to standard error one JSON line
``{"diag": phase, "reserved_gb": ..., "<part>_s": ..., "<part>_n": ...}``:
the seconds and calls of each part since the previous phase line.  The
processes of the multihost phase are not counted.
"""

from __future__ import annotations

import collections
import json
import sys
import time
from pathlib import Path


def main() -> None:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parent.parent)
    sys.path.insert(0, str(root.resolve()))
    import torch

    import chip_smoke
    from slam_process_tpu_torch.parallel import batch
    from slam_process_tpu_torch.parallel import streaming_device as sd
    from slam_process_tpu_torch.utils import graphs

    stats: dict = collections.defaultdict(float)

    def timed(owner, name, key):
        orig = getattr(owner, name)

        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                stats[key + "_s"] += time.perf_counter() - t
                stats[key + "_n"] += 1
        setattr(owner, name, wrapper)

    for owner, name, key in (
            (graphs.GraphRunner, "_warm_up_and_capture", "warm_capture"),
            (graphs.GraphRunner, "_capture", "capture"),
            (torch.cuda, "empty_cache", "empty_cache"),
            (sd.MultiStreamingSession, "__init__", "multi_init"),
            (sd.DeviceStreamingSession, "__init__", "single_init"),
            (sd.MultiStreamingSession, "feed", "multi_feed"),
            (sd.MultiStreamingSession, "finalize", "multi_finalize"),
            (sd.MultiStreamingSession, "finalize_streams", "multi_finalize_streams"),
            (sd, "_drain", "drain"),
            (batch._BatchedPipeline, "_issue", "batch_issue")):
        timed(owner, name, key)
    emit, last = chip_smoke.emit, {}

    def emit_with_costs(obj):
        emit(obj)
        if "phase" in obj:
            d = {k: round(v - last.get(k, 0.0), 3) for k, v in stats.items()}
            last.update(stats)
            print(json.dumps({"diag": obj["phase"],
                              "reserved_gb": torch.cuda.memory_reserved() / 1e9,
                              **{k: v for k, v in d.items() if v}}), file=sys.stderr, flush=True)

    chip_smoke.emit = emit_with_costs
    chip_smoke.main()


if __name__ == "__main__":
    main()
