#!/usr/bin/env python3
"""What a paths stream's CUDA graph leaves in the allocator when it dies, on the card.

    python3 tools/diag_torch_graph_pools.py

Three times over: a ``DeviceStreamingSession`` with ``collect_paths``
(s_step 64, 886 x 886 grids) fed four 64 KiB windows of a dataset-scale
synthetic session, so its first window captures the window graph; the
graph's pool bytes and capture ms; ``torch.cuda.memory_allocated`` and
``memory_reserved`` while the session lives, after ``del`` and after
``gc.collect()``, with whether the session and its ``GraphRunner`` are
still alive; at the end the same after ``torch.cuda.empty_cache()``.
Prints one JSON line per reading.  A dead graph's private pool stays
reserved until the allocator frees cached memory, which it does to serve
an allocation only outside a capture (``utils/graphs.py``).
"""

from __future__ import annotations

import gc
import json
import sys
import tempfile
import weakref
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from slam_process_tpu_torch.parallel import streaming_device as sd
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, write_angle_table

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    raw = synthetic_session_bytes(n_groups=20, frames_per_beam=44, baselines_per_group=93,
                                  junk_frac=0.02, seed=5)
    chunk = 1 << 16
    with tempfile.TemporaryDirectory() as tmp:
        spec = sd.make_paths_spec(write_angle_table(Path(tmp) / "angles.xlsx"), s_step=64)

    def reading(tag, **extra):
        torch.cuda.synchronize()
        print(json.dumps({"at": tag, "allocated_bytes": torch.cuda.memory_allocated(),
                          "reserved_bytes": torch.cuda.memory_reserved(), **extra}), flush=True)

    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    reading("start")
    for rep in range(3):
        s = sd.DeviceStreamingSession(chunk_bytes=chunk, collect_paths=spec, device="cuda")
        for off in range(0, 4 * chunk, chunk):
            s.feed(raw[off:off + chunk])
        alive_s, alive_g = weakref.ref(s), weakref.ref(s._graph)
        reading(f"session {rep} alive", pool_bytes=s._graph.pool_bytes,
                capture_ms=s._graph.capture_ms)
        del s
        reading(f"session {rep} after del", session_alive=alive_s() is not None,
                runner_alive=alive_g() is not None)
        gc.collect()
        reading(f"session {rep} after gc.collect", session_alive=alive_s() is not None)
    torch.cuda.empty_cache()
    reading("after empty_cache")


if __name__ == "__main__":
    main()
