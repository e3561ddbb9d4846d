#!/usr/bin/env python3
"""The multi-stream round's graphs in two rejected forms beside the kept one, on the card.

    python3 tools/diag_torch_round_variants.py

The 19 dataset logs of ``chip_smoke.py`` as 19 ``MultiStreamingSession``
streams with paths (s_step 64), fed as in its phase 21: at 1 MiB (each
stream 20 logs back to back) and at steady 64 KiB rounds (2 logs), one
round a feed, 7 and 16 rounds.  Three fresh graph sessions each:

  * ``default``: the port's round, the JAX package's 8-lane blocks one
    estimator call after another, every graph of a shard in one memory
    pool;
  * ``one_call``: the blocks as one estimator call over their union
    (``_lane_groups`` patched to its one-call form);
  * ``private_pools``: each graph in a private pool (``new_pool`` patched
    to None).

Each variant's state must equal the default's bit for bit.  Prints one
JSON line per (size, variant): K7's launches, the median ms a round over
the rounds that captured nothing (CUDA events around each feed), and per
shard each graph's replays, capture ms and pool bytes with the pools'
bytes counted once (``chip_smoke.graphs_of``); first a line with the card's
name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SIZES = (("1MiB", 20, 7), ("steady_64KiB", 2, 16))     # (name, logs a stream, rounds fed)


def main() -> None:
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    import chip_smoke as cs
    from slam_process_tpu_torch.ops import cuda_nnls
    from slam_process_tpu_torch.parallel import streaming_device as sd
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, write_angle_table

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi}), flush=True)
    raws = [synthetic_session_bytes(**c) for c in cs.DATASET]
    with tempfile.TemporaryDirectory() as tmp:
        spec = sd.make_paths_spec(write_angle_table(Path(tmp) / "angles.xlsx"), s_step=64)
    dev = torch.device("cuda")
    lane_groups, new_pool = sd._lane_groups, sd.new_pool
    variants = {"default": {},
                "one_call": {"_lane_groups": lambda n, s1, one: lane_groups(n, s1, True)},
                "private_pools": {"new_pool": lambda: None}}
    for name, n_logs, n_rounds in SIZES:
        chunk = cs.MULTI_CHUNK if name == "1MiB" else cs.LIVE_CHUNK
        streams = [np.concatenate([raws[(i + k) % len(raws)] for k in range(n_logs)])
                   for i in range(len(raws))]
        feeds = [cs.one_round_feeds(r, chunk, sd.CARRY_BYTES) for r in streams]
        rounds = [[f[k] if k < len(f) else b"" for f in feeds] for k in range(n_rounds)]
        ecap = -(-(max(len(r) for r in streams) // 11 + 1) // (1 << 16)) * (1 << 16)
        base = None
        for variant, patches in variants.items():
            for attr, value in patches.items():
                setattr(sd, attr, value)
            try:
                x = sd.MultiStreamingSession(len(raws), chunk_bytes=chunk, collect_paths=spec,
                                             emit_capacity=ecap, device=dev)
                k7, times = cuda_nnls.LAUNCHES, []
                for pieces in rounds:
                    n_graphs = len(x._post_graphs) + (x._pre_graph is not None)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    x.feed(pieces)
                    end.record()
                    end.synchronize()
                    if len(x._post_graphs) + (x._pre_graph is not None) == n_graphs:
                        times.append(start.elapsed_time(end))
                k7 = cuda_nnls.LAUNCHES - k7
            finally:
                sd._lane_groups, sd.new_pool = lane_groups, new_pool
            if base is None:
                base = x
            elif not cs.same_multi_state(torch, sd, x, base):
                sys.exit(f"{name} {variant}: the state differs from the default's")
            print(json.dumps({"size": name, "variant": variant, "rounds": n_rounds,
                              "k7_launches": k7, "ms_per_round": statistics.median(times),
                              **cs.graphs_of(x)}), flush=True)
            if x is not base:
                del x
        del base
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
