"""One process of the multi-host dry run.

Usage: python -m slam_process_tpu_torch.parallel._dryrun_worker <pid> <nproc>
       <coordinator host:port> [device]

Joins a gloo process group with two local mesh positions per process (on
``device``: default this process's CUDA device; ``cpu`` for a run without a
card) and advances two local synthetic streams through two feed rounds and
one collective finalize of a global ``MultihostMultiStream``.  Prints one
JSON line (``pid``, ``ok``, ``n_frames``, ``n_groups``, the kernels'
``launches``) and exits 0 when
every local stream decoded frames without an overflow, non-zero otherwise.
The port of ``slam_process_tpu/parallel/_dryrun_worker.py``.
"""

from __future__ import annotations

import json
import sys

import numpy as np


def synthetic_stream_bytes(n_frames: int, seed: int) -> bytes:
    """A small valid 11-byte-frame stream (FLAG / UE / BS / CLK x 5 / RSS x
    3 tags), the JAX worker's generator."""
    rng = np.random.default_rng(seed)
    out = []
    clk = 500_000
    for k in range(n_frames):
        ue = k % 64
        clk += 61_000 + int(rng.integers(-100, 100))
        rss = int(rng.integers(1, 1 << 18))
        flag = 1 if ue % 16 == 1 else 0
        bs = (7 + clk // 61_000) % 64 if flag else 0x3F
        out.append(0xCC if flag else 0x33)
        out.append(ue & 0x3F)
        out.append(0xC0 | (bs & 0x3F))
        for i in range(5):
            out.append(0x40 | ((clk >> (6 * i)) & 0x3F))
        for i in range(3):
            out.append(0x80 | ((rss >> (6 * i)) & 0x3F))
    return bytes(out)


def launch_counts() -> dict:
    """Each hand kernel's launches in this process (0 on the CPU)."""
    from slam_process_tpu_torch.ops import (
        cuda_compact, cuda_correct, cuda_decode, cuda_nnls, cuda_raster, cuda_sweep_sums,
        cuda_tracker)

    return {k: m.LAUNCHES for k, m in (("K1", cuda_decode), ("K2", cuda_correct),
                                       ("K3", cuda_raster), ("K4", cuda_sweep_sums),
                                       ("K5", cuda_compact), ("K6", cuda_tracker),
                                       ("K7", cuda_nnls))}


def main() -> None:
    pid, nproc, coordinator = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    device = sys.argv[4] if len(sys.argv) > 4 else None

    from slam_process_tpu_torch.parallel.multihost import (
        MultihostMultiStream, global_data_mesh, initialize_multihost, shutdown_multihost)

    initialize_multihost(coordinator_address=coordinator, num_processes=nproc, process_id=pid,
                         local_device_count=2, device=device)
    n_local = 2
    mesh = global_data_mesh(model=1)   # (2 * nproc, 1): data over every process
    mh = MultihostMultiStream(mesh, n_local, chunk_bytes=4096, group_capacity=1024,
                              max_groups=8, max_baselines_per_group=16)
    streams = [synthetic_stream_bytes(180, seed=10 * pid + i) for i in range(n_local)]
    # Two feed rounds, then a collective finalize: the lockstep window
    # agreement, the sharded round and the flush.
    half = len(streams[0]) // 2
    mh.feed([s[:half] for s in streams])
    mh.feed([s[half:] for s in streams])
    mh.finalize()
    nf, _nk, ng, _sums, _counts, ovf = mh.local_results()
    n_frames = [int(v) for v in nf]
    ok = all(v > 0 for v in n_frames) and not np.asarray(ovf).any()
    shutdown_multihost()
    print(json.dumps({"pid": pid, "ok": ok, "n_frames": n_frames,
                      "n_groups": [int(v) for v in ng], "launches": launch_counts()}),
          flush=True)
    sys.exit(0 if ok else 3)


if __name__ == "__main__":
    main()
