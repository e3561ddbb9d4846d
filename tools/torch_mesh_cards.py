"""The mesh and multi-host paths with one shard or one process per card.

Usage: python3 tools/torch_mesh_cards.py   (a machine with two or more NVIDIA GPUs; ~2 min)

Builds ``chip_smoke.py``'s 21 sessions (the full session, the 19
dataset-scale ones, the full multipath session) on cuda:0, then:

  * ``chip_smoke.mesh_phase``: every mesh form on positions of cuda:0 and
    on the distinct cards (``(n, 1)`` and ``(n / 2, 2)``), each equal to
    ``mesh=None`` on cuda:0, every field, floats bitwise; ms of each form
    (CUDA events, median of 5 after a warm-up);
  * the dry-run worker in one process per card (process k on cuda:k), each
    process's streams equal to one process's run on cuda:0.

Prints the cards' name and power limit and one JSON line per part; exits
non-zero on any difference or with fewer than two cards.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> None:
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from slam_process_tpu_torch.ops import (
        cuda_compact, cuda_correct, cuda_decode, cuda_raster, cuda_sweep_sums, cuda_tracker)
    from slam_process_tpu_torch.parallel import _dryrun_worker as dry
    from slam_process_tpu_torch.parallel import streaming_device as sd
    from slam_process_tpu_torch.parallel.multihost import run_local_cluster
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import (
        synthetic_session_bytes, to_hex_text, write_angle_table)

    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_dev < 2:
        cs.fail(f"torch_mesh_cards: needs two or more CUDA devices, found {n_dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    counted = {"K1": cuda_decode, "K2": cuda_correct, "K3": cuda_raster, "K4": cuda_sweep_sums,
               "K5": cuda_compact, "K6": cuda_tracker}

    def zero_counts():
        for m in counted.values():
            m.LAUNCHES = 0

    def read_counts():
        return {k: m.LAUNCHES for k, m in counted.items()}

    dev = torch.device("cuda")
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="mesh_cards-") as tmp:
        tmp = Path(tmp)
        angles = write_angle_table(tmp / "beam_angle.xlsx")
        specs = [cs.FULL] + cs.DATASET + [cs.MULTIPATH]
        raws, sessions = [], []
        for i, cfg in enumerate(specs):
            raws.append(synthetic_session_bytes(**cfg))
            (tmp / f"s{i}.txt").write_bytes(to_hex_text(raws[-1]))
            sessions.append(Session.from_log(tmp / f"s{i}.txt"))
        t0 = time.perf_counter()
        out = cs.mesh_phase(np, torch, sd, angles, raws, sessions, zero_counts, read_counts,
                            dev)
        cs.emit({"part": "mesh", "seconds": time.perf_counter() - t0, **out})

        t0 = time.perf_counter()
        res = run_local_cluster(
            lambda coord: [[sys.executable, "-m", "slam_process_tpu_torch.parallel._dryrun_worker",
                            str(k), str(n_dev), coord] for k in range(n_dev)], 300, cwd=str(REPO))
        streams = [dry.synthetic_stream_bytes(180, seed=10 * pid + i) for pid in range(n_dev)
                   for i in range(2)]
        ms = sd.MultiStreamingSession(len(streams), chunk_bytes=4096, group_capacity=1024,
                                      max_groups=8, max_baselines_per_group=16, device=dev)
        half = len(streams[0]) // 2
        ms.feed([x[:half] for x in streams])
        ms.feed([x[half:] for x in streams])
        ms.finalize()
        nf, _, ng, _, _, _ = ms.results()
        lines = []
        for pid, (rc, stdout, err) in enumerate(res):
            if rc != 0:
                cs.fail(f"torch_mesh_cards: dry-run process {pid} exited {rc}: {err[-2000:]}")
            ln = json.loads(stdout.strip().splitlines()[-1])
            if not ln["ok"] or ln["n_frames"] != nf[2 * pid:2 * pid + 2].tolist() or \
                    ln["n_groups"] != ng[2 * pid:2 * pid + 2].tolist():
                cs.fail(f"torch_mesh_cards: dry-run process {pid} differs: {ln}")
            lines.append(ln)
        cs.emit({"part": "multihost_dryrun", "processes": n_dev,
                 "seconds": time.perf_counter() - t0,
                 "launches_by_process": [ln["launches"] for ln in lines]})
    print(smi, flush=True)
    cs.emit({"ok": True, "cards": n_dev})


if __name__ == "__main__":
    main()
