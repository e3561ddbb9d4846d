"""A copy of the benchmark at a size a CPU test can run: the same files,
with each configuration cut to two short logs and each cell to short
windows, written under a temporary root beside the program."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIG = {"frames_min": 700, "frames_max": 2000,
               "log_frames": [896, 1280], "frames_per_beam": 3, "big_group_frames": 320,
               "baselines_per_group": 4}
TINY_TRAFFIC = {"streams": 2, "chunk_bytes": 4096, "warmup_rounds": 2, "sample_share": 1.0}
TINY_PATHS = {"grid_res": 1.0}


def with_parked(bench: dict) -> dict:
    """``bench`` with the entries of ``portbench/parked.json`` added: its
    cells, their configurations and metrics, and the parked cells in the
    workloads of the metrics both name."""
    parked = json.loads((REPO / "portbench" / "parked.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        have = {e["name"]: e for e in bench[key]}
        for entry in parked[key]:
            if entry["name"] in have:
                have[entry["name"]]["workloads"] += entry["workloads"]
            else:
                bench[key].append(entry)
    return bench


def tiny_root(tmp: Path) -> Path:
    """``tmp`` holding BENCHMARK.json, with the parked cells, and
    portbench/ with every configuration and cell cut to the tiny size; the
    program is imported from the repository."""
    root = Path(tmp)
    (root / "BENCHMARK.json").write_text(json.dumps(with_parked(
        json.loads((REPO / "BENCHMARK.json").read_text()))))
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (root / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(TINY_CONFIG)
        if "paths" in cfg:
            cfg["paths"].update(TINY_PATHS)
        path.write_text(json.dumps(cfg))
    for path in (root / "portbench" / "workloads").glob("*.json"):
        wl = json.loads(path.read_text())
        wl["traffic"].update({k: v for k, v in TINY_TRAFFIC.items() if k in wl["traffic"]})
        path.write_text(json.dumps(wl))
    return root
