"""The five named benchmark configs as runnable pipelines, the port of
``slam_process_tpu/pipeline/configs.py``:

    1. serial_hex_to_excel_v3: one log -> Parsed table + intensity grid
    2. excel_heatmap_v3:       one filtered table -> heatmap PNG
    3. bs_beam_correction:     correction + the NN-OMP estimate's figure
    4. batched_session:        every log through the session pipeline
    5. streaming_replay:       every log through the device stream, then
                               the host stream with live renders

Each returns a JSON-serializable dict with the JAX package's keys; the
stages run on ``device`` (None: CUDA), timed with ``torch.cuda.synchronize``
where the JAX package blocks on its arrays.  ``excel_heatmap_v3`` and
``bs_beam_correction`` draw PNGs, which need matplotlib.  Driven by
``python -m slam_process_tpu_torch.pipeline.cli run-config <name> ...``.
"""

from __future__ import annotations

import glob
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from slam_process_tpu_torch.pipeline.device import resolve_device
from slam_process_tpu_torch.pipeline.session import Session


def _default_logs(data_dir: Path):
    logs = sorted(glob.glob(str(data_dir / "*.txt")))
    if not logs:
        raise FileNotFoundError(f"no .txt logs under {data_dir}")
    return logs


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def config_decode(data_dir: Path, mapping: Path, outdir: Path, device) -> dict:
    log = _default_logs(data_dir)[0]
    s = Session.from_log(log, device=device)
    s.export_parsed(outdir / f"{s.name}.xlsx")
    grid = s.intensity(source="parsed", device=device)
    return {"config": "serial_hex_to_excel_v3", "log": str(log),
            "frames": int(len(s.frames)),
            "observed_cells": int((grid.counts > 0).sum()),
            "timings_s": s.timings}


def config_heatmap(data_dir: Path, mapping: Path, outdir: Path, device) -> dict:
    filtered = sorted(glob.glob(str(data_dir / "*_filtered.xlsx")))[0]
    s = Session.from_filtered_xlsx(filtered)
    s.render_heatmap(mapping, outdir / f"{s.name}_heatmap.png", device=device)
    return {"config": "excel_heatmap_v3", "input": str(filtered),
            "png": str(outdir / f"{s.name}_heatmap.png"), "timings_s": s.timings}


def config_correction(data_dir: Path, mapping: Path, outdir: Path, device) -> dict:
    from slam_process_tpu_torch.models.registry import run_estimator

    log = _default_logs(data_dir)[0]
    s = Session.from_log(log, device=device)
    s.correct(device=device)
    s.export_filtered(outdir / f"{s.name}_filtered.xlsx")
    paths = run_estimator("nn_omp", s, mapping, outdir / f"{s.name}_corrected_render.png",
                          device=device)
    return {"config": "bs_beam_correction", "log": str(log),
            "corrected_rows": int(len(s.filtered)),
            "paths": paths.to_dict("records"), "timings_s": s.timings}


def config_batched(data_dir: Path, mapping: Path, outdir: Path, device) -> dict:
    from slam_process_tpu_torch.io import read_hex_log
    from slam_process_tpu_torch.pipeline.device import run_session_on_device

    dev = resolve_device(device)
    raw = [read_hex_log(p) for p in _default_logs(data_dir)]
    for r in raw:                                   # warm-up
        run_session_on_device(r, device=dev)
    _synchronize(dev)
    t0 = time.perf_counter()
    outs = [run_session_on_device(r, device=dev) for r in raw]
    _synchronize(dev)
    dt = time.perf_counter() - t0
    total = int(sum(o.n_frames for o in outs))      # read after the timed region
    return {"config": "batched_session", "n_logs": len(raw),
            "total_frames": total, "elapsed_s": round(dt, 4),
            "frames_per_sec": round(total / dt, 1)}


def config_streaming(data_dir: Path, mapping: Path, outdir: Path, device) -> dict:
    from slam_process_tpu_torch.io import read_hex_log
    from slam_process_tpu_torch.io.angles import load_angle_lut
    from slam_process_tpu_torch.parallel.streaming import replay_log
    from slam_process_tpu_torch.parallel.streaming_device import replay_log_device

    dev = resolve_device(device)
    lut = load_angle_lut(mapping)
    raws = [read_hex_log(p) for p in _default_logs(data_dir)]

    # The device stream (the production streaming path): time every log,
    # then read.
    replay_log_device(raws[0], chunk_bytes=1 << 20, device=dev).block_until_ready()
    t0 = time.perf_counter()
    sessions = [replay_log_device(r, chunk_bytes=1 << 20, device=dev) for r in raws]
    _synchronize(dev)
    dev_dt = time.perf_counter() - t0
    total = sum(s.n_frames for s in sessions)
    sessions[-1].render(lut)

    # The host stream with periodic live renders (no card needed).
    t0 = time.perf_counter()
    host_total = 0
    for r in raws:
        host_total += replay_log(r, chunk_bytes=1 << 16, render_every=8, angle_lut=lut).n_frames
    host_dt = time.perf_counter() - t0
    if host_total != total:
        raise AssertionError(f"the host stream decoded {host_total} frames, the device "
                             f"stream {total}")
    return {"config": "streaming_replay", "n_logs": len(raws), "total_frames": total,
            "frames_per_sec": round(total / dev_dt, 1),
            "host_frames_per_sec": round(host_total / host_dt, 1)}


NAMED_CONFIGS: Dict[str, Callable] = {
    "serial_hex_to_excel_v3": config_decode,
    "excel_heatmap_v3": config_heatmap,
    "bs_beam_correction": config_correction,
    "batched_session": config_batched,
    "streaming_replay": config_streaming,
}


def run_named_config(name: str, data_dir: Optional[Path] = None,
                     mapping: Optional[Path] = None, outdir: Optional[Path] = None,
                     device=None) -> dict:
    """Run config ``name`` on ``device`` (None: CUDA) over the dataset's
    log directory ``data_dir`` and angle table ``mapping``, writing into
    ``outdir`` (default ``artifacts/configs``)."""
    if name not in NAMED_CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(NAMED_CONFIGS)}")
    if data_dir is None or mapping is None:
        raise ValueError("run-config needs the dataset's log directory and angle table "
                         "(--data-dir DIR --mapping beam_angle.xlsx)")
    data_dir, mapping = Path(data_dir), Path(mapping)
    outdir = Path(outdir or "artifacts/configs")
    outdir.mkdir(parents=True, exist_ok=True)
    return NAMED_CONFIGS[name](data_dir, mapping, outdir, device)
