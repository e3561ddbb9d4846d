#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``slam_process_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. env        the card (nvidia-smi name and power limit), torch and CUDA.
  2. build      nvcc builds kernels K1-K3 from ``slam_process_tpu_torch/csrc``.
  3. kernels    each kernel against its plain PyTorch version on the card, at
                the main path's shapes and on edge cases: K1 and K2 equal
                element for element; K3 ``blurred`` within 1e-5 relative,
                ``norm_t`` within 1e-4 absolute, the same NaN pattern, LUT-bin
                flips in under 0.1 % of cells, premultiplied rgba within 1e-3.
  4. main_path  ``Session.from_log`` on hex-text logs: one full-size session
                (58 groups x 64 beams x 43 frames, one group of >= 4,400
                frames) and 19 dataset-scale sessions (~56 k frames each).
                The launch counters are set to 0 just before and read just
                after; every kernel must have launched.  Every
                ``DeviceSessionOut`` field on the card is then held against
                the same pipeline with ``device="cpu"`` (integer and bool
                fields and ``mean_grid`` exactly, the raster as in phase 3),
                and each dataset session's frames / corrected_bs / filtered
                against its CPU run.
  5. timing     CUDA-event medians of 20 runs after a warm-up: each kernel
                alone, its plain version on the card, and the whole
                ``run_session_on_device`` in frames/s at both sizes; then
                one full-size session under ``torch.profiler``: the device's
                busy time, its share of the session time, the top ops.

Then the ``kernels`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.  Data
is synthetic, made from fixed seeds; temporary logs go under ``build/``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and non-tensor f32.
# int32: the issue rate, one warp instruction per SM sub-partition per clock
# = 128 lanes per SM (the 64-lane INT pipe and IMAD on the FMA pipe together),
# x 132 SMs x 1.98 GHz boost.  No integer mix can exceed it, so a bound from
# it never flatters a kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_INT32_PER_S = 132 * 128 * 1.98e9

FULL = dict(n_groups=58, frames_per_beam=43, baselines_per_group=93, junk_frac=0.02,
            big_group=4400, seed=0)
DATASET = [dict(n_groups=20, frames_per_beam=44, baselines_per_group=93, junk_frac=0.02,
                big_group=0, seed=100 + i) for i in range(19)]
MAX_GROUPS = MAX_BASELINES = 256
N_TIMED = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def expected_frames(cfg: dict) -> int:
    per_beam = [cfg["frames_per_beam"]] * cfg["n_groups"]
    if cfg["big_group"] > 0:
        per_beam[0] = -(-cfg["big_group"] // 64)
    return 64 * sum(per_beam)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this run needs an NVIDIA GPU")
    if not (REPO / "slam_process_tpu_torch" / "csrc").is_dir():
        fail(f"the slam_process_tpu_torch package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    # No TF32 anywhere: the port's float work is plain f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from slam_process_tpu_torch.ops import (
        _build, correct, cuda_correct, cuda_decode, cuda_raster, decode, raster)
    from slam_process_tpu_torch.pipeline.device import (
        bucket_size, pad_bytes, run_session_on_device)
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, to_hex_text

    dev = torch.device("cuda")

    # -- 1. env ---------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "python": sys.version.split()[0]})

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    log = (lib.parent / "nvcc.log").read_text()
    emit({"phase": "build", "seconds": build_s, "library": str(lib.relative_to(REPO)),
          "ptxas": [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                    if "Used" in ln or "Compiling entry" in ln]})

    # Main-path inputs of each kernel, from the full-size session.
    raw_full = synthetic_session_bytes(**FULL)
    n_full = expected_frames(FULL)
    padded = torch.from_numpy(pad_bytes(raw_full, bucket_size(len(raw_full)))).to(dev)
    lut = torch.from_numpy(raster.colormap_lut("viridis")).to(dev)
    taps = raster.blur_taps(1.0, dev)
    out_full = run_session_on_device(raw_full, device=dev)
    frames, valid = out_full.frames, out_full.frame_valid
    gid, packed, _ = correct.baseline_table(frames, valid, MAX_GROUPS, MAX_BASELINES)
    clk = frames[:, 4].contiguous()
    tile = out_full.mean_grid.T.contiguous()[None]
    torch.cuda.synchronize()

    # -- 3. kernels against their plain versions --------------------------------
    err = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    cases = []

    def exact(key, case, got, want):
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w):
                fail(f"{key} {case}: kernel and plain version differ")
        cases.append(f"{key}:{case}")

    def raster_close(key, case, got, want, flips_max=1e-3):
        """got / want = (rgba, norm_t, blurred)."""
        (rgba, t, b), (rgba_p, t_p, b_p) = got, want
        if not torch.equal(torch.isnan(b), torch.isnan(b_p)) or not torch.equal(
                torch.isnan(t), torch.isnan(t_p)):
            fail(f"{key} {case}: NaN patterns differ")
        if not torch.allclose(b, b_p, rtol=1e-5, atol=0.0, equal_nan=True):
            fail(f"{key} {case}: blurred beyond 1e-5 relative")
        fin = ~torch.isnan(t)
        d_t = float((t[fin] - t_p[fin]).abs().max()) if fin.any() else 0.0
        if d_t > 1e-4:
            fail(f"{key} {case}: norm_t differs by {d_t} > 1e-4")
        bins = (t.nan_to_num() * 256).long().clamp(0, 255)
        bins_p = (t_p.nan_to_num() * 256).long().clamp(0, 255)
        flips = float((bins != bins_p).float().mean())
        if flips >= flips_max:
            fail(f"{key} {case}: LUT-bin flips in {flips:.4%} of cells")
        d_rgba = float((rgba * rgba[..., 3:] - rgba_p * rgba_p[..., 3:]).abs().max())
        if d_rgba > 1e-3:
            fail(f"{key} {case}: premultiplied rgba differs by {d_rgba}")
        err[key] = max(err.get(key, 0.0), d_t)
        cases.append(f"{key}:{case}")

    # K1: the main path's bytes; junk-heavy bytes with an n_valid cut.
    exact("K1", "main", cuda_decode.decode_rows_cuda(padded, padded.numel(), 0xCC, 0x33),
          decode.decode_rows_plain(padded))
    junk = torch.from_numpy(synthetic_session_bytes(
        n_groups=3, frames_per_beam=2, baselines_per_group=4, junk_frac=0.9, seed=7)).to(dev)
    for cut in (junk.numel(), junk.numel() - 37):
        got = cuda_decode.decode_rows_cuda(junk, cut, 0xCC, 0x33)
        exact("K1", f"junk_n_valid={cut}", got, decode.decode_rows_plain(junk, n_valid=cut))
    noise = torch.randint(0, 256, (1 << 20,), generator=torch.Generator().manual_seed(3),
                          dtype=torch.uint8).to(dev)
    exact("K1", "noise", cuda_decode.decode_rows_cuda(noise, noise.numel(), 0xCC, 0x33),
          decode.decode_rows_plain(noise))

    # K2: the main path's table; a planted exact-tol / tol+1 table.
    verdict_args = dict(bmax=MAX_BASELINES, cycle=61_000, tol=500)
    exact("K2", "main", cuda_correct.correct_verdicts_cuda(gid, clk, packed, **verdict_args),
          correct.baseline_plane_verdicts(gid, clk, packed, **verdict_args))
    g_pl, c_pl, p_pl = planted_table(torch)
    pl_args = dict(bmax=96, cycle=61_000, tol=500)
    got = cuda_correct.correct_verdicts_cuda(g_pl.to(dev), c_pl.to(dev), p_pl.to(dev), **pl_args)
    exact("K2", "planted_tol", got, correct.baseline_plane_verdicts(
        g_pl.to(dev), c_pl.to(dev), p_pl.to(dev), **pl_args))
    if not bool(got[0][3]):
        fail("K2 planted_tol: the baseline at exactly tol was not accepted")

    # K3: the session tile; random RSS-sized tiles with NaNs; all-NaN and
    # one-cell tiles; log and linear norm.
    gen = torch.Generator().manual_seed(11)
    rand = torch.rand((8, 64, 64), generator=gen) * (1 << 18)
    rand[torch.rand((8, 64, 64), generator=gen) < 0.05] = float("nan")
    edge = torch.full((2, 64, 64), float("nan"))
    edge[1, 17, 40] = 1234.0
    for case, mats in (("main", tile), ("random", rand.to(dev)), ("nan_and_one_cell",
                                                                   edge.to(dev))):
        for use_log in (True, False):
            raster_close("K3", f"{case}_log={use_log}",
                         cuda_raster.raster_tiles_cuda(mats, lut, taps, use_log),
                         raster.raster_tiles_plain(mats, lut, taps, use_log))
    torch.cuda.synchronize()
    emit({"phase": "kernels", "cases": cases, "max_abs_err": err})

    # -- 4. main path ------------------------------------------------------------
    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="chip_smoke-") as tmp:
        specs = [("full", FULL)] + [(f"dataset_{i:02d}", c) for i, c in enumerate(DATASET)]
        paths, raws = [], []
        for name, cfg in specs:
            raw = synthetic_session_bytes(**cfg)
            path = Path(tmp) / f"{name}.txt"
            path.write_bytes(to_hex_text(raw))
            paths.append(path)
            raws.append(raw)

        for m in (cuda_decode, cuda_correct, cuda_raster):
            m.LAUNCHES = 0
        t0 = time.perf_counter()
        sessions = [Session.from_log(p) for p in paths]
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = {"K1": cuda_decode.LAUNCHES, "K2": cuda_correct.LAUNCHES,
                    "K3": cuda_raster.LAUNCHES}
        if min(launches.values()) == 0:
            fail(f"a kernel of the main path never launched: {launches}")

        for (name, cfg), s in zip(specs, sessions):
            if len(s.frames) != expected_frames(cfg):
                fail(f"{name}: decoded {len(s.frames)} frames, wrote {expected_frames(cfg)}")
            if len(s.filtered) == 0:
                fail(f"{name}: no frame was corrected")
        for path, s in zip(paths[1:], sessions[1:]):
            ref = Session.from_log(path, device="cpu")
            for field in ("frames", "corrected_bs", "filtered"):
                if not np.array_equal(getattr(s, field), getattr(ref, field)):
                    fail(f"{path.name}: {field} differs between cuda and cpu")

        out_cpu = run_session_on_device(raw_full, device="cpu")
        for field in out_full._fields:
            a, b = getattr(out_full, field).cpu(), getattr(out_cpu, field)
            if field in ("rgba", "blurred", "norm_t"):
                continue
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                    torch.nan_to_num(a, nan=-1.0) if a.is_floating_point() else a,
                    torch.nan_to_num(b, nan=-1.0) if b.is_floating_point() else b):
                fail(f"full session: {field} differs between cuda and cpu")
        raster_close("pipeline", "full_cuda_vs_cpu",
                     tuple(getattr(out_full, f).cpu()[None] for f in ("rgba", "norm_t", "blurred")),
                     tuple(getattr(out_cpu, f)[None] for f in ("rgba", "norm_t", "blurred")))
        if out_full.rgba.shape != (64, 64, 4) or not torch.isfinite(out_full.rgba).all():
            fail("full session: rgba is not a finite [64, 64, 4] raster")
    emit({"phase": "main_path", "sessions": len(sessions),
          "frames": sum(len(s.frames) for s in sessions),
          "kept": sum(len(s.filtered) for s in sessions), "seconds": main_s,
          "launches": launches, "full_session_rows": int(frames.shape[0]),
          "full_session_bytes": len(raw_full)})

    # -- 5. timing ---------------------------------------------------------------
    def cuda_ms(fn, inner=1, primed=True):
        """Median ms per call over N_TIMED event-timed runs of ``inner``
        calls.  ``primed``: a ~20 ms device sleep queued first lets the
        calls reach the card back to back, so device work is timed without
        host gaps; whole sessions are timed unprimed, host work included."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(N_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if primed:
                torch.cuda._sleep(40_000_000)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        return statistics.median(times)

    n_bytes, rows = padded.numel(), frames.shape[0]
    k1_out = (torch.zeros((rows, 5), dtype=torch.int32, device=dev),
              torch.zeros(rows, dtype=torch.bool, device=dev),
              torch.zeros((), dtype=torch.int32, device=dev))
    k1 = cuda_decode._fn()
    k1_args = (padded.data_ptr(), n_bytes, n_bytes, 0xCC, 0x33,
               *(t.data_ptr() for t in k1_out), _build.stream_of(padded))
    k2 = cuda_correct._fn()
    k2_out = (torch.empty(rows, dtype=torch.bool, device=dev),
              torch.empty(rows, dtype=torch.int32, device=dev),
              torch.empty(rows, dtype=torch.int32, device=dev))
    k2_args = (gid.data_ptr(), clk.data_ptr(), rows, packed.data_ptr(), packed.shape[0],
               packed.shape[1], MAX_BASELINES, 61_000, 500,
               *(t.data_ptr() for t in k2_out), _build.stream_of(gid))
    k3 = cuda_raster._fn()
    k3_out = (torch.empty((1, 64, 64, 4), device=dev), torch.empty((1, 64, 64), device=dev),
              torch.empty((1, 64, 64), device=dev))
    k3_args = (tile.data_ptr(), 1, 64, 64, lut.data_ptr(), 256, taps.data_ptr(), 7, 7, 1,
               *(t.data_ptr() for t in k3_out), _build.stream_of(tile))

    ms = {"K1": cuda_ms(lambda: k1(*k1_args), inner=20),
          "K2": cuda_ms(lambda: k2(*k2_args), inner=20),
          "K3": cuda_ms(lambda: k3(*k3_args), inner=20)}
    plain_ms = {"K1": cuda_ms(lambda: decode.decode_rows_plain(padded)),
                "K2": cuda_ms(lambda: correct.baseline_plane_verdicts(gid, clk, packed,
                                                                      **verdict_args)),
                "K3": cuda_ms(lambda: raster.raster_tiles_plain(tile, lut, taps, True))}
    session_ms = cuda_ms(lambda: run_session_on_device(raw_full, device=dev), primed=False)
    dataset_ms = cuda_ms(lambda: [run_session_on_device(r, device=dev) for r in raws[1:]],
                         primed=False)
    dataset_frames = sum(expected_frames(c) for c in DATASET)

    # Where the session's time goes: one profiled full-size session.  Busy
    # time is the union of the device activities' intervals (kernels,
    # copies, memsets; not the CPU-side aten rows, which would count each
    # kernel twice, nor the profiler's own buffer requests).
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_session_on_device(raw_full, device=dev)
        torch.cuda.synchronize()
    acts = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("Activity Buffer")),
                  key=lambda e: e.time_range.start)
    busy_us, reach = 0.0, float("-inf")
    for e in acts:
        lo, hi = max(e.time_range.start, reach), e.time_range.end
        busy_us += max(hi - lo, 0.0)
        reach = max(reach, hi)
    by_name = {}
    for e in acts:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us()
    emit({"phase": "profile", "device_busy_ms": busy_us / 1e3,
          "busy_share_of_session": busy_us / 1e3 / session_ms, "device_activities": len(acts),
          "top_us": sorted(by_name.items(), key=lambda kv: -kv[1])[:10]})

    emit({"phase": "timing", "kernel_ms": ms, "plain_ms": plain_ms,
          "full_session": {"frames": n_full, "ms": session_ms,
                           "frames_per_s": n_full / (session_ms / 1e3)},
          "dataset": {"sessions": len(DATASET), "frames": dataset_frames, "ms": dataset_ms,
                      "frames_per_s": dataset_frames / (dataset_ms / 1e3)}})

    # Bounds: the larger of bytes moved (each input read once, each output
    # written once) over HBM bandwidth and the operations this run's data
    # needs over the peak rate.  K1: a flag test (3 ops) at every position,
    # the ten tag-class tests (30 ops) only where a flag byte sits, the
    # assembly and row write (28 ops) only at the frame starts.  K2: 8 ops
    # per (real frame, live baseline of its group) pair and 10 per row.
    flag_positions = int(((padded == 0xCC) | (padded == 0x33)).sum())
    n_starts = int(out_full.n_frames)
    live = packed[:, 3 * MAX_BASELINES].long().clamp(max=MAX_BASELINES)[gid.long()]
    k2_pairs = int(live[valid].sum())
    bounds = {
        "K1": (n_bytes + rows * 21 + 4, n_bytes * 3 + flag_positions * 30 + n_starts * 28,
               PEAK_INT32_PER_S),
        "K2": (rows * 8 + packed.numel() * 4 + rows * 9, k2_pairs * 8 + rows * 10,
               PEAK_INT32_PER_S),
        "K3": (64 * 64 * 4 + 256 * 16 + 49 * 4 + 64 * 64 * 24, 64 * 64 * (49 * 4 + 30),
               PEAK_F32_PER_S),
    }
    meta = {
        "K1": ("decode_rows", "decode.cu", "slam_process_tpu/ops/pallas_decode.py:130"),
        "K2": ("correct_verdicts", "correct.cu", "slam_process_tpu/ops/pallas_correct.py:109"),
        "K3": ("raster_tiles", "raster.cu", "slam_process_tpu/ops/pallas_raster.py:136"),
    }
    rows_out = []
    for key, (name, src, replaces) in meta.items():
        n_b, n_ops, peak = bounds[key]
        t_bytes, t_ops = n_b / PEAK_BYTES_PER_S * 1e3, n_ops / peak * 1e3
        rows_out.append({
            "name": f"{key} {name}", "route": "cuda",
            "source": f"slam_process_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[key], "max_abs_err": err[key], "ms": ms[key],
            "plain_ms": plain_ms[key], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
    emit({"phase": "bounds", "k1_flag_positions": flag_positions, "k1_starts": n_starts,
          "k2_row_baseline_pairs": k2_pairs,
          "K1_bytes_ops": bounds["K1"][:2], "K2_bytes_ops": bounds["K2"][:2],
          "K3_bytes_ops": bounds["K3"][:2]})
    print(smi, flush=True)
    emit({"kernels": rows_out})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def planted_table(torch):
    """A K2 case with baselines planted at exactly tol and tol + 1 from row
    3's clk (as the JAX package's Pallas corrector test plants them)."""
    import numpy as np

    bmax, cycle, tol, g_pad, f = 96, 61_000, 500, 128, 4096
    rng = np.random.default_rng(0)
    gid = np.sort(rng.integers(0, 64, f)).astype(np.int32)
    clk = rng.integers(0, 1 << 30, f).astype(np.int32)
    tbl_clk = rng.integers(0, 1 << 30, (g_pad, bmax)).astype(np.int64)
    g3 = int(gid[3])
    tbl_clk[g3, :4] = (clk[3] - np.array([tol, tol + 1, -tol, -(tol + 1)])) & ((1 << 30) - 1)
    tbl_bs = rng.integers(0, 64, (g_pad, bmax))
    n_cap = rng.integers(0, bmax + 1, g_pad)
    n_cap[g3] = max(n_cap[g3], 4)
    r = tbl_clk % cycle
    packed = np.zeros((g_pad, ((3 * bmax + 1 + 127) // 128) * 128), np.float32)
    packed[:, :bmax] = r >> 8
    packed[:, bmax:2 * bmax] = r & 0xFF
    packed[:, 2 * bmax:3 * bmax] = (tbl_bs - tbl_clk // cycle) % 64
    packed[:, 3 * bmax] = n_cap
    return torch.from_numpy(gid), torch.from_numpy(clk), torch.from_numpy(packed)


if __name__ == "__main__":
    main()
