#!/usr/bin/env python3
"""Time kernels K2, K3, K5 and K6 of two checkouts of the PyTorch / CUDA port
on one NVIDIA GPU, in turns: base, change, change, base.

    git archive <base-commit> | tar -x -C build/ab_base     # a directory .gitignore lists
    python3 tools/torch_kernel_ab.py build/ab_base .

Each turn is a fresh process that imports ``slam_process_tpu_torch`` from
one checkout (its kernels built from that checkout's sources) and times,
with CUDA events, the median of 20 runs of 20 back-to-back calls after a
~20 ms device sleep (as ``chip_smoke.py`` times kernels):

  * K5 ``carry_1MiB_window``: the open-group carry compaction of the
    dataset replay's second 1 MiB window (``chip_smoke.py``'s input);
  * K5 ``kept_rows``: the same window's kept rows as the stream compacts
    them, the emit-ring append and the online paths' fresh buffer, as two
    calls, and as one fused call where the checkout has
    ``compact_rows_multi_cuda``;
  * K6 ``main_65_lanes``: 65 lanes, 33 live, K = 3, T = 8, from a carry of
    three tracks (``chip_smoke.py``'s first K6 case);
  * K2 ``full_session``: the corrector's verdicts on the full session's
    rows and table (``chip_smoke.py``'s main K2 input), and ``live_64KiB``:
    the live feed's second full 64 KiB window after its carry, recorded from
    the wrapper while a stream runs;
  * K3 ``S1``: the full session's 64 x 64 tile at sigma 1 (the main path),
    and ``S58``: 58 seeded RSS-sized tiles with 5 % NaN, a per-sweep
    render's shape.

Then the streams of ``chip_smoke.py``'s streaming phase that run the
estimator: the live feed (the full multipath session in 64 KiB chunks,
``s_step`` 8) and the dataset replay (1 MiB windows, ``s_step`` 64), each
with ``collect_filtered`` and ``collect_paths``: ms per window (CUDA
events around feed, finalize and ``block_until_ready``, median of 3 after a
warm-up), and one live feed under ``torch.profiler``: the device busy time
(the union of the device activities) and the K5 and K6 kernels' count and
device microseconds.

Prints one JSON line per turn, then a summary line of the medians per
checkout and each key's spread (the smallest and largest turn).  Needs a GPU; the data is synthetic, made from fixed seeds.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
N_TIMED = 20
INNER = 20
REPLAY_CHUNK = 1 << 20
GCAP = 8192
DATASET = [dict(n_groups=20, frames_per_beam=44, baselines_per_group=93, junk_frac=0.02,
                big_group=0, seed=100 + i) for i in range(19)]
MULTIPATH = dict(n_groups=58, frames_per_beam=43, baselines_per_group=93, junk_frac=0.02,
                 big_group=4400, seed=1, n_paths=3)
LIVE_CHUNK = 1 << 16


def cuda_ms(fn) -> float:
    """Median ms per call: 20 event-timed runs of 20 back-to-back calls,
    each run queued behind a ~20 ms device sleep, after 3 warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(N_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)
        start.record()
        for _ in range(INNER):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / INNER)
    return statistics.median(times)


def k5_window(dev):
    """K5's inputs at the dataset replay's second 1 MiB window, from the
    ``slam_process_tpu_torch`` on ``sys.path``: (the window, its kept rows,
    a copy of the emit ring, the ring's row count, its capacity)."""
    import numpy as np
    import torch

    from slam_process_tpu_torch.parallel import streaming_device as sd
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes

    raw = np.concatenate([synthetic_session_bytes(**c) for c in DATASET])
    s = sd.DeviceStreamingSession(chunk_bytes=REPLAY_CHUNK, collect_filtered=True,
                                  emit_capacity=len(raw) // 11 + 1, device=dev)
    s.feed(raw[:REPLAY_CHUNK])
    lo = REPLAY_CHUNK - sd.CARRY_BYTES
    piece = torch.from_numpy(raw[lo:lo + REPLAY_CHUNK].copy()).to(dev)
    w = s._close_groups(piece, piece.numel())
    return (w, sd._kept_rows(w.combined, w.corrected), s._state.emit_buf.clone(),
            s._state.emit_count, s._ecap)


def turn(root: str) -> dict:
    """One checkout's times, in this process."""
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    from slam_process_tpu_torch.ops import cuda_compact, cuda_tracker

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device")
    dev = torch.device("cuda")

    # K5: the dataset replay's second 1 MiB window.
    w, kept, ring, offset, ecap = k5_window(dev)
    n_w = len(kept)

    out = {"root": root, "device": torch.cuda.get_device_name(0),
           "k5_rows": int(w.combined.shape[0]), "k5_masked": int(w.open_mask.sum()),
           "k5_kept": int(w.keep.sum())}
    out["K5_carry_1MiB_window_ms"] = cuda_ms(
        lambda: cuda_compact.compact_rows_cuda(w.combined, w.open_mask, GCAP))
    out["K5_kept_rows_two_calls_ms"] = cuda_ms(lambda: (
        cuda_compact.compact_rows_cuda(kept, w.keep, ecap, out=ring, offset=offset),
        cuda_compact.compact_rows_cuda(kept, w.keep, n_w)))
    if hasattr(cuda_compact, "compact_rows_multi_cuda"):
        dests = [(ecap, ring, offset), (n_w, None, None)]
        out["K5_kept_rows_fused_ms"] = cuda_ms(
            lambda: cuda_compact.compact_rows_multi_cuda(kept, w.keep, dests))

    # K6: chip_smoke.py's main_65_lanes (the first draw of its seed).
    rng = np.random.default_rng(17)
    lanes = [torch.from_numpy(rng.uniform(a, b, (65, 3)).astype(np.float32)).to(dev)
             for a, b in ((-45, 45), (-45, 45), (0, 1))]
    pos = torch.from_numpy(rng.uniform(-45, 45, (8, 2)).astype(np.float32)).to(dev)
    args = (*lanes, torch.from_numpy(rng.random((65, 3)) < 0.7).to(dev),
            torch.tensor(33, dtype=torch.int32, device=dev), pos,
            torch.arange(8, device=dev) < 3, torch.tensor(3, dtype=torch.int32, device=dev))
    out["K6_main_65_lanes_ms"] = cuda_ms(lambda: cuda_tracker.track_block_cuda(*args, 10.0))
    out.update(k2_k3(dev))
    out.update(streams(dev, Path(root)))
    return out


def k2_full_session(dev):
    """K2's inputs on the full session (``chip_smoke.py``'s main K2 case):
    (gid, clk, packed) and the keyword arguments, and the session's output."""
    from slam_process_tpu_torch.ops import correct
    from slam_process_tpu_torch.pipeline.device import run_session_on_device
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes

    full = dict(MULTIPATH, seed=0)
    del full["n_paths"]
    out = run_session_on_device(synthetic_session_bytes(**full), device=dev)
    gid, packed, _ = correct.baseline_table(out.frames, out.frame_valid, 256, 256)
    return (gid, out.frames[:, 4].contiguous(), packed), dict(bmax=256, cycle=61_000,
                                                              tol=500), out


def k2_live_window(dev):
    """(args, kwargs) of K2's call in the live feed's second full 64 KiB
    window (after the first one's open group is carried), recorded from the
    wrapper of the ``slam_process_tpu_torch`` on ``sys.path`` while a stream
    runs, by this repository's ``chip_smoke.stream_window_inputs``."""
    import importlib.util

    from slam_process_tpu_torch.ops import cuda_correct, cuda_decode
    from slam_process_tpu_torch.parallel import streaming_device as sd
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.stream_window_inputs(sd, cuda_decode, cuda_correct,
                                      synthetic_session_bytes(**MULTIPATH), LIVE_CHUNK, dev)[1]


def k3_tiles(dev, out_full):
    """K3's inputs: the full session's 64 x 64 tile (from ``out_full``, its
    ``run_session_on_device`` output), 58 seeded RSS-sized tiles with 5 %
    NaN, the viridis LUT and the sigma-1 taps."""
    import numpy as np
    import torch

    from slam_process_tpu_torch.ops import raster

    rng = np.random.default_rng(58)
    tiles = rng.random((58, 64, 64)).astype(np.float32) * (1 << 18)
    tiles[rng.random(tiles.shape) < 0.05] = np.nan
    return (out_full.mean_grid.T.contiguous()[None], torch.from_numpy(tiles).to(dev),
            torch.from_numpy(raster.colormap_lut("viridis")).to(dev), raster.blur_taps(1.0, dev))


def k2_k3(dev) -> dict:
    """K2 at the full session and at the live feed's 64 KiB window; K3 at
    S = 1 (the session tile) and S = 58, through the wrappers."""
    from slam_process_tpu_torch.ops import cuda_correct, cuda_raster

    args, kw, out_full = k2_full_session(dev)
    out = {"k2_rows": int(args[0].numel())}
    out["K2_full_session_ms"] = cuda_ms(lambda: cuda_correct.correct_verdicts_cuda(*args, **kw))

    w_args, w_kw = k2_live_window(dev)
    out["k2_window_rows"] = int(w_args[0].numel())
    out["K2_live_64KiB_ms"] = cuda_ms(
        lambda: cuda_correct.correct_verdicts_cuda(*w_args, **w_kw))

    tile, tiles, lut, taps = k3_tiles(dev, out_full)
    out["K3_S1_ms"] = cuda_ms(lambda: cuda_raster.raster_tiles_cuda(tile, lut, taps, True))
    out["K3_S58_ms"] = cuda_ms(lambda: cuda_raster.raster_tiles_cuda(tiles, lut, taps, True))
    return out


def streams(dev, root: Path) -> dict:
    """ms per window of the live feed and the dataset replay, and the live
    feed's device time under ``torch.profiler``."""
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from slam_process_tpu_torch.ops import cuda_decode
    from slam_process_tpu_torch.parallel import streaming_device as sd
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, write_angle_table

    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        angles = write_angle_table(Path(tmp) / "beam_angle.xlsx")
        live_spec = sd.make_paths_spec(angles, s_step=8)
        ds_spec = sd.make_paths_spec(angles, s_step=64)
    raw_live = synthetic_session_bytes(**MULTIPATH)
    raw_ds = np.concatenate([synthetic_session_bytes(**c) for c in DATASET])

    def live_feed():
        s = sd.DeviceStreamingSession(chunk_bytes=LIVE_CHUNK, collect_filtered=True,
                                      collect_paths=live_spec, device=dev)
        for off in range(0, len(raw_live), LIVE_CHUNK):
            s.feed(raw_live[off:off + LIVE_CHUNK])
        s.finalize()
        return s.block_until_ready()

    def dataset_replay():
        return sd.replay_log_device(raw_ds, chunk_bytes=REPLAY_CHUNK, collect_filtered=True,
                                    collect_paths=ds_spec, device=dev).block_until_ready()

    out = {}
    for name, fn in (("live_feed", live_feed), ("dataset_replay", dataset_replay)):
        fn()
        cuda_decode.LAUNCHES = 0
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[f"stream_{name}_ms_per_window"] = statistics.median(times) / (
            cuda_decode.LAUNCHES / 3)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        live_feed()
        torch.cuda.synchronize()
    acts = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("Activity Buffer")),
                  key=lambda e: e.time_range.start)
    busy_us, reach = 0.0, float("-inf")
    for e in acts:
        busy_us += max(e.time_range.end - max(e.time_range.start, reach), 0.0)
        reach = max(reach, e.time_range.end)
    out["live_feed_device_busy_ms"] = busy_us / 1e3
    for key, part in (("K5", "compact"), ("K6", "track_block")):
        mine = [e for e in acts if part in e.name]
        out[f"live_feed_{key}_kernels"] = len(mine)
        out[f"live_feed_{key}_device_ms"] = sum(e.time_range.elapsed_us() for e in mine) / 1e3
    return out


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        print(json.dumps(turn(sys.argv[2])), flush=True)
        return
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    base, change = sys.argv[1:]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = {base: [], change: []}
    for root in (base, change, change, base):
        res = subprocess.run([sys.executable, __file__, "--turn", root], capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            raise SystemExit(f"turn {root} failed:\n{res.stdout}\n{res.stderr}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        runs[root].append(line)
    keys = sorted({k for lines in runs.values() for ln in lines for k in ln
                   if k.endswith(("_ms", "_kernels", "_window"))})
    print(json.dumps({"nvidia_smi": smi, "median_ms": {
        root: {k: statistics.median(ln[k] for ln in lines) for k in keys if k in lines[0]}
        for root, lines in runs.items()}, "spread_ms": {
        root: {k: [min(ln[k] for ln in lines), max(ln[k] for ln in lines)]
               for k in keys if k in lines[0]}
        for root, lines in runs.items()}}), flush=True)


if __name__ == "__main__":
    main()
