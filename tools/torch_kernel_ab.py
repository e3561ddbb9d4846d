#!/usr/bin/env python3
"""Time kernels K1-K7 of two checkouts of the PyTorch / CUDA port on one
NVIDIA GPU, in turns: base, change, change, base (``--rounds N``: that
pattern N times).

    git archive <base-commit> | tar -x -C build/ab_base     # a directory .gitignore lists
    python3 tools/torch_kernel_ab.py build/ab_base . [--rounds N] [--only k7,k5s]

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
    render's shape;
  * K1 ``full_session``: the full session's padded bytes (the main path),
    and the second full window of the straddle (16 KiB), the live feed
    (64 KiB) and the dataset replay (1 MiB), recorded from the wrapper while
    a stream runs: each through the wrapper (what a caller pays) and as the
    bare launch (one C call into outputs made once);
  * K4 ``full_session``: the full session's filtered rows (155,035 rows, S =
    58, ``chip_smoke.py``'s main K4 input), ``live_S9`` and ``replay_S65``:
    the live feed's and the replay's second full window with paths
    (``s_step`` 8 and 64), recorded from the wrapper while the stream runs,
    and ``unsorted_S65``: 200,000 rows in random order over 65 sweeps
    (``chip_smoke.py``'s ``b_unsorted_65_sweeps``), through the wrapper;
  * the host's microseconds per K1 call at the 64 KiB window and per K4
    call at S = 9 (``time.perf_counter`` around 50 calls issued behind a
    ~20 ms device sleep, so the device is busy throughout, as it runs
    behind a stream's host): what a window pays the wrappers on the host;
    a launch that waited for the device would show ~400 µs more a call.

Then the whole session, ``run_session_on_device`` on the full session's
bytes (CUDA events around each call with its host work, no device sleep
first, median of 20 after 3 warm-up calls: ``chip_smoke.py``'s
``full_session`` time; one call's device busy time and device activities,
counted by name, under ``torch.profiler``), and the streams of ``chip_smoke.py``'s streaming
phase that run the
estimator: the live feed (the full multipath session in 64 KiB chunks,
``s_step`` 8) and the dataset replay (1 MiB windows, ``s_step`` 64), each
with ``collect_filtered`` and ``collect_paths``: ms per window (CUDA
events around feed, finalize and ``block_until_ready``, median of 3 after a
warm-up), and one live feed under ``torch.profiler``: the device busy time
(the union of the device activities), the activities counted in all and
by name, and the K5 and K6 kernels' count and device microseconds.

Then K7 and K5's stream axis on inputs recorded once, before the turns,
by the change's checkout (``--record``, into a file under ``build/``) and
loaded by every turn:

  * K7 ``estimate_1_lane`` and ``vmap_21_lanes``: the session estimator's
    own refits (K = 20, "lu", one call an NN-OMP iteration), recorded from
    the wrapper while ``run_estimator("nn_omp")`` runs on the full
    multipath session and the "vmap" form runs over the 21 sessions packed
    (``chip_smoke.estimator_k7_calls``), all of a run's calls back to back;
    ``edges_65_lanes_K20_auto`` / ``_lu``: ``utils/synthetic.nnls_edge_cases``
    at K = 20, 65 lanes (``chip_smoke.py``'s ``edges_K20_*``);
  * K5 ``streams_19_carry``: the 19 streams' carry compaction in the first
    round of a ``MultiStreamingSession`` over the dataset's logs at 1 MiB
    windows (``chip_smoke.multi_round_inputs``), and ``streams_1_carry``:
    the replay's second 1 MiB window's carry through the stream-axis entry
    at S = 1 (what a single stream calls);
  * K1 through the stream-axis entry (``k1s``) at its calls as
    ``chip_smoke.k1s_calls`` records them: ``streams_19_1MiB`` (the same
    first round), ``batch_<S>x<N>`` (``run_dataset``'s largest bucket
    group), ``streams_19_64KiB`` (the 19 streams' second 64 KiB round),
    ``S1_full_session`` and ``S1_64KiB_window``, each beside its bytes
    bound (``k1s_<name>_bound_ms_bytes``: the bytes below each stream's
    limit read once, every row, valid byte and count written once);
  * K6 through the stream-axis entry (``k6s``): ``streams_19_65_lanes``,
    the 19 trackers of the same first round, and ``S1_65_lanes_33_live``,
    ``chip_smoke.py``'s ``main_65_lanes`` as S = 1 (what a single stream's
    paths window calls), each with its live lanes per stream.

``--only SECTION[,SECTION]`` runs only those sections of each turn (k5, k6,
k2k3, k1k4, session, streams, k7, k5s, k1s, k6s; all by default).

Prints one JSON line per turn, then a summary line of the medians per
checkout and each key's spread (the smallest and largest turn).  Needs a GPU; the data is synthetic, made from fixed seeds.
"""

from __future__ import annotations

import collections
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
    piece = raw[lo:lo + REPLAY_CHUNK]
    if not hasattr(s, "_load_window"):     # a checkout whose windows were device tensors
        piece = torch.from_numpy(piece.copy()).to(dev)
    w = s._close_groups(piece, len(piece))
    return (w, sd._kept_rows(w.combined, w.corrected), s._state.emit_buf.clone(),
            s._state.emit_count, s._ecap)


SECTIONS = ("k5", "k6", "k2k3", "k1k4", "session", "streams", "k7", "k5s", "k1s", "k6s")
RECORDED = ("k7", "k5s", "k1s", "k6s")     # sections on inputs recorded once


def turn(root: str, only=SECTIONS, inputs=None) -> dict:
    """One checkout's times for the sections ``only``, in this process;
    ``inputs``: the file ``record`` wrote (the sections in ``RECORDED``)."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device")
    dev = torch.device("cuda")
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    if "k5" in only:
        out.update(k5(dev))
    if "k6" in only:
        out.update(k6(dev))
    if "k2k3" in only:
        out.update(k2_k3(dev))
    if "k1k4" in only:
        out.update(k1_k4(dev, Path(root)))
    if "session" in only:
        out.update(session_ms(dev))
    if "streams" in only:
        out.update(streams(dev, Path(root)))
    if set(only) & set(RECORDED):
        out.update(recorded(dev, torch.load(inputs), only))
    return out


def k5(dev) -> dict:
    """K5 at the dataset replay's second 1 MiB window: the carry, and the
    kept rows as two calls and as the fused call."""
    from slam_process_tpu_torch.ops import cuda_compact

    w, kept, ring, offset, ecap = k5_window(dev)
    n_w = len(kept)
    out = {"k5_rows": int(w.combined.shape[0]), "k5_masked": int(w.open_mask.sum()),
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
    return out


def k6(dev) -> dict:
    """K6 at chip_smoke.py's main_65_lanes (the first draw of its seed)."""
    import numpy as np
    import torch

    from slam_process_tpu_torch.ops import cuda_tracker

    rng = np.random.default_rng(17)
    lanes = [torch.from_numpy(rng.uniform(a, b, (65, 3)).astype(np.float32)).to(dev)
             for a, b in ((-45, 45), (-45, 45), (0, 1))]
    pos = torch.from_numpy(rng.uniform(-45, 45, (8, 2)).astype(np.float32)).to(dev)
    args = (*lanes, torch.from_numpy(rng.random((65, 3)) < 0.7).to(dev),
            torch.tensor(33, dtype=torch.int32, device=dev), pos,
            torch.arange(8, device=dev) < 3, torch.tensor(3, dtype=torch.int32, device=dev))
    return {"K6_main_65_lanes_ms": cuda_ms(lambda: cuda_tracker.track_block_cuda(*args, 10.0))}


def record(path: str, only=RECORDED) -> None:
    """The inputs of the sections ``only`` of ``RECORDED``, made by the
    ``slam_process_tpu_torch`` of this repository and saved to ``path`` (CPU
    tensors): K7's calls per set, K5's stream-axis carry calls at S = 19 and
    S = 1, K1's stream-axis calls and K6's at S = 19 and S = 1."""
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from slam_process_tpu_torch.parallel import streaming_device as sd
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import (
        nnls_edge_cases, synthetic_session_bytes, to_hex_text, write_angle_table)

    cs = smoke()
    dev = torch.device("cuda")

    def cpu(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    (REPO / "build").mkdir(exist_ok=True)
    data = {}
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        angles = write_angle_table(Path(tmp) / "beam_angle.xlsx")
        raws = [synthetic_session_bytes(**c) for c in [cs.FULL, *cs.DATASET, cs.MULTIPATH]]
        if "k7" in only:
            logs = []
            for i, raw in enumerate(raws):
                logs.append(Path(tmp) / f"log_{i:02d}.txt")
                logs[-1].write_bytes(to_hex_text(raw))
            sessions = [Session.from_log(p) for p in logs]
            k7 = cs.estimator_k7_calls(sd, sessions, angles)
            for solver in ("auto", "lu"):
                G, b, x0, P0 = (torch.from_numpy(a) for a in nnls_edge_cases(20, seed=20))
                k7[f"edges_65_lanes_K20_{solver}"] = [(G, b, 64, solver, x0, P0)]
            data["k7"] = {name: [tuple(cpu(a) for a in c) for c in calls]
                          for name, calls in k7.items()}
        raws_ds = raws[cs.DS]
        ecap = -(-(max(len(r) for r in raws_ds) // 11 + 1) // (1 << 16)) * (1 << 16)
        multi = cs.multi_round_inputs(sd, raws_ds, dev, sd.make_paths_spec(angles, s_step=64),
                                      ecap)
        if "k1s" in only:
            data["k1s"] = {name: (cpu(b), cpu(lim)) for name, (b, lim) in
                           cs.k1s_calls(torch, sd, dev, angles, multi).items()}
    if "k5s" in only:
        rows, mask, dests = multi["K5s"][0][0]
        w = k5_window(dev)[0]
        k5s = {"streams_19_carry": (rows, mask, dests),
               "streams_1_carry": (w.combined[None], w.open_mask[None], [(GCAP, None, None)])}
        data["k5s"] = {name: (cpu(r), cpu(m), [(c, cpu(o), cpu(off)) for c, o, off in d])
                       for name, (r, m, d) in k5s.items()}
    if "k6s" in only:
        args6, kw6 = multi["K6s"][0]
        one, gate = cs.k6_cases(np, torch, dev)["main_65_lanes"]
        data["k6s"] = {"streams_19_65_lanes": tuple(cpu(a) for a in (*args6, *kw6.values())),
                       "S1_65_lanes_33_live": (*(cpu(x[None]) for x in one[:8]), gate)}
    torch.save(data, path)


def recorded(dev, data, only) -> dict:
    """K7 on each recorded set (all of its calls back to back), K5's stream
    axis on each recorded carry call, and K1's and K6's stream axes on
    their recorded calls, through the wrappers."""
    from slam_process_tpu_torch.ops import cuda_compact, cuda_decode, cuda_nnls, cuda_tracker

    def put(x):
        return x.to(dev) if hasattr(x, "to") else x

    out = {}
    if "k7" in only:
        for name, calls in data["k7"].items():
            calls = [tuple(put(a) for a in c) for c in calls]
            out[f"k7_{name}_calls_lanes"] = [len(calls), int(calls[0][0].shape[0])]
            out[f"K7_{name}_ms"] = cuda_ms(
                lambda: [cuda_nnls.nnls_gram_cuda(*c) for c in calls])
    if "k5s" in only:
        for name, (rows, mask, dests) in data["k5s"].items():
            rows, mask = put(rows), put(mask)
            dests = [(c, put(o), put(off)) for c, o, off in dests]
            out[f"k5s_{name}_streams_rows_masked"] = [*rows.shape[:2], int(mask.sum())]
            out[f"K5s_{name}_ms"] = cuda_ms(
                lambda: cuda_compact.compact_rows_streams_cuda(rows, mask, dests))
    if "k1s" in only:
        for name, (b, lim) in data["k1s"].items():
            b, lim = put(b), put(lim)
            s_n, n = b.shape
            below = s_n * n if lim is None else int(lim.clamp(0, n).sum())
            out[f"k1s_{name}_streams_bytes_below"] = [s_n, n, below]
            out[f"k1s_{name}_bound_ms_bytes"] = (below + s_n * (-(-n // 11) * 21 + 4)) / 3.35e9
            out[f"K1s_{name}_ms"] = cuda_ms(
                lambda: cuda_decode.decode_rows_streams_cuda(b, lim, 0xCC, 0x33))
    if "k6s" in only:
        for name, args in data["k6s"].items():
            args = tuple(put(a) for a in args)
            out[f"k6s_{name}_live_lanes"] = [max(0, min(int(m), args[0].shape[1]))
                                             for m in args[4].tolist()]
            out[f"K6s_{name}_ms"] = cuda_ms(
                lambda: cuda_tracker.track_block_streams_cuda(*args))
    return out


def session_ms(dev) -> dict:
    """Median ms of ``run_session_on_device`` on the full session, host work
    included (CUDA events, no device sleep first), after 3 warm-up calls;
    then one call's device busy time and activities."""
    import torch

    from slam_process_tpu_torch.pipeline.device import run_session_on_device
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes

    full = dict(MULTIPATH, seed=0)
    del full["n_paths"]
    raw = synthetic_session_bytes(**full)
    for _ in range(3):
        run_session_on_device(raw, device=dev)
    torch.cuda.synchronize()
    times = []
    for _ in range(N_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_session_on_device(raw, device=dev)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    busy_ms, acts = device_activities(lambda: run_session_on_device(raw, device=dev))
    return {"session_full_ms": statistics.median(times), "session_device_busy_ms": busy_ms,
            "session_device_activities": len(acts),
            "session_activity_names": dict(collections.Counter(e.name[:80] for e in acts))}


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


def smoke():
    """This repository's ``chip_smoke.py`` as a module (its input makers)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def window_calls(dev, raw, chunk, s_step=None, angles=None):
    """{key: (args, kwargs)} of K1's, K2's and (with ``s_step``, the stream
    estimating paths on the angle table ``angles``) K4's call in a stream's
    second full window of ``chunk`` bytes, recorded from the wrappers of the
    ``slam_process_tpu_torch`` on ``sys.path`` while the stream runs, by
    this repository's ``chip_smoke.stream_window_inputs``."""
    from slam_process_tpu_torch.parallel import streaming_device as sd

    spec = None if s_step is None else sd.make_paths_spec(angles, s_step=s_step)
    return smoke().stream_window_inputs(sd, raw, chunk, dev, spec)


def k2_live_window(dev):
    """(args, kwargs) of K2's call in the live feed's second full 64 KiB
    window (after the first one's open group is carried)."""
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes

    return window_calls(dev, synthetic_session_bytes(**MULTIPATH), LIVE_CHUNK)["K2"]


def k1_k4_inputs(dev, angles):
    """K1's calls {name: (b, limit)}: the full session's padded bytes, and
    the second full window of the straddle (the full noise session in 16
    KiB windows), the live feed (64 KiB) and the dataset replay (1 MiB).
    With them, K4's {name: (p, bs, val, max_sweeps, n_beams)}: the full
    session's filtered rows, the live feed's (S = 9) and the replay's (S =
    65) second window, and the unsorted 65-sweep stream."""
    import numpy as np
    import torch

    from slam_process_tpu_torch.ops import correct
    from slam_process_tpu_torch.pipeline.device import (
        bucket_size, pad_bytes, run_session_on_device)
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes

    full = dict(MULTIPATH, seed=0)
    del full["n_paths"]
    raw_full = synthetic_session_bytes(**full)
    padded = torch.from_numpy(pad_bytes(raw_full, bucket_size(len(raw_full)))).to(dev)
    raw_ds = np.concatenate([synthetic_session_bytes(**c) for c in DATASET])
    k1 = {"full_session": (padded, padded.numel())}
    k4 = {}
    for name, raw, chunk, s_step in (("straddle_16KiB", raw_full, 1 << 14, None),
                                     ("live_64KiB", synthetic_session_bytes(**MULTIPATH),
                                      LIVE_CHUNK, 8),
                                     ("replay_1MiB", raw_ds, REPLAY_CHUNK, 64)):
        calls = window_calls(dev, raw, chunk, s_step, angles)
        k1[name] = calls["K1"][0][:2]
        if "K4" in calls:
            k4[f"{name.split('_')[0]}_S{s_step + 1}"] = calls["K4"][0]
    out = run_session_on_device(raw_full, device=dev)
    keep = out.keep.cpu().numpy()
    ue = out.frames[:, 1].cpu().numpy()[keep]
    sweep = correct.detect_groups_np(ue)
    p = torch.from_numpy((sweep * 64 + ue).astype(np.int32)).to(dev)
    k4["full_session"] = (p, out.corrected_bs[out.keep].contiguous(),
                          out.frames[:, 3][out.keep].contiguous(), int(sweep.max()) + 1, 64)
    rng = np.random.default_rng(5)           # chip_smoke.k4_cases' b_unsorted_65_sweeps
    f = 200_000
    k4["unsorted_S65"] = tuple(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (
        rng.integers(0, 65 * 64, f), rng.integers(0, 64, f),
        rng.integers(0, 1 << 18, f))) + (65, 64)
    return k1, k4


def k1_bare(cuda_decode, b, limit):
    """K1's kernel alone: one C launch into outputs made once; a checkout
    whose kernel needs zeroed outputs (no count scratch) gets them zeroed
    once, as ``chip_smoke.py`` timed it then."""
    import torch

    from slam_process_tpu_torch.ops import _build

    n = b.numel()
    r = -(-n // 11)
    outs = (torch.zeros((r, 5), dtype=torch.int32, device=b.device),
            torch.zeros(r, dtype=torch.bool, device=b.device),
            torch.zeros((), dtype=torch.int32, device=b.device))
    stream = _build.stream_of(b)
    fn = cuda_decode._fn()
    extra = ([cuda_decode.ticket_for(b.device, stream).data_ptr()]
             if hasattr(cuda_decode, "ticket_for") else [])
    args = (b.data_ptr(), n, min(int(limit), n), 0xCC, 0x33, *(t.data_ptr() for t in outs),
            *extra, stream)
    return lambda: fn(*args)


def k1_k4(dev, root: Path) -> dict:
    """K1 through the wrapper and bare, and K4 through the wrapper, at the
    shapes ``k1_k4_inputs`` gives."""
    import tempfile

    from slam_process_tpu_torch.ops import cuda_decode, cuda_sweep_sums
    from slam_process_tpu_torch.utils.synthetic import write_angle_table

    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        k1, k4 = k1_k4_inputs(dev, write_angle_table(Path(tmp) / "beam_angle.xlsx"))
    out = {}
    for name, (b, limit) in k1.items():
        out[f"K1_{name}_ms"] = cuda_ms(lambda: cuda_decode.decode_rows_cuda(b, limit, 0xCC, 0x33))
        out[f"K1_{name}_bare_ms"] = cuda_ms(k1_bare(cuda_decode, b, limit))
    for name, args in k4.items():
        out[f"k4_{name}_rows"] = int(args[0].numel())
        out[f"K4_{name}_ms"] = cuda_ms(lambda: cuda_sweep_sums.sweep_sums_cuda(*args))
    b, limit = k1["live_64KiB"]
    out["K1_live_64KiB_host_us"] = host_us(
        lambda: cuda_decode.decode_rows_cuda(b, limit, 0xCC, 0x33))
    out["K4_live_S9_host_us"] = host_us(
        lambda: cuda_sweep_sums.sweep_sums_cuda(*k4["live_S9"]))
    return out


def host_us(fn, n=50) -> float:
    """Host microseconds per call of ``fn`` over ``n`` calls issued behind
    a ~20 ms device sleep, with no sync between them."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


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

    busy_ms, acts = device_activities(live_feed)
    out["live_feed_device_busy_ms"] = busy_ms
    out["live_feed_device_activities"] = len(acts)
    out["live_feed_activity_names"] = dict(collections.Counter(e.name[:80] for e in acts))
    for key, part in (("K5", "compact"), ("K6", "track_block")):
        mine = [e for e in acts if part in e.name]
        out[f"live_feed_{key}_kernels"] = len(mine)
        out[f"live_feed_{key}_device_ms"] = sum(e.time_range.elapsed_us() for e in mine) / 1e3
    return out


def device_activities(fn):
    """(device busy ms, the device activities in start order) of one call
    of ``fn`` under ``torch.profiler``: busy is the union of the
    activities' time ranges."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    acts = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("Activity Buffer")),
                  key=lambda e: e.time_range.start)
    busy_us, reach = 0.0, float("-inf")
    for e in acts:
        busy_us += max(e.time_range.end - max(e.time_range.start, reach), 0.0)
        reach = max(reach, e.time_range.end)
    return busy_us / 1e3, acts


def main() -> None:
    if len(sys.argv) == 5 and sys.argv[1] == "--turn":
        only, inputs = sys.argv[3].split(","), sys.argv[4]
        print(json.dumps(turn(sys.argv[2], only, None if inputs == "-" else inputs)),
              flush=True)
        return
    if len(sys.argv) == 4 and sys.argv[1] == "--record":
        record(sys.argv[2], tuple(sys.argv[3].split(",")))
        return
    args = sys.argv[1:]
    rounds, only = 1, SECTIONS
    while len(args) > 2 and args[-2] in ("--rounds", "--only"):
        value = args.pop()
        if args.pop() == "--rounds":
            rounds = int(value)
        else:
            only = tuple(value.split(","))
    if len(args) != 2 or rounds < 1 or not set(only) <= set(SECTIONS):
        raise SystemExit(__doc__)
    base, change = args
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    inputs = "-"
    if set(only) & set(RECORDED):
        inputs = str(REPO / "build" / "torch_kernel_ab_inputs.pt")
        (REPO / "build").mkdir(exist_ok=True)
        res = subprocess.run([sys.executable, __file__, "--record", inputs,
                              ",".join(set(only) & set(RECORDED))],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise SystemExit(f"recording the inputs failed:\n{res.stdout}\n{res.stderr}")
    runs = {base: [], change: []}
    for root in (base, change, change, base) * rounds:
        res = subprocess.run([sys.executable, __file__, "--turn", root, ",".join(only), inputs],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise SystemExit(f"turn {root} failed:\n{res.stdout}\n{res.stderr}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        runs[root].append(line)
    keys = sorted({k for lines in runs.values() for ln in lines for k in ln
                   if k.endswith(("_ms", "_kernels", "_window", "_us", "_activities"))})
    print(json.dumps({"nvidia_smi": smi, "median_ms": {
        root: {k: statistics.median(ln[k] for ln in lines) for k in keys if k in lines[0]}
        for root, lines in runs.items()}, "spread_ms": {
        root: {k: [min(ln[k] for ln in lines), max(ln[k] for ln in lines)]
               for k in keys if k in lines[0]}
        for root, lines in runs.items()}}), flush=True)


if __name__ == "__main__":
    main()
