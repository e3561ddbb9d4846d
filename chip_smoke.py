#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``slam_process_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. env        the card (nvidia-smi name and power limit), torch and CUDA.
  2. build      nvcc builds kernels K1-K7 from ``slam_process_tpu_torch/csrc``.
  3. kernels    each kernel against its plain PyTorch version on the card, at
                the main path's shapes and on edge cases: K1, K2, K4, K5 and
                K6 equal element for element; K3 ``blurred`` bit-equal,
                ``norm_t`` within 1e-4 absolute, the same NaN pattern, LUT-bin
                flips in under 0.1 % of cells, premultiplied rgba within 1e-3;
                K7 as its contract says (below).  K2's cases: the full
                session, a planted exact-tol table and
                every input of ``utils/synthetic.verdict_edge_cases`` (blocks
                over three and over more than four groups, empty groups, gid
                out of range and negative CLK, residues straddling 0 / cycle,
                ties, resid == tol at the residue buckets' edges, cycle 60,000
                with tol 300, bmax 4, 256 and 300 with 257 groups, residues
                past cycle, 2 tol + 1 = cycle).  K3's: the session tile,
                random tiles, all-NaN and one-cell tiles, then S = 1, 4 and
                66 tiles of 64 x 64, 48 x 100 and 5 x 7 at sigma 0, 0.5, 1,
                2.3 and 3, log and linear.
                K1's cases: the full session's bytes, junk with an n_valid
                cut, 1 MiB of noise, every input of
                ``utils/synthetic.decode_edge_cases`` (all bytes 0xCC,
                frames back to back at every offset mod 11, a frame ending
                at n_valid and one byte past it, N = 0, 1, 10, 11, 12,
                5,119-5,121 and the edges of 256- and 1,024-row blocks), and
                views at every offset mod 16, each called twice on one
                stream (the count's scratch word must reset).
                K4's cases: the full session's filtered rows (58 sweeps), an
                unsorted stream over 65 sweeps, out-of-range ids and invalid
                rows, one cell summing to 2^24 - 1, 66 sweeps, no rows, every
                input of ``utils/synthetic.sweep_sums_edge_cases`` (one cell
                fed by 20,000 rows, sorted p with -1 runs and a -1 tail, S =
                1, n_beams 32, 100 and 1,500), and calls of different S and
                order interleaved on one stream.
                K5's: the dataset replay's second 1 MiB window (carry
                compaction, emit-ring append, and the fused emit-ring +
                paths call against two plain calls), a masked count past the
                capacity, no masked row, an offset at the ring's capacity, a
                ring that fills, no rows, and 4,194,304 rows at 50 %
                density 200 times, every result equal (the look-back's race
                test).  K6's: 65 lanes (33 live) from a carry, 9 lanes,
                planted ties at the gate, m_eff = 0, T * K = 40, T = 16 and K
                = 20 (uniform and on a grid of exact ties), 600 lanes at K = 3
                and at K = 20, m_eff = s1 - 1, m_eff > s1.  K7's: the NN-OMP
                refits of the paths streams' second full window (the
                replay's 65 lanes and the live feed's 9, each iteration
                warm-started, the lanes past the closed sweeps dead),
                ``utils/synthetic.nnls_edge_cases`` (cold and warm starts,
                near-collinear atoms, all-zero dead lanes, a 0/0 step-back
                ratio) at K = 3 and 20 under both solvers, K = 2 and K = 32,
                each also cold with max_outer 2: bit-equal for "auto" at K
                >= 3, else equal passive sets and x within rtol 1e-6.  The
                stream axis, at the first round of a ``MultiStreamingSession`` over
                the 19 dataset-scale sessions (recorded from its wrappers):
                K1 over [19, 1 MiB] (twice on one stream, ragged limits; S
                and N at the row blocks' edges), K5's carry and kept-row
                calls (19 streams, offsets at capacity, rings that fill, no
                rows, 2 and 64 streams whose rings at nonzero offsets and
                zero-tailed buffers overflow, 4 streams of 1 M rows at 50 %
                100 times: the look-back's race test at S > 1), K6 over 19
                trackers and
                over stacks of the cases above; the flattened K2 call (19
                streams; 12 tiny sessions whose 256-row blocks span
                sessions) and K4 call (19 x 65 sweep lanes) against 19
                separate kernel calls.  Then one device
                activity per ``decode_rows``, K4, K5, K6 and K7 wrapper call,
                under ``torch.profiler`` (no fill, no second kernel), and one
                K4 kernel per ``intensity_per_sweep_sums`` call (whose row
                filter is plain torch; its activities are reported).
  4. main_path  ``Session.from_log`` on hex-text logs: one full-size session
                (58 groups x 64 beams x 43 frames, one group of >= 4,400
                frames), 19 dataset-scale sessions (~56 k frames each) and
                the full size again with planted multipath RSS.
                The launch counters are set to 0 just before and read just
                after; every kernel must have launched.  Every
                ``DeviceSessionOut`` field on the card is then held against
                the same pipeline with ``device="cpu"`` (integer and bool
                fields and ``mean_grid`` exactly, the raster as in phase 3),
                and each other session's frames / corrected_bs / filtered
                against its CPU run.  Two logs past the corrector's default
                bounds (300 groups; 300 baselines in a group) must rerun K2
                on the card with bounds sized to them and equal their CPU
                run.
  5. sweep_paths ``Session.sweep_paths`` (per-sweep NN-OMP, 886 x 886 grids)
                on the 21 CUDA sessions of phase 4 with a seeded 64-beam
                angle table, K4's and K7's launch counters set to 0 just
                before and read just after (both must launch, with no NNLS
                host sync); each result against the same session's
                ``device="cpu"`` run: sweep_valid, n_iters, indices and valid
                equal, power within rtol 2e-4 / atol 1e-6, and
                ``sweep_intensity`` counts and mean (NaN included) equal.
  6. streaming  ``DeviceStreamingSession`` on the card, the launch counters
                set to 0 just before and read just after (K1, K2, K4, K5, K6
                and K7 must launch): (1) the live feed, the full multipath
                session in 64 KiB chunks with s_step=8, ``collect_filtered``
                and ``collect_paths`` at full width (64 x 64 beams, 886 x 886
                grids, K = 3, T = 8); (2) the dataset replay, the 19 dataset
                sessions as one stream through ``replay_log_device`` at 1 MiB
                windows with s_step=64 (an emit ring of > 2^18 rows); (3) the
                straddle, the full noise session in 16 KiB windows with
                ``collect_filtered`` (its 4,416-frame group 0 crosses several
                window edges); (4) the live feed saved halfway, restored and
                finished; (5) the dataset fed in 1 MiB chunks with the
                default emit ring, which must grow in place past 2^18 rows.
                Each against the host engine (``filtered``,
                ``intensity()``), its paths readers against the offline
                ``Session.sweep_paths`` / ``path_tracks(beam_ids=...)`` on the
                card exactly, (1), (3) and (4) against the same stream with
                ``device="cpu"`` (power within rtol 2e-4), no overflow.  Then
                bytes/s and frames/s of (1) and (2) (CUDA events around feed,
                finalize and ``block_until_ready``, median of 5 after a
                warm-up), ms per window, host ms per full and per short
                window (synchronized around each), the host syncs of (1),
                (2) and (3) by source line under
                ``torch.cuda.set_sync_debug_mode``, which must equal the
                counters' sum and be 0 (every window, paths included, is a
                CUDA graph replay that reads nothing back), and the device
                busy share of (1) under ``torch.profiler``, where the K1,
                K4, K5, K6 and K7 device kernels must equal the wrapper
                calls.  Across the five
                streams K5 runs twice per window (the carry; one fused call
                for the kept rows) and once per flush, or the run fails.
  7. cli        the user surface, on the card and then with ``--device
                cpu``: ``cli.main`` ``decode`` (the full session, a log with
                flag bytes spliced in, v1 and v2 streams, the 257-group
                log), ``correct --output`` / ``--in-place`` on the full
                session's Parsed xlsx, ``correct --run-tests`` (K2 must
                launch), ``correct`` on the 257-group xlsx (K2 exactly
                twice); the ``session`` command's Session calls one by one
                (``from_log``, ``correct``, ``export_parsed`` /
                ``export_filtered`` of 161,280 / 155,035 rows,
                ``render_heatmap(mapping, None)``, ``save_npz``), read back
                (``from_parsed_xlsx`` + ``correct``, ``from_filtered_xlsx``,
                ``load_npz``); the heatmap command's variants v1, v2, v3,
                ``--no-logscale``, vmin / vmax, and a table with unmapped
                beams.  The card's and the CPU's xlsx sheet XML equal byte
                for byte, npz arrays exactly, printed lines and counters
                equal, rasters within 1e-4 on norm_t with < 0.1 % bin flips;
                K1, K2 and K3 launched.  Before them (not counted): K3 with
                explicit vmin / vmax against its plain version at S = 1 and
                4, 64 x 64 and 59 x 61.  Host ms per step on both devices.
                The PNG is not drawn where matplotlib is missing (the card's
                machine); a line says so.
  8. estimate   the session estimator: the ``estimate`` command's steps on
                the full multipath log on the card, launches counted (K1, K2,
                K3, K4 and K6 must launch): decode + correct, ``run_estimator``
                for the five NN-OMP flavors at full width (886 x 886 grids,
                K = 20 for v1-7), ``--per-sweep`` through ``cli.main``, and
                ``--tracks --changes`` through the command's own helpers (the
                track PNG needs matplotlib; a line says it was not drawn);
                the same with ``--device cpu``: printed lines equal, the
                three xlsx read back with integer columns equal and the rest
                within rtol 2e-4.  Each flavor's NN-OMP on the card against
                ``device="cpu"`` and the float64 host engine: selections,
                ``n_iters`` and ``valid`` equal, power within rtol 2e-4
                (a difference is excused only where the oracle's top two
                correlations sit within 1e-5 of the surface's scale), labels
                equal outside 0.0017 dB of a classifier threshold.
                ``estimate_sessions`` over the 21 sessions (v1-7, v1)
                against their per-session card runs.  The RBF background
                of the full scene (4,096 centres) on the card against
                numpy float64, within 1e-6 of the range.  Times (CUDA
                events, median of 5 after a warm-up, host work inside):
                ``run_estimator`` on the card and with ``engine="host"``,
                the bare ``run_nn_omp``, ``estimate_sessions`` in
                sessions/s, the RBF on the card and in numpy, LU against
                Gauss-Jordan NNLS at K = 20 for one session and for 21;
                NNLS host syncs per call, which must be 0 (K7); one
                profiled ``run_estimator``.
 8b. est_forms  the session estimator's comparator forms: the 21 logs
                decoded anew (``Session.from_log``: K1-K3 counted), their
                v1-7 scenes (0.1 deg grids, K = 20) packed once on the card
                and run as ``_batched_nn_omp`` "vmap" (production) and
                "gram" and as ``nn_omp_sessions_device`` (21 runs); each
                form against "vmap" (indices, n_iters and valid equal, power
                within rtol 2e-4; a difference excused only at a near tie
                of the float64 oracle), sessions 0, 1 and the multipath
                against ``nn_omp_np``; the multipath session's 58 sweeps at
                the per-sweep config (886 x 886, K = 3): ``nn_omp_batch``
                against ``nn_omp_gram_batch``; ``detect_scene_changes`` on
                its tracks from K4 / K6 on the card, bit-equal to
                ``detect_scene_changes_np`` on the tracks read back.  Per
                form: wall ms (CUDA events, median of 5 after a warm-up),
                device ms and activities from
                ``utils/device_timing.measure_device_time`` (median of 3,
                one run of the per-session form), the top activity names,
                and ``device_profile``'s busy ms beside it, K7's device ms
                and share of the form's device time (``op_device_times``;
                ``run_estimator("nn_omp")`` on the multipath session too);
                no NNLS host sync in any timed form.
 8c. k7_estimator K7's calls where the session estimator makes them,
                recorded from the wrapper (``estimator_k7_calls``):
                ``run_estimator("nn_omp")`` on the full multipath session
                (1 lane) and the "vmap" form over the 21 sessions (21
                lanes), K = 20 under "lu", one call an NN-OMP iteration;
                each call held to K7's contract.
  9. replay     the ``replay --paths --changes`` command's steps
                (``cli.replay_stream``, ``render()``, ``cli.replay_exports``;
                the PNG needs matplotlib) on the card, counted (every kernel
                must launch, K3 through ``render()``): the full multipath
                log at 64 KiB and the 19 dataset-scale logs at 1 MiB, each
                against the same steps with ``--device cpu`` and with
                ``--engine host``: stats equal, the filtered xlsx sheet XML
                byte for byte, track and change tables with integer columns
                equal and the rest within rtol 2e-4, ``render()``'s raster
                within the ``cli`` phase's tolerances.  Frames/s per engine
                and chunk size, windows per log, ``render()`` host ms and
                its device busy share.
 10. watch      ``watch --paths --changes --events --checkpoint
                --checkpoint-every`` on the card over a file that a writer
                thread grows with the full multipath log's text in seeded
                random pieces (each after the watch read the one before), the
                PNG left out; a second card watch resumed from a copy of a
                mid-stream checkpoint and of the events file at that moment,
                on the finished file, must give the same tables, events and
                raster with no event written twice; the finished file
                watched with ``--device cpu`` and with ``--engine host``
                must agree with the card (events line for line, power within
                rtol 2e-4).  Host ms per fed poll (synchronized), checkpoint
                save and restore ms.
 11. run_config ``serial_hex_to_excel_v3``, ``batched_session`` and
                ``streaming_replay`` on a directory of four dataset-scale
                logs, on the card (counted) and with ``--device cpu``: the
                results equal apart from their timings, the Parsed xlsx
                byte for byte.  (The other two configs draw PNGs; the CPU
                tests run them.)
 12. ingest     the text path: the full session and the 19 dataset-scale
                sessions written in the shipped stride-3 layout (one "XX "
                stream behind the guillemet marker) give the written bytes
                from ``read_hex_log(engine="native")``, from numpy and from
                the card's ``ops/tokenize.tokenize_stride3`` (proof flag
                True), the reference tokenizer on the full session once;
                ``run_session_from_text`` on the card equals
                ``run_session_on_device(read_hex_log(...))`` on the card in
                every field, the raster bit-equal; three logs in the CRLF
                layout take the host fallback with equal outputs; K1-K3
                counted.  Host ms of each tokenizer per layout (median of
                7), the card's tokenize ms (CUDA events, median of 20) and
                device activities, the text path against ``Session.from_log``
                (host ms, median of 7), the host CPU's model and flags.
 13. prelog     the pre-log scene: ``run_session_on_device(
                log_transform_scene=True)`` on the card against
                ``device="cpu"`` (integer fields exactly, means within one
                float32 ulp) and the float64 oracle ``intensity_grid_np``
                (counts equal, means within rtol 1e-6); a pre-log live feed
                of the multipath log in 64 KiB chunks (``collect_filtered``)
                against the offline filtered rows and the oracle, and the
                same stream resumed from a checkpoint.
 14. sm_sic     ``run_estimator("sm_sic")`` on the card against
                ``engine="host"`` and ``device="cpu"`` (peaks equal, metric
                within rtol 1e-6); ``sweep_paths(estimator="sm_sic")`` and
                its ``path_tracks`` against ``device="cpu"`` on three
                sessions; ``sweep_paths_dataset`` (NN-OMP) over phase 5's 21
                sessions against their phase-5 results exactly; an SM-SIC
                stream of the multipath log in 64 KiB chunks against the
                offline ``sweep_paths`` / ``path_tracks(beam_ids=...)`` on the
                card exactly.
 15. estimators the registry's other seven families (svd, omp_dense,
                lasso_refine, peak_picking, fusion, nn_omp_v13, geometric)
                through ``run_estimator`` at full width (the shipped grids)
                on the full multipath and the full noise session, decoded and
                corrected on the card (K1 and K2 counted): each table on the
                card against ``device="cpu"`` and ``engine="host"``
                (``estimator_tables_differ``: rows, labels and cells equal,
                values within the family's bound); the table's head; host ms
                of the first card call and of the host engine (one run each);
                on the multipath session the card call's host ms (median of 5
                after a warm-up, synchronized), its device busy ms and
                activities under ``torch.profiler``, the LASSO loop's own ms
                and activities; the omp_dense oracle's smallest selected
                column norm (JAX's device rule skips <= 1e-15).
 16. batch      ``parallel/batch.run_dataset`` over the 21 sessions of phase 4
                in both forms: field for field equal to each session's
                ``run_session_on_device`` on the card (rasters bit-equal),
                the vmap form against ``device="cpu"`` under phase 3's raster
                bounds; K1, K2 and K3 launch once per bucket group (vmap) and
                once per session (scan); sessions/s of vmap, scan and the
                per-session loop (CUDA events, median of 20 after a warm-up,
                host work included).
 17. multi_stream the 19 dataset-scale sessions as 19 streams of one
                ``MultiStreamingSession`` at 1 MiB windows with
                ``collect_paths`` (s_step 64, K = 3, T = 8) and a fixed emit
                ring: each stream against its own ``DeviceStreamingSession``
                on the card exactly, one launch per stage per round (K5
                twice), a ragged finalize with a reset and a checkpoint
                resume at 256 KiB windows, ``watch --logs`` on three growing
                captures (capture 0 finalized alone) against ``--device
                cpu``; ms per round and flush and bytes/s (median of 5 after
                a warm-up), host syncs by source line in sync debug mode
                equal to the counters (one count read a round and flush, no
                NNLS sync), K7 once per 8-lane block and NN-OMP iteration
                (the block form), the device's busy share.
 18. timing     CUDA-event medians of 20 runs after a warm-up: each kernel
                (K1, K4, K5, K6, K7 through their wrappers, K1 also as the bare
                launch; K2, K3 as the bare launch, K3 also with vmin /
                vmax), its plain version on the
                card, K1 and K2 at three stream windows (the second full
                window of the straddle's 16 KiB, the live feed's 64 KiB and
                the replay's 1 MiB) and K4 at the live feed's (S = 9) and
                the replay's (S = 65), the stream-axis K1, K5 and K6 at the 19
                streams' round and the flattened K2 / K4 calls against 19
                separate calls, the library yardsticks
                (K4: two ``torch.bincount`` calls; K5: ``rows[mask]``), K7
                at the replay's 65 lanes and beside it at the live feed's 9
                lanes, at 65 lanes of K = 20 under both solvers and on phase
                8c's refits (a run's 20 calls back to back, and each alone),
                each with its outer steps, solves and bound, K5's
                fused kept-row call against the two calls it replaced, the
                whole ``run_session_on_device`` in frames/s at both sizes, and
                ``sweep_paths`` in sweeps/s (a cleared memo: the host prep,
                K4 and the estimator; and a warm memo: the estimator); then
                one full-size session and the full-size ``sweep_paths`` of the
                noise and the multipath session (cold, then warm) under
                ``torch.profiler``: the device's busy time, its share, the top
                ops, and the estimator's host syncs.

 19. mesh       the mesh forms on positions of cuda:0 (``mesh_phase``).
 20. multihost  two-process gloo clusters on cuda:0 (``multihost_phase``).
 21. graphs     the compiled programs as CUDA graphs against their eager
                bodies on the card, floats bit for bit (the pre-log scene
                within one float32 ulp): ``compiled_session_pipeline`` and
                ``compiled_text_session_pipeline`` on two sessions of one
                bucket alternated, at full size and at dataset scale, and
                the window graph of a stream without paths (the live feed at
                64 KiB, the straddle at 16 KiB, the 19 dataset logs replayed
                at 1 MiB) against the eager round, the whole state; the
                paths window graph (the live feed at 64 KiB with s_step 8,
                the 19 logs replayed at 1 MiB with s_step 64) against the
                eager round after every feed and after the flush; then
                eager against graph: wall ms, frames/s, device ms and
                activities a session call, capture ms and pool bytes, ms
                per window (device ms per window too with paths), and
                ``cli.replay_stream`` with and without ``--paths``, every
                window a graph replay, timed as phase 6 times streams
                (``graphs_phase``); the batch's programs, both forms and
                both ``outputs``, two buckets alternated, and ``run_dataset``
                against their eager bodies, then eager against graph
                (``batch_graphs``); the 19 streams' rounds at 1 MiB and at
                steady 64 KiB (and a (2, 1) mesh of cuda:0) against the
                eager rounds after every feed, a ragged flush and the
                flush, ms and device ms a round eager and graph, the graphs
                by block count with capture ms and pool bytes, and the
                blocks as one call and private pools beside them
                (``multi_graphs``).

On CUDA the session entry points, the batch, a single stream with or
without paths and the multi-stream round run CUDA graphs
(``utils/graphs.py``): a replay calls no wrapper, so
it adds to each kernel's counter the launches its capture recorded.  Every kernel's
launches are counted on each path (phases 4 to 17, 8b, 19 to 21,
the counters set to 0 just before and read just after), reported in the
``kernels`` line as ``launches_by_path``; ``launches`` is the count on the
kernel's own path.  The stream-axis entries add to their kernel's counter
and have rows of their own (K1s, K5s, K6s: launches on the batch and
multi_stream paths, times at the 19 streams' round).  K7's row also splits
its launches by K (``launches_by_k``, on the paths where the split adds up).
Then the ``bounds`` and ``kernels`` JSON lines, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.  Data
is synthetic, made from fixed seeds; temporary logs go under ``build/``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
T_START = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and non-tensor f32.
# int32: 128 instructions per SM per clock (four schedulers, one 32-lane
# warp instruction each) x 132 SMs x 1.98 GHz boost = 33.45 T op/s.  The
# white paper's 64 INT32 cores per SM are one pipe: IMAD issues to the FMA
# pipe beside it.  tools/int32_rate.py measured per SM per clock 63.6 IMAD
# alone and 101 integer instructions of add / xor code (compiled to LOP3 +
# IMAD) on an NVIDIA H100 80GB HBM3 at 700.00 W, so 64 is not a peak.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12               # float64 outside the tensor cores (NVIDIA's data sheet)
PEAK_INT32_PER_S = 132 * 128 * 1.98e9

FULL = dict(n_groups=58, frames_per_beam=43, baselines_per_group=93, junk_frac=0.02,
            big_group=4400, seed=0)
DATASET = [dict(n_groups=20, frames_per_beam=44, baselines_per_group=93, junk_frac=0.02,
                big_group=0, seed=100 + i) for i in range(19)]
# The full session's shape with RSS from three planted multipath scenes
# (the traffic the estimator is built for), and logs past the corrector's
# default bounds of 256 groups and 256 baselines in a group.
MULTIPATH = dict(FULL, seed=1, n_paths=3)
OVERFLOW = {"groups_300": dict(n_groups=300, frames_per_beam=1, baselines_per_group=1,
                               junk_frac=0.02, seed=200),
            "baselines_300": dict(n_groups=3, frames_per_beam=10, baselines_per_group=300,
                                  junk_frac=0.02, seed=201)}
DS = slice(1, 1 + len(DATASET))      # the dataset sessions among phase 4's
MP = 1 + len(DATASET)                # the multipath session's index
MAX_GROUPS = MAX_BASELINES = 256
N_TIMED = 20
N_STREAM_RUNS = 5
LIVE_CHUNK = 1 << 16                 # the live feed's serial chunks
REPLAY_CHUNK = 1 << 20               # the dataset replay's windows
STRADDLE_CHUNK = 1 << 14
GCAP = 8192                          # DeviceStreamingSession's default group_capacity


def emit(obj) -> None:
    """One JSON line; a phase's line also gets the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
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
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build", prefix="chip_smoke-") as tmp:
        run(Path(tmp))


def run(tmp: Path) -> None:
    """The phases and the last lines; temporary files go under ``tmp``."""
    import numpy as np
    import torch

    from slam_process_tpu_torch.ops import (
        _build, compact, correct, cuda_compact, cuda_correct, cuda_decode, cuda_nnls,
        cuda_raster, cuda_sweep_sums, cuda_tracker, decode, nnls, raster, scene, tracker)
    from slam_process_tpu_torch.parallel import streaming_device as sd
    from slam_process_tpu_torch.pipeline.device import (
        bucket_size, pad_bytes, run_session_on_device)
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import (
        decode_edge_cases, nnls_edge_cases, sweep_sums_edge_cases, synthetic_session_bytes,
        to_hex_text, verdict_edge_cases, write_angle_table)

    dev = torch.device("cuda")
    counted = {"K1": cuda_decode, "K2": cuda_correct, "K3": cuda_raster,
               "K4": cuda_sweep_sums, "K5": cuda_compact, "K6": cuda_tracker,
               "K7": cuda_nnls}

    k7_split = {}                 # K7's launches by K at the last read_counts()
    by_path, k7_by_k = {}, {}     # each path's launches, and K7's by K

    def zero_counts():
        for m in counted.values():
            m.LAUNCHES = 0
        cuda_nnls.LAUNCHES_BY_K.clear()

    def read_counts():
        k7_split.clear()
        k7_split.update(cuda_nnls.LAUNCHES_BY_K)
        return {k: m.LAUNCHES for k, m in counted.items()}

    def counted_path(name, counts, split=None):
        """A path's launches, and K7's split by K where it adds up to them."""
        by_path[name] = counts
        split = dict(k7_split) if split is None else split
        k7_by_k[name] = split if sum(split.values()) == counts["K7"] else None

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
    out_full = run_session_on_device(raw_full, device=dev, count_discards=True)
    frames, valid = out_full.frames, out_full.frame_valid
    gid, packed, _ = correct.baseline_table(frames, valid, MAX_GROUPS, MAX_BASELINES)
    clk = frames[:, 4].contiguous()
    tile = out_full.mean_grid.T.contiguous()[None]
    # K4's: the full session's filtered rows (as Session.from_log keeps
    # them) with their sweep ids, p = gid * 64 + ue.
    keep_h = out_full.keep.cpu().numpy()
    ue_h = frames[:, 1].cpu().numpy()[keep_h]
    sweep_h = correct.detect_groups_np(ue_h)
    n_sweeps = int(sweep_h.max()) + 1
    k4_p = torch.from_numpy((sweep_h * 64 + ue_h).astype(np.int32)).to(dev)
    k4_bs = out_full.corrected_bs[out_full.keep].contiguous()
    k4_val = frames[:, 3][out_full.keep].contiguous()
    torch.cuda.synchronize()

    # -- 3. kernels against their plain versions --------------------------------
    err = {key: 0.0 for key in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K1s", "K5s",
                                "K6s")}                               # exact ones stay 0
    cases = []

    def exact(key, case, got, want):
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w.to(g.device)):
                fail(f"{key} {case}: kernel and plain version differ")
        cases.append(f"{key}:{case}")

    def raster_close(key, case, got, want, flips_max=1e-3, bit_equal=True):
        """got / want = (rgba, norm_t, blurred); ``blurred`` bit-equal, or
        within 1e-5 relative where two devices are compared."""
        (rgba, t, b), (rgba_p, t_p, b_p) = got, want
        if not torch.equal(torch.isnan(b), torch.isnan(b_p)) or not torch.equal(
                torch.isnan(t), torch.isnan(t_p)):
            fail(f"{key} {case}: NaN patterns differ")
        if bit_equal and not torch.equal(b.nan_to_num(0.0), b_p.nan_to_num(0.0)):
            fail(f"{key} {case}: blurred is not bit-equal")
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
    # K1's edge inputs (all flags, back-to-back frames at every offset mod
    # 11, a frame ending at n_valid and one byte past it, N at the row
    # blocks' edges); views at every 16-byte misalignment, each called twice
    # on one stream (the count's scratch word must be back at 0).
    for case, (raw_e, nv) in decode_edge_cases().items():
        b_e = torch.from_numpy(raw_e)
        exact("K1", case, cuda_decode.decode_rows_cuda(
            b_e.to(dev), len(raw_e) if nv is None else nv, 0xCC, 0x33),
            decode.decode_rows_plain(b_e, n_valid=nv))
    for off in range(16):
        want = decode.decode_rows_plain(junk[off:], n_valid=junk.numel() - off - 3)
        for rep in range(2):
            exact("K1", f"view_offset_{off}_call_{rep}", cuda_decode.decode_rows_cuda(
                junk[off:], junk.numel() - off - 3, 0xCC, 0x33), want)

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
    for case, (g_e, c_e, p_e, kw) in verdict_edge_cases().items():
        args = [torch.from_numpy(x).to(dev) for x in (g_e, c_e, p_e)]
        exact("K2", case, cuda_correct.correct_verdicts_cuda(*args, **kw),
              correct.baseline_plane_verdicts(*args, **kw))

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
    for (s_n, shape, sigma), mats in k3_cases(torch).items():
        mats, taps_s = mats.to(dev), raster.blur_taps(sigma, dev)
        for use_log in (True, False):
            raster_close("K3", f"S{s_n}_{shape[0]}x{shape[1]}_sigma{sigma}_log={use_log}",
                         cuda_raster.raster_tiles_cuda(mats, lut, taps_s, use_log),
                         raster.raster_tiles_plain(mats, lut, taps_s, use_log))

    # K4: (a) the main path's rows; (b)-(f) the edge cases; the edge inputs
    # of utils/synthetic.sweep_sums_edge_cases (one cell over many tiles,
    # sorted p with -1 runs and a -1 tail, S = 1, n_beams 32, 100, 1,500);
    # calls of different S and order interleaved on one stream.
    k4 = k4_cases(np, torch, dev, k4_p, k4_bs, k4_val, n_sweeps)
    for case, (p4, b4, v4, s4) in k4.items():
        exact("K4", case, cuda_sweep_sums.sweep_sums_cuda(p4, b4, v4, s4),
              scene.sweep_sums_plain(p4, b4, v4, s4))
    for case, (p4, b4, v4, s4, nb4) in sweep_sums_edge_cases().items():
        args = [torch.from_numpy(x).to(dev) for x in (p4, b4, v4)]
        exact("K4", case, cuda_sweep_sums.sweep_sums_cuda(*args, s4, nb4),
              scene.sweep_sums_plain(*args, s4, nb4))
    for i, case in enumerate(("a_main_path", "b_unsorted_65_sweeps", "a_main_path",
                              "e_66_sweeps", "b_unsorted_65_sweeps", "d_one_cell_2^24-1")):
        exact("K4", f"interleaved_{i}_{case}", cuda_sweep_sums.sweep_sums_cuda(*k4[case]),
              scene.sweep_sums_plain(*k4[case]))
    rng = np.random.default_rng(21)
    ips_rows = [torch.from_numpy(x).to(dev) for x in (
        rng.integers(-2, 67, 30_000).astype(np.int32), rng.integers(-1, 65, 30_000).astype(
            np.int32), rng.integers(0, 1 << 18, 30_000).astype(np.int32),
        rng.integers(-1, 8, 30_000).astype(np.int32), rng.random(30_000) < 0.8)]
    exact("K4", "ids_out_of_range_via_intensity_per_sweep_sums",
          scene.intensity_per_sweep_sums(*ips_rows, max_sweeps=6),
          scene.intensity_per_sweep_sums(*(t.cpu() for t in ips_rows), max_sweeps=6))

    # K5: the dataset replay's second window; K6: the streams' lane shapes.
    raw_ds = np.concatenate([synthetic_session_bytes(**c) for c in DATASET])
    k5 = k5_inputs(torch, sd, raw_ds, dev)
    exact("K5", "carry_1MiB_window", cuda_compact.compact_rows_cuda(k5["rows"], k5["open"], GCAP),
          compact.compact_rows_plain(k5["rows"], k5["open"], GCAP))
    exact("K5", "emit_append_1MiB_window", cuda_compact.compact_rows_cuda(
        k5["kept"], k5["keep"], k5["ecap"], out=k5["ring"].clone(), offset=k5["offset"]),
        compact.compact_rows_plain(k5["kept"], k5["keep"], k5["ecap"], out=k5["ring"].clone(),
                                   offset=k5["offset"]))
    for case, mask in (("past_capacity", k5["rows"][:, 1] >= 0),
                       ("no_masked_row", torch.zeros_like(k5["open"]))):
        exact("K5", case, cuda_compact.compact_rows_cuda(k5["rows"], mask, GCAP),
              compact.compact_rows_plain(k5["rows"], mask, GCAP))
    # The stream's fused call (emit ring + the paths' fresh buffer), then an
    # offset at the ring's capacity and a ring that fills (rows drop).
    n_kept_w = int(k5["keep"].sum())
    for case, ring_cap, ring_off in (
            ("emit_and_paths_1MiB_window", k5["ecap"], k5["offset"]),
            ("offset_at_capacity", k5["ecap"], torch.full_like(k5["offset"], k5["ecap"])),
            ("dest_past_capacity", int(k5["offset"]) + n_kept_w // 2, k5["offset"])):
        dests = [(ring_cap, k5["ring"].clone(), ring_off), (k5["kept"].shape[0], None, None)]
        got_o, got_n = cuda_compact.compact_rows_multi_cuda(k5["kept"], k5["keep"], dests)
        want = [compact.compact_rows_plain(k5["kept"], k5["keep"], cap, out, off)
                for cap, out, off in [(ring_cap, k5["ring"].clone(), ring_off),
                                      (k5["kept"].shape[0], None, None)]]
        exact("K5", case, (*got_o, got_n), (want[0][0], want[1][0], want[0][1]))
    empty = torch.zeros((0, 5), dtype=torch.int32, device=dev)
    no_mask = torch.zeros(0, dtype=torch.bool, device=dev)
    exact("K5", "no_rows", cuda_compact.compact_rows_cuda(empty, no_mask, GCAP),
          compact.compact_rows_plain(empty, no_mask, GCAP))
    k5_race_check(torch, compact, cuda_compact, dev)
    cases.append("K5:4M_rows_50pct_x200")
    k6 = k6_cases(np, torch, dev)
    for case, (args, gate) in k6.items():
        exact("K6", case, cuda_tracker.track_block_cuda(*args, gate),
              tracker.track_block_plain(*args, gate))
    # The stream axis: K1, K5 and K6 over the 19 dataset streams' first
    # round (recorded from a MultiStreamingSession), K2 and K4 flattened.
    angles = write_angle_table(tmp / "beam_angle.xlsx")
    # K7: the NN-OMP refits of the paths streams' second full window
    # (recorded from an eager stream: the replay's 65 lanes, the live feed's
    # 9, each iteration warm-started from the one before, the lanes past the
    # window's closed sweeps dead), then nnls_edge_cases at K = 3 and 20
    # under both solvers, K = 2 and the limit K = 32: bit-equal for "auto"
    # at K >= 3, else equal passive sets and x within rtol 1e-6.
    k7 = {}
    for name, raw_k7, chunk, s_step in (
            ("replay", raw_ds, REPLAY_CHUNK, 64),
            ("live", synthetic_session_bytes(**MULTIPATH), LIVE_CHUNK, 8)):
        for it, call in enumerate(k7_stream_calls(sd, raw_k7, chunk, dev,
                                                  sd.make_paths_spec(angles, s_step=s_step))):
            k7[f"{name}_{call[0].shape[0]}_lanes_iter{it}"] = call
    for k, solver in ((3, "auto"), (3, "lu"), (20, "auto"), (20, "lu"), (2, "auto"),
                      (32, "auto")):
        G, b, x0, P0 = (torch.from_numpy(a).to(dev) for a in nnls_edge_cases(k, seed=k))
        k7[f"edges_K{k}_{solver}"] = (G, b, 64, solver, x0, P0)
        k7[f"edges_K{k}_{solver}_cold_max_outer_2"] = (G, b, 2, solver, None, None)
    def check_k7(case, args):
        got = cuda_nnls.nnls_gram_cuda(*args)
        want = nnls.nnls_gram_plain(*args)
        k_n, solver = args[0].shape[1], args[3]
        if not (torch.equal(got[1], want[1]) and torch.isfinite(got[0]).all()):
            fail(f"K7 {case}: passive sets differ from the plain version, or x is not finite")
        if k_n == 3 or (k_n > 3 and solver == "auto"):
            if not torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)):
                fail(f"K7 {case}: x differs from the plain version")
        elif not torch.allclose(got[0], want[0], rtol=1e-6, atol=0.0):
            fail(f"K7 {case}: x beyond rtol 1e-6 of the plain version")
        err["K7"] = max(err["K7"], float((got[0] - want[0]).abs().max()))
        cases.append(f"K7:{case}")

    for case, args in k7.items():
        check_k7(case, args)
    k7_main = k7["replay_65_lanes_iter2"]
    raws_ds = [synthetic_session_bytes(**c) for c in DATASET]
    multi_ecap = -(-(max(len(r) for r in raws_ds) // 11 + 1) // (1 << 16)) * (1 << 16)
    multi = multi_round_inputs(sd, raws_ds, dev, sd.make_paths_spec(angles, s_step=64),
                               multi_ecap)
    k1s = k1s_calls(torch, sd, dev, angles, multi)
    stream_axis_cases(np, torch, dev, exact, decode, compact, correct, scene, tracker,
                      cuda_decode, cuda_compact, cuda_correct, cuda_sweep_sums, cuda_tracker,
                      multi, k6, k1s)
    torch.cuda.synchronize()
    # One device kernel per wrapper call, whatever the form: ten calls each
    # under torch.profiler (before any other profiling in this process).
    ring, n_w = k5["ring"].clone(), k5["kept"].shape[0]
    fused = [(k5["ecap"], ring, k5["offset"]), (n_w, None, None)]
    per_call = {}
    for case, fn in (
            ("K1", lambda: decode.decode_rows(padded)),
            ("K4", lambda: cuda_sweep_sums.sweep_sums_cuda(k4_p, k4_bs, k4_val, n_sweeps)),
            ("K5", lambda: cuda_compact.compact_rows_cuda(k5["rows"], k5["open"], GCAP)),
            ("K5_fused", lambda: cuda_compact.compact_rows_multi_cuda(k5["kept"], k5["keep"],
                                                                      fused)),
            ("K6", lambda: cuda_tracker.track_block_cuda(*k6["main_65_lanes"][0],
                                                         k6["main_65_lanes"][1])),
            ("K7", lambda: cuda_nnls.nnls_gram_cuda(*k7_main))):
        fn()
        torch.cuda.synchronize()
        per_call[case] = device_profile(torch, lambda: [fn() for _ in range(10)])[1] / 10
        if per_call[case] != 1:
            fail(f"{case}: a wrapper call ran {per_call[case]} device activities, not one "
                 "kernel")
    # intensity_per_sweep_sums runs its row filter (plain torch) before the
    # one K4 launch: its activities are reported, its K4 kernels must be one.
    _, acts, _, named = device_profile(
        torch, lambda: [scene.intensity_per_sweep_sums(*ips_rows, max_sweeps=6)
                       for _ in range(10)],
        count=("sweep_sums_kernel",))
    per_call["intensity_per_sweep_sums"] = acts / 10
    if named["sweep_sums_kernel"] != 10:
        fail(f"intensity_per_sweep_sums: {named['sweep_sums_kernel']} K4 kernels in 10 calls")
    emit({"phase": "kernels", "cases": cases, "max_abs_err": err,
          "device_activities_per_call": per_call})

    # -- 4. main path ------------------------------------------------------------
    specs = ([("full", FULL)] + [(f"dataset_{i:02d}", c) for i, c in enumerate(DATASET)]
             + [("full_multipath", MULTIPATH)])
    paths, raws = [], []
    for name, cfg in specs:
        raw = synthetic_session_bytes(**cfg)
        path = tmp / f"{name}.txt"
        path.write_bytes(to_hex_text(raw))
        paths.append(path)
        raws.append(raw)

    zero_counts()
    t0 = time.perf_counter()
    sessions = [Session.from_log(p) for p in paths]
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counted_path("main_path", read_counts())
    launches = {k: by_path["main_path"][k] for k in ("K1", "K2", "K3")}
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
    for name, cfg in OVERFLOW.items():
        path = tmp / f"{name}.txt"
        path.write_bytes(to_hex_text(synthetic_session_bytes(**cfg)))
        k2_before = cuda_correct.LAUNCHES
        s = Session.from_log(path)
        if cuda_correct.LAUNCHES - k2_before != 2:
            fail(f"{name}: the corrector was not rerun on the card past its default bounds")
        ref = Session.from_log(path, device="cpu")
        for field in ("frames", "corrected_bs", "filtered"):
            if not np.array_equal(getattr(s, field), getattr(ref, field)):
                fail(f"{name}: {field} differs between cuda and cpu")
        if len(s.filtered) == 0:
            fail(f"{name}: no frame was corrected")

    out_cpu = run_session_on_device(raw_full, device="cpu", count_discards=True)
    bad = outputs_differ(torch, out_full, out_cpu, [f for f in out_full._fields
                                                    if f not in ("rgba", "blurred", "norm_t")])
    if bad:
        fail(f"full session: {bad} differ between cuda and cpu")
    raster_close("pipeline", "full_cuda_vs_cpu",
                 tuple(getattr(out_full, f).cpu()[None] for f in ("rgba", "norm_t", "blurred")),
                 tuple(getattr(out_cpu, f)[None] for f in ("rgba", "norm_t", "blurred")),
                 bit_equal=False)
    if out_full.rgba.shape != (64, 64, 4) or not torch.isfinite(out_full.rgba).all():
        fail("full session: rgba is not a finite [64, 64, 4] raster")
    emit({"phase": "main_path", "sessions": len(sessions),
          "frames": sum(len(s.frames) for s in sessions),
          "kept": sum(len(s.filtered) for s in sessions), "seconds": main_s,
          "launches": launches, "overflow_logs_equal_cpu": list(OVERFLOW),
          "full_session_rows": int(frames.shape[0]),
          "full_session_bytes": len(raw_full)})

    # -- 5. sweep_paths: per-sweep NN-OMP on the phase-4 sessions ----------------
    zero_counts()
    nnls.HOST_SYNCS = 0
    t0 = time.perf_counter()
    results = [s.sweep_paths(angles) for s in sessions]
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    counted_path("sweep_paths", read_counts())
    launches["K4"] = by_path["sweep_paths"]["K4"]
    if launches["K4"] == 0 or by_path["sweep_paths"]["K7"] == 0:
        fail("K4 or K7 never launched on the per-sweep path")
    if nnls.HOST_SYNCS:
        fail(f"sweep_paths: {nnls.HOST_SYNCS} NNLS host syncs on the card, not 0")

    n_sweeps_all = 0
    for (name, _), s, (got, got_valid) in zip(specs, sessions, results):
        ref, ref_valid = s.sweep_paths(angles, device="cpu")
        if not np.array_equal(got_valid, ref_valid) or not got_valid.any():
            fail(f"{name}: sweep_valid differs between cuda and cpu, or no sweep is valid")
        for field in ("n_iters", "aoa_idx", "aod_idx", "valid", "aoa", "aod"):
            if not np.array_equal(getattr(got, field), getattr(ref, field)):
                fail(f"{name}: sweep_paths {field} differs between cuda and cpu")
        if not np.allclose(got.power, ref.power, rtol=2e-4, atol=1e-6):
            fail(f"{name}: sweep_paths power beyond rtol 2e-4 between cuda and cpu")
        if not (np.isfinite(got.power).all() and got.valid.any()):
            fail(f"{name}: sweep_paths gave non-finite power or no valid path")
        mean, counts = s.sweep_intensity()
        mean_ref, counts_ref = s.sweep_intensity(device="cpu")
        if not (np.array_equal(counts, counts_ref)
                and np.array_equal(mean, mean_ref, equal_nan=True)):
            fail(f"{name}: sweep_intensity differs between cuda and cpu")
        n_sweeps_all += len(got_valid)
    full_dict = sessions[0]._sweep_host_prep(angles)[4]   # the memoized dictionary
    mp_paths = results[MP][0]
    emit({"phase": "sweep_paths", "sessions": len(sessions), "sweeps": n_sweeps_all,
          "full_session_sweeps": len(results[0][1]), "seconds": sweep_s,
          "launches": launches["K4"], "nnls_host_syncs": 0,
          "compared_with_cpu": len(sessions),
          "grid": [full_dict.aoa_grid.size, full_dict.aod_grid.size],
          **{f"{key}_valid_paths": int(results[i][0].valid.sum())
             for key, i in (("full_session", 0), ("multipath", MP))},
          "multipath_n_iters_mean": float(mp_paths.n_iters.mean()),
          "multipath_first_sweep": {"aoa": mp_paths.aoa[0].tolist(),
                                    "aod": mp_paths.aod[0].tolist(),
                                    "power": mp_paths.power[0].tolist()}})

    # -- 6. streaming ------------------------------------------------------------
    stream_out = streaming_phase(np, torch, sd, nnls, tmp, angles, raws[MP], raw_ds, raws[0],
                                 counted, dev)
    counted_path("streaming", stream_out["launches"], stream_out.pop("k7_by_k"))
    launches.update(K5=stream_out["launches"]["K5"], K6=stream_out["launches"]["K6"])
    emit({"phase": "streaming", **stream_out})

    # -- 7. cli: the user surface on the full session ------------------------------
    t0 = time.perf_counter()
    cli_out = cli_phase(np, torch, tmp, paths[0], angles, zero_counts, read_counts,
                        raster_close, lut, taps, dev)
    counted_path("cli", cli_out.pop("launches"))
    print(smi, flush=True)
    emit({"phase": "cli", "seconds": time.perf_counter() - t0, "launches": by_path["cli"],
          **cli_out})

    # -- 8. estimate: the session estimator on the full multipath session --------
    t0 = time.perf_counter()
    est_out = estimate_phase(np, torch, nnls, tmp, paths[MP], sessions, angles, zero_counts,
                             read_counts, dev, smi)
    counted_path("estimate", est_out.pop("launches"))
    print(smi, flush=True)
    emit({"phase": "estimate", "seconds": time.perf_counter() - t0,
          "launches": by_path["estimate"], **est_out})

    # -- 8b. est_forms: the session estimator's comparator forms ---------------------
    t0 = time.perf_counter()
    forms_out = est_forms_phase(np, torch, tmp, paths, angles, zero_counts, read_counts, dev,
                                smi)
    counted_path("est_forms", forms_out.pop("launches"))
    print(smi, flush=True)
    emit({"phase": "est_forms", "seconds": time.perf_counter() - t0,
          "launches": by_path["est_forms"], **forms_out})

    # -- 8c. k7_estimator: K7 on the session estimator's own refits ---------------
    # Recorded from the wrapper: run_estimator("nn_omp") on the full multipath
    # session (1 lane) and the "vmap" form over the 21 sessions (21 lanes),
    # K = 20 under "lu", one call an NN-OMP iteration; each held to K7's
    # contract (timed in phase 18).
    t0 = time.perf_counter()
    k7_est = estimator_k7_calls(sd, sessions, angles)
    n_cases = len(cases)
    for name, calls in k7_est.items():
        for it, args in enumerate(calls):
            check_k7(f"{name}_iter{it}", args)
    emit({"phase": "k7_estimator", "seconds": time.perf_counter() - t0,
          "cases": len(cases) - n_cases, "max_abs_err": err["K7"],
          "sets": {name: {"calls": len(calls), "lanes": calls[0][0].shape[0],
                          "k": calls[0][0].shape[1], "solver": calls[0][3],
                          "max_outer": calls[0][2]} for name, calls in k7_est.items()}})

    # -- 9. replay: the replay command's steps, card against cpu and host ------------
    t0 = time.perf_counter()
    rep_out = replay_phase(np, torch, tmp, paths[MP], paths[DS], angles, zero_counts,
                           read_counts)
    counted_path("replay", rep_out.pop("launches"))
    print(smi, flush=True)
    emit({"phase": "replay", "seconds": time.perf_counter() - t0, "launches": by_path["replay"],
          **rep_out})

    # -- 10. watch: a growing file, a checkpoint resume, card against cpu and host --
    t0 = time.perf_counter()
    watch_out = watch_phase(np, torch, sd, tmp, paths[MP], angles, zero_counts, read_counts, dev)
    counted_path("watch", watch_out.pop("launches"))
    print(smi, flush=True)
    emit({"phase": "watch", "seconds": time.perf_counter() - t0, "launches": by_path["watch"],
          **watch_out})

    # -- 11. run_config: three named configs, card against cpu ---------------------
    t0 = time.perf_counter()
    cfg_out = run_config_phase(np, tmp, paths[DS], angles, zero_counts, read_counts)
    counted_path("run_config", cfg_out.pop("launches"))
    emit({"phase": "run_config", "seconds": time.perf_counter() - t0,
          "launches": by_path["run_config"], **cfg_out})

    # -- 12. ingest: the text path and the host tokenizers ---------------------------
    t0 = time.perf_counter()
    ing_out = ingest_phase(np, torch, tmp, [raws[0]] + raws[DS], [paths[0]] + paths[DS],
                           zero_counts, read_counts, dev)
    counted_path("ingest", ing_out.pop("launches"))
    print(smi, flush=True)
    emit({"phase": "ingest", "seconds": time.perf_counter() - t0, "launches": by_path["ingest"],
          **ing_out})

    # -- 13. prelog: the pre-log scene on the session and the live feed ------------
    t0 = time.perf_counter()
    pre_out = prelog_phase(np, torch, sd, tmp, raw_full, sessions[0].filtered, raws[MP],
                           sessions[MP].filtered, zero_counts, read_counts, dev)
    counted_path("prelog", pre_out.pop("launches"))
    emit({"phase": "prelog", "seconds": time.perf_counter() - t0, "launches": by_path["prelog"],
          **pre_out})

    # -- 14. sm_sic: SM-SIC, the dataset's per-sweep paths, an SM-SIC stream ------
    t0 = time.perf_counter()
    sm_out = sm_sic_phase(np, torch, sd, sessions, results, angles, raws[MP], zero_counts,
                          read_counts, dev)
    counted_path("sm_sic", sm_out.pop("launches"))
    emit({"phase": "sm_sic", "seconds": time.perf_counter() - t0, "launches": by_path["sm_sic"],
          **sm_out})

    # -- 15. estimators: the registry's other seven families on the card ----------
    t0 = time.perf_counter()
    est7 = estimators_phase(np, torch, {"multipath": paths[MP], "noise": paths[0]}, angles,
                            zero_counts, read_counts, dev)
    counted_path("estimators", est7.pop("launches"))
    print(smi, flush=True)
    emit({"phase": "estimators", "seconds": time.perf_counter() - t0,
          "launches": by_path["estimators"], **est7})

    def cuda_ms(fn, inner=1, primed=True, runs=N_TIMED):
        """Median ms per call over ``runs`` event-timed runs of ``inner``
        calls.  ``primed``: a ~20 ms device sleep queued first lets the
        calls reach the card back to back, so device work is timed without
        host gaps; whole sessions are timed unprimed, host work included."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
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

    # -- 16. batch: run_dataset over the 21 sessions, both forms -----------------
    t0 = time.perf_counter()
    batch_out = batch_phase(np, torch, raws, zero_counts, read_counts, raster_close, cuda_ms, dev)
    counted_path("batch", batch_out.pop("launches"))
    print(smi, flush=True)
    emit({"phase": "batch", "seconds": time.perf_counter() - t0, "launches": by_path["batch"],
          **batch_out})

    # -- 17. multi_stream: 19 streams in one session, and watch --logs ------------
    t0 = time.perf_counter()
    multi_out = multi_stream_phase(np, torch, sd, nnls, tmp, angles, raws[DS], zero_counts,
                                   read_counts, dev)
    counted_path("multi_stream", multi_out.pop("launches"))
    print(smi, flush=True)
    emit({"phase": "multi_stream", "seconds": time.perf_counter() - t0,
          "launches": by_path["multi_stream"], **multi_out})


    # -- 18. timing --------------------------------------------------------------
    n_bytes, rows = padded.numel(), frames.shape[0]
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
               0, 0.0, 0, 0.0, *(t.data_ptr() for t in k3_out), _build.stream_of(tile))
    # The same launch with the heatmap's explicit bounds (--vmin / --vmax).
    k3_bounds_args = k3_args[:10] + (1, 60_000.0, 1, 140_000.0) + k3_args[14:]

    # K1 and K4 are timed through their wrappers (what callers pay: one
    # launch each), K1 also as the bare launch.  K4's library yardstick is
    # the pair of torch.bincount calls that give the same sums and counts
    # (timed only).
    k4_cells = n_sweeps * 4096
    k4_cell = torch.where(k4_p >= 0, k4_p.long() * 64 + k4_bs.long(), k4_cells)
    k4_weights = k4_val.double()
    bare_ms = {"K1": cuda_ms(k1_bare_launch(torch, _build, cuda_decode, padded, n_bytes),
                             inner=20)}
    ms = {"K1": cuda_ms(lambda: cuda_decode.decode_rows_cuda(padded, n_bytes, 0xCC, 0x33),
                        inner=20),
          "K2": cuda_ms(lambda: k2(*k2_args), inner=20),
          "K3": cuda_ms(lambda: k3(*k3_args), inner=20),
          "K3_vmin_vmax": cuda_ms(lambda: k3(*k3_bounds_args), inner=20),
          "K4": cuda_ms(lambda: cuda_sweep_sums.sweep_sums_cuda(k4_p, k4_bs, k4_val, n_sweeps),
                        inner=20)}
    plain_ms = {"K1": cuda_ms(lambda: decode.decode_rows_plain(padded)),
                "K2": cuda_ms(lambda: correct.baseline_plane_verdicts(gid, clk, packed,
                                                                      **verdict_args)),
                "K3": cuda_ms(lambda: raster.raster_tiles_plain(tile, lut, taps, True)),
                "K4": cuda_ms(lambda: scene.sweep_sums_plain(k4_p, k4_bs, k4_val, n_sweeps))}
    k6_args, k6_gate = k6["main_65_lanes"]
    ms["K5"] = cuda_ms(lambda: cuda_compact.compact_rows_cuda(k5["rows"], k5["open"], GCAP),
                       inner=20)
    ms["K6"] = cuda_ms(lambda: cuda_tracker.track_block_cuda(*k6_args, k6_gate), inner=20)
    plain_ms["K5"] = cuda_ms(lambda: compact.compact_rows_plain(k5["rows"], k5["open"], GCAP))
    plain_ms["K6"] = cuda_ms(lambda: tracker.track_block_plain(*k6_args, k6_gate))
    # K7 at the replay's 65 lanes (its last NN-OMP refit), and beside it the
    # live feed's 9 lanes, 65 lanes of K = 20 under both solvers and the
    # session estimator's own refits (phase 8c: all of a run's calls back to
    # back, and each call alone), each with its work and bound (k7_bound).
    ms["K7"] = cuda_ms(lambda: cuda_nnls.nnls_gram_cuda(*k7_main), inner=20)
    plain_ms["K7"] = cuda_ms(lambda: nnls.nnls_gram_plain(*k7_main))
    k7_ms = {}
    k7_sets = {case: [k7[case]] for case in ("live_9_lanes_iter2", "edges_K20_auto",
                                             "edges_K20_lu")}
    k7_sets.update(k7_est)
    for case, calls in k7_sets.items():
        one = len(calls) == 1
        k7_ms[case] = {
            "calls": len(calls), "lanes": calls[0][0].shape[0], "k": calls[0][0].shape[1],
            "solver": calls[0][3],
            "ms": cuda_ms(lambda: [cuda_nnls.nnls_gram_cuda(*c) for c in calls],
                          inner=20 if one else 1),
            "plain_ms": cuda_ms(lambda: [nnls.nnls_gram_plain(*c) for c in calls],
                                runs=N_TIMED if one else 3),
            **({} if one else {"ms_per_call": [
                cuda_ms(lambda c=c: cuda_nnls.nnls_gram_cuda(*c), inner=5, runs=5)
                for c in calls]}),
            **k7_bound(nnls, calls)}
    # The stream's kept-row compaction at the same window: the fused call
    # (emit ring + the paths' fresh buffer) against the two calls it replaced.
    k5_kept_ms = {
        "fused": cuda_ms(lambda: cuda_compact.compact_rows_multi_cuda(k5["kept"], k5["keep"],
                                                                      fused), inner=20),
        "two_calls": cuda_ms(lambda: (
            cuda_compact.compact_rows_cuda(k5["kept"], k5["keep"], k5["ecap"], out=ring,
                                           offset=k5["offset"]),
            cuda_compact.compact_rows_cuda(k5["kept"], k5["keep"], n_w)), inner=20)}
    library_ms = {"K4": cuda_ms(lambda: (
        torch.bincount(k4_cell, weights=k4_weights, minlength=k4_cells + 1),
        torch.bincount(k4_cell, minlength=k4_cells + 1)), inner=20),
        "K5": cuda_ms(lambda: k5["rows"][k5["open"]], inner=20)}
    # K1, K2 and K4 at the stream windows: the inputs of each stream's second
    # full window (after the first one's open group is carried).  K1
    # through its wrapper (what the stream pays) and as the bare launch; K4
    # where the stream estimates paths (the live feed's s_step 8: S = 9; the
    # replay's s_step 64: S = 65).
    stream_windows = {}
    for name, raw_w, chunk, s_step in (("live_64KiB", raws[MP], LIVE_CHUNK, 8),
                                       ("straddle_16KiB", raws[0], STRADDLE_CHUNK, None),
                                       ("replay_1MiB", raw_ds, REPLAY_CHUNK, 64)):
        spec = None if s_step is None else sd.make_paths_spec(angles, s_step=s_step)
        win = stream_window_inputs(sd, raw_w, chunk, dev, spec)
        (a1, k1w), (a2, k2w) = win["K1"], win["K2"]
        n_b, n_r = a1[0].numel(), a2[0].numel()
        rows_w = -(-n_b // 11)
        cand_w, steps_w = k2_work(torch, *a2, **k2w)
        k2_bytes_w, k2_ops_w = n_r * 17 + a2[2].numel() * 4, k2_ops(cand_w, steps_w, n_r)
        bare = k1_bare_launch(torch, _build, cuda_decode, a1[0], a1[1])
        stream_windows[name] = {
            "bytes": n_b, "rows": n_r, "k2_candidates": cand_w, "k2_search_steps": steps_w,
            "K1_ms": cuda_ms(lambda: cuda_decode.decode_rows_cuda(*a1, **k1w), inner=20),
            "K1_bare_ms": cuda_ms(bare, inner=20),
            "K2_ms": cuda_ms(lambda: cuda_correct.correct_verdicts_cuda(*a2, **k2w), inner=20),
            "K1_bound_ms_bytes": (n_b + rows_w * 21 + 4) / PEAK_BYTES_PER_S * 1e3,
            "K2_bound_ms": max(k2_bytes_w / PEAK_BYTES_PER_S, k2_ops_w / PEAK_INT32_PER_S) * 1e3}
        if "K4" in win:
            a4, k4w = win["K4"]
            kept4 = int(((a4[0] >= 0) & (a4[0] < a4[3] * 64)).sum())
            cells4 = a4[3] * 64 * 64
            stream_windows[name].update({
                "k4_rows": a4[0].numel(), "k4_kept": kept4, "k4_sweeps": a4[3],
                "K4_ms": cuda_ms(lambda: cuda_sweep_sums.sweep_sums_cuda(*a4, **k4w), inner=20),
                "K4_bound_ms_bytes": (a4[0].numel() * 4 + kept4 * 8 + cells4 * 8)
                / PEAK_BYTES_PER_S * 1e3})
    # The stream axis at the 19 streams' round: K1, K5 (the carry) and K6
    # through their wrappers, their plain versions, and K5's yardstick
    # rows[mask]; the flattened K2 and K4 calls against 19 separate calls.
    (k1s_b, k1s_lim, _, _), _ = multi["K1s"][0]
    (k5s_rows, k5s_mask, k5s_dests), _ = multi["K5s"][0]
    k6s_args, _ = multi["K6s"][0]
    ms["K1s"] = cuda_ms(lambda: cuda_decode.decode_rows_streams_cuda(*multi["K1s"][0][0]),
                        inner=20)
    ms["K5s"] = cuda_ms(lambda: cuda_compact.compact_rows_streams_cuda(*multi["K5s"][0][0]),
                        inner=20)
    ms["K6s"] = cuda_ms(lambda: cuda_tracker.track_block_streams_cuda(*k6s_args), inner=20)
    plain_ms["K1s"] = cuda_ms(lambda: decode.decode_rows_streams_plain(k1s_b, n_valid=k1s_lim))
    plain_ms["K5s"] = cuda_ms(lambda: compact.compact_rows_streams_plain(k5s_rows, k5s_mask,
                                                                         k5s_dests))
    plain_ms["K6s"] = cuda_ms(lambda: tracker.track_block_streams_plain(*k6s_args))
    library_ms["K5s"] = cuda_ms(lambda: k5s_rows[k5s_mask], inner=20)
    (k2f_gid, k2f_clk, k2f_packed), k2f_kw = multi["K2"][0]
    k2f_g, k2f_per = k2f_packed.shape[0] // 19, k2f_gid.numel() // 19
    k2f_sep = [((k2f_gid[i * k2f_per:(i + 1) * k2f_per] - i * k2f_g).contiguous(),
                k2f_clk[i * k2f_per:(i + 1) * k2f_per].contiguous(),
                k2f_packed[i * k2f_g:(i + 1) * k2f_g].contiguous()) for i in range(19)]
    (k4f_p, k4f_bs, k4f_val, k4f_s, k4f_nb), _ = multi["K4"][0]
    k4f_per, k4f_s1 = k4f_p.numel() // 19, k4f_s // 19
    k4f_sep = [(torch.where(k4f_p[i * k4f_per:(i + 1) * k4f_per] >= 0,
                            k4f_p[i * k4f_per:(i + 1) * k4f_per] - i * k4f_s1 * k4f_nb,
                            -1).contiguous(),
                k4f_bs[i * k4f_per:(i + 1) * k4f_per].contiguous(),
                k4f_val[i * k4f_per:(i + 1) * k4f_per].contiguous()) for i in range(19)]
    flattened_ms = {
        "K2_one_call_19_streams": cuda_ms(lambda: cuda_correct.correct_verdicts_cuda(
            *multi["K2"][0][0], **k2f_kw), inner=20),
        "K2_19_calls": cuda_ms(lambda: [cuda_correct.correct_verdicts_cuda(*a, **k2f_kw)
                                        for a in k2f_sep], inner=5),
        "K4_one_call_19_streams": cuda_ms(lambda: cuda_sweep_sums.sweep_sums_cuda(
            *multi["K4"][0][0]), inner=20),
        "K4_19_calls": cuda_ms(lambda: [cuda_sweep_sums.sweep_sums_cuda(*a, k4f_s1, k4f_nb)
                                        for a in k4f_sep], inner=5),
        "rows_per_stream": {"K2": k2f_per, "K4": k4f_per}, "sweep_lanes": k4f_s}
    # K1's stream axis at each of its recorded calls (``k1s_calls``), beside
    # its bytes bound: the bytes below each stream's limit read once, every
    # row, valid byte and count written once.
    k1s_ms = {}
    for name, (bb, ll) in k1s.items():
        s_k, n_k = bb.shape
        below = s_k * n_k if ll is None else ll.clamp(0, n_k).sum()
        k1s_bytes = int(below) + s_k * (-(-n_k // 11) * 21 + 4)
        k1s_ms[name] = {
            "streams_bytes": [s_k, n_k], "bytes_below_limits": int(below),
            "ms": cuda_ms(lambda: cuda_decode.decode_rows_streams_cuda(bb, ll, 0xCC, 0x33),
                          inner=20),
            "bound_ms_bytes": k1s_bytes / PEAK_BYTES_PER_S * 1e3}
    session_ms = cuda_ms(lambda: run_session_on_device(raw_full, device=dev), primed=False)
    # The decoder's discard count inside the session (plain torch on K1's
    # rows): its device time (primed) and what a caller pays (unprimed).
    def discards():
        return decode.discard_count(padded, frames, valid, n_valid=len(raw_full))

    discard_ms = {"device": cuda_ms(discards, inner=20),
                  "with_host": cuda_ms(discards, inner=20, primed=False),
                  "device_activities": device_profile(torch, discards)[1]}
    dataset_ms = cuda_ms(lambda: [run_session_on_device(r, device=dev) for r in raws[DS]],
                         primed=False)
    dataset_frames = sum(expected_frames(c) for c in DATASET)

    # sweep_paths: "cold" rebinds ``filtered`` first, which drops the
    # session's sweep memo, so the host prep (angle table, pivot,
    # dictionary), the host-to-device copies, K4 and the estimator all
    # run; "warm" reuses the memo: the estimator on device-resident inputs.
    def cold(s):
        s.filtered = s.filtered
        return s.sweep_paths(angles)

    sweeps_full = len(results[0][1])
    sweeps_mp = len(results[MP][1])
    sweeps_dataset = sum(len(r[1]) for r in results[DS])
    sweep_ms = {"full_cold": cuda_ms(lambda: cold(sessions[0]), primed=False),
                "full_warm": cuda_ms(lambda: sessions[0].sweep_paths(angles), primed=False),
                "multipath_cold": cuda_ms(lambda: cold(sessions[MP]), primed=False),
                "multipath_warm": cuda_ms(lambda: sessions[MP].sweep_paths(angles),
                                          primed=False),
                "dataset_cold": cuda_ms(lambda: [cold(s) for s in sessions[DS]], primed=False),
                "dataset_warm": cuda_ms(lambda: [s.sweep_paths(angles) for s in sessions[DS]],
                                        primed=False)}

    # Where the time goes: one profiled full-size session and one profiled
    # full-size sweep_paths (cold).
    busy, acts, top = device_profile(
        torch, lambda: run_session_on_device(raw_full, device=dev))
    emit({"phase": "profile", "device_busy_ms": busy,
          "busy_share_of_session": busy / session_ms, "device_activities": acts,
          "top_us": top})
    for key, i in (("full", 0), ("multipath", MP)):
        nnls.HOST_SYNCS = 0
        busy, acts, top = device_profile(torch, lambda: cold(sessions[i]))
        syncs = nnls.HOST_SYNCS
        busy_w, acts_w, top_w = device_profile(torch, lambda: sessions[i].sweep_paths(angles))
        emit({"phase": "profile_sweep_paths", "session": key, "device_busy_ms": busy,
              "busy_share_of_sweep_paths": busy / sweep_ms[f"{key}_cold"],
              "device_activities": acts, "nnls_host_syncs": syncs, "top_us": top,
              "warm": {"device_busy_ms": busy_w,
                       "busy_share": busy_w / sweep_ms[f"{key}_warm"],
                       "device_activities": acts_w, "top_us": top_w[:5]}})

    emit({"phase": "timing", "kernel_ms": ms, "kernel_bare_ms": bare_ms, "plain_ms": plain_ms,
          "library_ms": library_ms, "k7_ms": k7_ms,
          "k5_kept_rows_1MiB_window_ms": k5_kept_ms, "stream_windows": stream_windows,
          "flattened_ms": flattened_ms, "k1s_ms": k1s_ms,
          "discard_count_ms": discard_ms,
          "full_session": {"frames": n_full, "ms": session_ms,
                           "frames_per_s": n_full / (session_ms / 1e3)},
          "dataset": {"sessions": len(DATASET), "frames": dataset_frames, "ms": dataset_ms,
                      "frames_per_s": dataset_frames / (dataset_ms / 1e3)},
          **{f"sweep_paths_{key}": {
              "sweeps": n, "ms_cold": sweep_ms[f"{key}_cold"],
              "sweeps_per_s_cold": n / (sweep_ms[f"{key}_cold"] / 1e3),
              "ms_warm": sweep_ms[f"{key}_warm"],
              "sweeps_per_s_warm": n / (sweep_ms[f"{key}_warm"] / 1e3)}
             for key, n in (("full", sweeps_full), ("multipath", sweeps_mp))},
          "sweep_paths_dataset": {"sessions": len(DATASET), "sweeps": sweeps_dataset,
                                  "ms_cold": sweep_ms["dataset_cold"],
                                  "sweeps_per_s_cold": sweeps_dataset
                                  / (sweep_ms["dataset_cold"] / 1e3),
                                  "ms_warm": sweep_ms["dataset_warm"],
                                  "sweeps_per_s_warm": sweeps_dataset
                                  / (sweep_ms["dataset_warm"] / 1e3)}})

    # -- 19. mesh: the mesh forms on positions of cuda:0 ----------------------------
    t0 = time.perf_counter()
    mesh_out = mesh_phase(np, torch, sd, angles, raws, sessions, zero_counts, read_counts, dev)
    counted_path("mesh", mesh_out.pop("launches"))
    print(smi, flush=True)
    emit({"phase": "mesh", "seconds": time.perf_counter() - t0, "launches": by_path["mesh"],
          **mesh_out})

    # -- 20. multihost: two-process gloo clusters on cuda:0 --------------------------
    t0 = time.perf_counter()
    host_out = multihost_phase(np, torch, sd, tmp, angles, raws, sessions, dev)
    counted_path("multihost", host_out.pop("launches"))
    print(smi, flush=True)
    emit({"phase": "multihost", "seconds": time.perf_counter() - t0,
          "launches": by_path["multihost"], **host_out})

    # -- 21. graphs: the compiled programs as CUDA graphs, against eager ------------
    t0 = time.perf_counter()
    graph_out = graphs_phase(np, torch, sd, tmp, raws, paths, angles, zero_counts, read_counts,
                             dev, smi)
    counted_path("graphs", graph_out.pop("launches"))
    print(smi, flush=True)
    emit({"phase": "graphs", "seconds": time.perf_counter() - t0,
          "launches": by_path["graphs"], **graph_out})

    # Bounds: the larger of bytes moved (each input read once, each output
    # written once) over HBM bandwidth and the operations this run's data
    # needs over the peak rate.  K5: each mask byte read once, the 20 B
    # payload only of the masked rows, each of the GCAP carry slots (20 B)
    # written once; a mask test and a rank add per row.  K6: 13 B per (live
    # lane, path) read, 13 B per (lane, track) written, the carry both ways;
    # per live lane and round, 6 operations per (track, path) pair.  K1: a
    # flag test (3 ops) at every position, the ten tag-class tests (30 ops)
    # only where a flag byte sits, the assembly and row write (28 ops) only
    # at the frame starts.  K2: 17 B per row and the table; the operations
    # of the candidates and search steps that ``k2_work`` counts.  K4:
    # p (4 B) of every row read, bs and val (8 B) only of the kept rows, and
    # 8 B per cell of float32 written (its integer scratch is the kernel's
    # choice, not the function's); two atomics per kept row.
    flag_positions = int(((padded == 0xCC) | (padded == 0x33)).sum())
    n_starts = int(out_full.n_frames)
    k2_cand, k2_steps = k2_work(torch, gid, clk, packed, **verdict_args)
    k4_kept = int((k4_p >= 0).sum())
    k5_masked = int(k5["open"].sum())
    # The fused kept-row call: every mask byte, the 16 B payload of the kept
    # rows read once and written to the ring, and the fresh [F, 4] buffer.
    k5_fused_bytes = n_w + n_kept_w * 16 * 2 + n_w * 16
    # K7: G, b, x0 and P0 read once, x and P written once (13 B per lane
    # and atom besides G); the float32 operations of the outer steps and
    # solves that this call's lanes take (``k7_work``).
    k7_lanes, k7_k = k7_main[0].shape[:2]
    k7_outer, k7_solves = k7_work(nnls, k7_main)
    bounds = {
        "K1": (n_bytes + rows * 21 + 4, n_bytes * 3 + flag_positions * 30 + n_starts * 28,
               PEAK_INT32_PER_S),
        "K2": (rows * 8 + packed.numel() * 4 + rows * 9, k2_ops(k2_cand, k2_steps, rows),
               PEAK_INT32_PER_S),
        "K3": (64 * 64 * 4 + 256 * 16 + 49 * 4 + 64 * 64 * 24, 64 * 64 * (49 * 4 + 30),
               PEAK_F32_PER_S),
        "K4": (k4_p.numel() * 4 + k4_kept * 8 + k4_cells * 8, 2 * k4_kept, PEAK_INT32_PER_S),
        "K5": (k5["rows"].shape[0] + k5_masked * 20 + GCAP * 20,
               2 * k5["rows"].shape[0], PEAK_INT32_PER_S),
        "K6": (k6_bytes(k6_args), 6 * k6_live(k6_args) * k6_args[0].shape[1] ** 2
               * k6_args[5].shape[0], PEAK_F32_PER_S),
        "K7": (k7_lanes * k7_k * (4 * k7_k + 4 + 4 + 1 + 4 + 1),
               k7_ops(k7_k, k7_main[3], k7_outer, k7_solves)[0], PEAK_F32_PER_S),
    }
    # The stream axis at the 19 streams' round, counted as above per stream
    # and summed: K1 with each stream's limit, K5's carry, K6's live lanes.
    # K1 needs only the bytes below each stream's limit: none past it can
    # start or hold a counted frame.
    s_n, n_s = k1s_b.shape
    rows_s = -(-n_s // 11)
    k1s_in = (torch.arange(n_s, device=k1s_b.device)[None]
              < (n_s if k1s_lim is None else k1s_lim.clamp(max=n_s)[:, None]))
    k1s_read = int(k1s_in.sum())
    k1s_flags = int((((k1s_b == 0xCC) | (k1s_b == 0x33)) & k1s_in).sum())
    k1s_starts = int(decode.decode_rows_streams_plain(k1s_b, n_valid=k1s_lim)[2].sum())
    k5s_masked = int(k5s_mask.sum())
    k6s_per = [tuple(x[i] for x in k6s_args[:8]) for i in range(k6s_args[0].shape[0])]
    bounds["K1s"] = (k1s_read + s_n * (rows_s * 21 + 4),
                     k1s_read * 3 + k1s_flags * 30 + k1s_starts * 28, PEAK_INT32_PER_S)
    bounds["K5s"] = (k5s_mask.numel() + k5s_masked * 20 + s_n * GCAP * 20,
                     2 * k5s_mask.numel(), PEAK_INT32_PER_S)
    bounds["K6s"] = (sum(k6_bytes(a) for a in k6s_per),
                     sum(6 * k6_live(a) * a[0].shape[1] ** 2 * a[5].shape[0] for a in k6s_per),
                     PEAK_F32_PER_S)
    for key, base in (("K1s", "K1"), ("K5s", "K5"), ("K6s", "K6")):
        launches[key] = by_path["batch"][base] * (key == "K1s") + by_path["multi_stream"][base]
    launches["K7"] = by_path["streaming"]["K7"]
    meta = {
        "K1": ("decode_rows", "decode.cu", "slam_process_tpu/ops/pallas_decode.py:130"),
        "K2": ("correct_verdicts", "correct.cu", "slam_process_tpu/ops/pallas_correct.py:109"),
        "K3": ("raster_tiles", "raster.cu", "slam_process_tpu/ops/pallas_raster.py:136"),
        "K4": ("sweep_sums", "sweep_sums.cu", "slam_process_tpu/ops/pallas_sweep_sums.py:158"),
        "K5": ("compact_rows", "compact.cu", "slam_process_tpu/ops/pallas_compact.py:117"),
        "K6": ("track_block", "tracker.cu", "slam_process_tpu/ops/pallas_tracker.py:183"),
        "K7": ("nnls_gram", "nnls.cu", "slam_process_tpu/ops/nnls.py:168, :179 (two "
               "lax.while_loop; no pl.pallas_call)"),
        "K1s": ("decode_rows_streams (stream axis)", "decode.cu",
                "slam_process_tpu/ops/pallas_decode.py:130"),
        "K5s": ("compact_rows_streams (stream axis)", "compact.cu",
                "slam_process_tpu/ops/pallas_compact.py:117"),
        "K6s": ("track_block_streams (stream axis)", "tracker.cu",
                "slam_process_tpu/ops/pallas_tracker.py:183"),
    }
    rows_out = []
    meta_single = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")
    for key, (name, src, replaces) in meta.items():
        n_b, n_ops, peak = bounds[key]
        t_bytes, t_ops = n_b / PEAK_BYTES_PER_S * 1e3, n_ops / peak * 1e3
        rows_out.append({
            "name": f"{key} {name}", "route": "cuda",
            "source": f"slam_process_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[key],
            "launches_by_path": {path: n[key.rstrip("s")] for path, n in by_path.items()
                                 if key in meta_single
                                 or path in ("batch", "multi_stream", "mesh", "multihost")},
            "max_abs_err": err[key], "ms": ms[key],
            "ms_of": "kernel launch" if key in ("K2", "K3") else "wrapper call",
            "bare_ms": bare_ms.get(key),
            **({"ms_vmin_vmax": ms["K3_vmin_vmax"]} if key == "K3" else {}),
            "plain_ms": plain_ms[key], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms.get(key)})
    # K7's launches by K over the paths whose split adds up to their count
    # (paths[path] is null where it does not).
    k7_total = {}
    for split in k7_by_k.values():
        for k_n, n in (split or {}).items():
            k7_total[k_n] = k7_total.get(k_n, 0) + n
    rows_out[meta_single.index("K7")].update(
        launches_by_k={"all_paths": k7_total, "paths": k7_by_k})
    emit({"phase": "bounds", "k1_flag_positions": flag_positions, "k1_starts": n_starts,
          "k2_candidates": k2_cand, "k2_search_steps": k2_steps,
          "K1_bytes_ops": bounds["K1"][:2], "K2_bytes_ops": bounds["K2"][:2],
          "K3_bytes_ops": bounds["K3"][:2], "K4_rows": k4_p.numel(), "K4_sweeps": n_sweeps,
          "K4_kept": k4_kept, "K4_bytes_ops": bounds["K4"][:2],
          "K5_rows": k5["rows"].shape[0], "K5_masked": k5_masked,
          "K5_bytes_ops": bounds["K5"][:2], "K5_fused_kept_bytes": k5_fused_bytes,
          "K5_fused_kept_bound_ms": k5_fused_bytes / PEAK_BYTES_PER_S * 1e3,
          "K6_lanes_live": [k6_args[0].shape[0], k6_live(k6_args)],
          "K6_bytes_ops": bounds["K6"][:2], "K1s_streams_bytes": [s_n, n_s],
          "K1s_bytes_below_limits": k1s_read,
          "K1s_flag_positions": k1s_flags, "K1s_starts": k1s_starts,
          "K1s_bytes_ops": bounds["K1s"][:2], "K5s_rows": list(k5s_mask.shape),
          "K5s_masked": k5s_masked, "K5s_bytes_ops": bounds["K5s"][:2],
          "K6s_streams_lanes_live": [len(k6s_per), k6s_args[0].shape[1],
                                     sum(k6_live(a) for a in k6s_per)],
          "K6s_live_lanes_per_stream": [k6_live(a) for a in k6s_per],
          "K6s_us_per_live_lane_of_slowest_stream":
              ms["K6s"] * 1e3 / max(1, max(k6_live(a) for a in k6s_per)),
          "K6_us_per_live_lane": ms["K6"] * 1e3 / max(1, k6_live(k6_args)),
          "K6s_bytes_ops": bounds["K6s"][:2],
          "K7_lanes_atoms_outer_steps_solves": [k7_lanes, k7_k, k7_outer, k7_solves],
          "K7_bytes_ops": bounds["K7"][:2]})
    print(smi, flush=True)
    emit({"kernels": rows_out})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


CLI_OVERFLOW = dict(n_groups=257, frames_per_beam=1, baselines_per_group=1, junk_frac=0.02,
                    seed=202)
K3_BOUNDS = {"vmin_vmax": (40_000.0, 200_000.0), "vmax_only": (None, 120_000.0),
             "vmin_below_min": (-5.0, None), "vmax_below_min": (None, -5.0)}


def cli_phase(np, torch, tmp, log, angles, zero_counts, read_counts, raster_close, lut, taps,
              dev) -> dict:
    """The CLI's commands and the session / heatmap steps on the card, each
    output against the same call with ``--device cpu``; K3's explicit-bound
    cases against its plain version first (not counted)."""
    import zipfile

    from slam_process_tpu_torch.ops import cuda_correct, cuda_raster, raster
    from slam_process_tpu_torch.pipeline import cli
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import (
        legacy_stream_bytes, synthetic_session_bytes, to_hex_text, with_flag_junk,
        write_angle_table)

    # K3 with explicit vmin / vmax: S = 1 and 4, 64 x 64 and non-square.
    k3_cases = []
    for (s_n, shape) in ((1, (64, 64)), (4, (64, 64)), (1, (59, 61)), (4, (59, 61))):
        gen = torch.Generator().manual_seed(s_n * 31 + shape[1])
        mats = torch.rand((s_n, *shape), generator=gen) * (1 << 18)
        mats[torch.rand((s_n, *shape), generator=gen) < 0.05] = float("nan")
        mats = mats.to(dev)
        for name, (vmin, vmax) in K3_BOUNDS.items():
            for use_log in (True, False):
                k3_cases.append(f"bounds_{name}_S{s_n}_{shape[0]}x{shape[1]}_log={use_log}")
                raster_close("K3", k3_cases[-1],
                             cuda_raster.raster_tiles_cuda(mats, lut, taps, use_log, vmin, vmax),
                             raster.raster_tiles_plain(mats, lut, taps, use_log, vmin, vmax))

    work = {d: tmp / f"cli_{d}" for d in ("cuda", "cpu")}
    logs = {"full": log, "overflow_257_groups": tmp / "cli_overflow.txt",
            "flag_junk": tmp / "cli_flag_junk.txt",
            "v1": tmp / "cli_v1.txt", "v2": tmp / "cli_v2.txt"}
    logs["overflow_257_groups"].write_bytes(to_hex_text(synthetic_session_bytes(**CLI_OVERFLOW)))
    logs["flag_junk"].write_bytes(to_hex_text(with_flag_junk(synthetic_session_bytes(
        n_groups=6, frames_per_beam=4, baselines_per_group=20, junk_frac=0.1, seed=203),
        n_bursts=200, cut=5, seed=203)))
    for fmt in ("v1", "v2"):
        logs[fmt].write_bytes(to_hex_text(legacy_stream_bytes(fmt, n_frames=20_000, seed=204)))
    partial = write_angle_table(tmp / "cli_angles_partial.xlsx", unmapped=(0, 9, 33, 63))

    def call(argv):
        """stdout lines of ``cli.main(argv)``, which must exit 0."""
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                rc = cli.main(argv)
            except SystemExit as e:   # --run-tests reports through its exit code
                rc = e.code
        if rc != 0:
            fail(f"cli {' '.join(argv[:2])}: exit code {rc}: {buf.getvalue()[-500:]}")
        return buf.getvalue().splitlines()

    def heatmaps(device, parsed, filtered):
        """{case: RenderedHeatmap} of the heatmap command's variants, on the
        sessions read from the Parsed and filtered xlsx."""
        cases = {"v1": ["--variant", "v1"], "v2": ["--variant", "v2"], "v3": [],
                 "v3_linear": ["--no-logscale"],
                 "v3_vmin_vmax": ["--vmin", "60000", "--vmax", "140000"],
                 "v1_linear_vmin_vmax_partial": ["--variant", "v1", "--no-logscale", "--vmin",
                                                 "30000", "--vmax", "200000"]}
        out = {}
        for case, extra in cases.items():
            mapping = partial if case.endswith("partial") else angles
            args = cli.build_parser().parse_args(
                ["heatmap", "--input", "x.xlsx", "--mapping", str(mapping), *extra,
                 "--device", device])
            source = "filtered" if args.variant == "v3" else "parsed"
            s = filtered if source == "filtered" else parsed
            out[case] = s.render_heatmap(mapping, None, *cli.heatmap_configs(args),
                                         source=source, device=device)
        return out

    def drive(device, tag):
        out_dir = work[tag]
        out_dir.mkdir()
        dv = ["--device", device]
        ms, lines = {}, {}

        def timed(key, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            ms[key] = (time.perf_counter() - t0) * 1e3
            return result

        # The decode and correct commands through cli.main.
        lines["decode"] = timed("cli_decode_full", lambda: call(
            ["decode", str(logs["full"]), str(out_dir / "full_parsed.xlsx"), *dv]))
        lines["decode_flag_junk"] = call(
            ["decode", str(logs["flag_junk"]), str(out_dir / "flag_junk_parsed.xlsx"), *dv])
        for fmt in ("v1", "v2"):
            lines[f"decode_{fmt}"] = call(["decode", str(logs[fmt]),
                                           str(out_dir / f"{fmt}_parsed.xlsx"), "--format", fmt,
                                           *dv])
        lines["correct"] = timed("cli_correct_full", lambda: call(
            ["correct", "--input", str(out_dir / "full_parsed.xlsx"), "--output",
             str(out_dir / "full_filtered.xlsx"), *dv]))
        lines["correct_in_place"] = timed("cli_correct_in_place_full", lambda: call(
            ["correct", "--input", str(out_dir / "full_parsed.xlsx"), "--in-place", *dv]))
        k2 = cuda_correct.LAUNCHES
        lines["run_tests"] = call(["correct", "--run-tests", *dv])
        run_tests_k2 = cuda_correct.LAUNCHES - k2
        lines["decode_overflow"] = call(["decode", str(logs["overflow_257_groups"]),
                                         str(out_dir / "over_parsed.xlsx"), *dv])
        k2 = cuda_correct.LAUNCHES
        lines["correct_overflow"] = call(["correct", "--input", str(out_dir / "over_parsed.xlsx"),
                                          "--output", str(out_dir / "over_filtered.xlsx"), *dv])
        overflow_k2 = cuda_correct.LAUNCHES - k2

        # The session command's Session calls, one by one (host ms,
        # synchronized); then the xlsx and npz read back.
        s = timed("from_log", lambda: Session.from_log(logs["full"], device=device,
                                                       count_discards=True))
        timed("correct", lambda: s.correct(device=device))
        timed("xlsx_write_parsed", lambda: s.export_parsed(out_dir / f"{s.name}.xlsx"))
        timed("xlsx_write_filtered",
              lambda: s.export_filtered(out_dir / f"{s.name}_filtered.xlsx"))
        timed("render", lambda: s.render_heatmap(angles, None, device=device))
        timed("npz_save", lambda: s.save_npz(out_dir / f"{s.name}.npz"))
        parsed = timed("xlsx_read_parsed",
                       lambda: Session.from_parsed_xlsx(out_dir / f"{s.name}.xlsx"))
        timed("correct_from_xlsx", lambda: parsed.correct(device=device))
        filtered = timed("xlsx_read_filtered", lambda: Session.from_filtered_xlsx(
            out_dir / f"{s.name}_filtered.xlsx"))
        loaded = timed("npz_load", lambda: Session.load_npz(out_dir / f"{s.name}.npz"))
        if not all(np.array_equal(a, b) for a, b in (
                (loaded.frames, s.frames), (loaded.filtered, s.filtered),
                (parsed.frames, s.frames), (parsed.filtered, s.filtered),
                (parsed.corrected_bs, s.corrected_bs), (filtered.filtered, s.filtered))):
            fail(f"cli {device}: the xlsx or npz round trip changed the session")
        rendered = timed("heatmaps_6", lambda: heatmaps(device, parsed, filtered))
        return dict(ms=ms, lines=lines, rendered=rendered, run_tests_k2=run_tests_k2,
                    overflow_k2=overflow_k2, frames=len(s.frames), kept=len(s.filtered),
                    n_discarded=s.n_discarded, counters={c.name: c.counts for c in s.counters})

    zero_counts()
    got = drive("cuda", "cuda")
    launches = read_counts()
    for key in ("K1", "K2", "K3"):
        if launches[key] == 0:
            fail(f"cli: {key} never launched: {launches}")
    if got["run_tests_k2"] == 0:
        fail("cli correct --run-tests did not run K2 on the card")
    if got["overflow_k2"] != 2:
        fail(f"cli correct on 257 groups ran K2 {got['overflow_k2']} times, not 2")
    want = drive("cpu", "cpu")

    xlsx = sorted(str(p.relative_to(work["cuda"])) for p in work["cuda"].rglob("*.xlsx"))
    if xlsx != sorted(str(p.relative_to(work["cpu"])) for p in work["cpu"].rglob("*.xlsx")):
        fail("cli: cuda and cpu wrote different xlsx files")
    for rel in xlsx:
        with zipfile.ZipFile(work["cuda"] / rel) as a, zipfile.ZipFile(work["cpu"] / rel) as b:
            for member in ("xl/worksheets/sheet1.xml", "xl/workbook.xml"):
                if a.read(member) != b.read(member):
                    fail(f"cli: {rel} {member} differs between cuda and cpu")
    npz = sorted(str(p.relative_to(work["cuda"])) for p in work["cuda"].rglob("*.npz"))
    for rel in npz:
        with np.load(work["cuda"] / rel) as a, np.load(work["cpu"] / rel) as b:
            if sorted(a.files) != sorted(b.files) or any(
                    a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]) for k in a.files):
                fail(f"cli: {rel} differs between cuda and cpu")
    def printed(lines):
        """The command's own lines, its output paths cut (log records go to
        the logger's first stream)."""
        return [ln.replace(str(work["cuda"]), "").replace(str(work["cpu"]), "")
                for ln in lines if not ln.startswith(("INFO ", "WARNING ", "ERROR "))]

    for key in got["lines"]:
        if printed(got["lines"][key]) != printed(want["lines"][key]):
            fail(f"cli {key}: printed {got['lines'][key]} on cuda, {want['lines'][key]} on cpu")
    if got["counters"] != want["counters"]:
        fail(f"cli: session counters differ: {got['counters']} / {want['counters']}")
    rasters = {}
    for case, r in got["rendered"].items():
        w = want["rendered"][case]
        if not (np.array_equal(r.aod_angles, w.aod_angles)
                and np.array_equal(r.aoa_angles, w.aoa_angles)):
            fail(f"cli heatmap {case}: angle vectors differ between cuda and cpu")
        if not (np.array_equal(np.isnan(r.blurred), np.isnan(w.blurred))
                and np.array_equal(np.isnan(r.norm_t), np.isnan(w.norm_t))):
            fail(f"cli heatmap {case}: NaN patterns differ between cuda and cpu")
        if not np.allclose(r.blurred, w.blurred, rtol=1e-5, atol=0.0, equal_nan=True):
            fail(f"cli heatmap {case}: blurred beyond 1e-5 relative of the cpu's")
        fin = ~np.isnan(r.norm_t)
        if not fin.any():
            fail(f"cli heatmap {case}: no finite cell")
        d_t = float(np.abs(r.norm_t[fin] - w.norm_t[fin]).max())
        bins = [np.clip((np.nan_to_num(x.norm_t) * 256).astype(int), 0, 255) for x in (r, w)]
        flips = float((bins[0] != bins[1]).mean())
        same_bin = (bins[0] == bins[1])[..., None]
        if d_t > 1e-4 or flips >= 1e-3 or not np.array_equal(np.where(same_bin, r.rgba, 0),
                                                             np.where(same_bin, w.rgba, 0)):
            fail(f"cli heatmap {case}: norm_t differs by {d_t}, {flips:.4%} bin flips, or "
                 "the colors of equal bins differ")
        rasters[case] = {"shape": list(r.rgba.shape[:2]), "norm_t_max_abs_err": d_t,
                         "bin_flips": flips}
    if got["n_discarded"] != want["n_discarded"] or got["frames"] != 161_280:
        fail(f"cli: full session decoded {got['frames']} frames, discarded "
             f"{got['n_discarded']} (cpu {want['n_discarded']})")
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        print("cli: the heatmap PNG was not drawn: matplotlib is not installed on this "
              "machine (the CPU tests draw it)", flush=True)
    return {"launches": launches, "k3_bounds_cases": k3_cases,
            "host_ms_cuda": got["ms"], "host_ms_cpu": want["ms"],
            "frames": got["frames"], "kept": got["kept"], "discarded": got["n_discarded"],
            "xlsx_equal_cpu": xlsx, "npz_equal_cpu": npz, "rasters_close_cpu": rasters,
            "printed": {k: printed(v) for k, v in got["lines"].items() if k != "run_tests"},
            "session_counters": got["counters"],
            "run_tests": got["lines"]["run_tests"][-1], "run_tests_k2": got["run_tests_k2"],
            "overflow_xlsx_k2": got["overflow_k2"]}


EST_TIMED = 5                        # event-timed calls per median in the estimate phase
NEAR_TIE = 1e-5                      # tests/test_torch_nn_omp.py's near-tie margin
RTOL = 2e-4
# Two powers each within RTOL can move a ratio to the LoS by this much (dB).
MARGIN_DB = 2 * 10 * math.log10(1 + RTOL)
# Each flavor's classifier thresholds on 10 log10(p / p_LoS), in dB.
THRESHOLDS_DB = {"nn_omp": (-0.15, -0.01), "nn_omp_v1": (),
                 "nn_omp_v14": (10 * math.log10(0.5),), "nn_omp_v15": (-10.0,),
                 "nn_omp_v16": (-0.15, -0.01)}


def selection_margin(np, d, mat, n_iters, aoa_idx, aod_idx):
    """Smallest gap, over the float64 oracle's iterations, between the top
    two values of the residual correlation surface, relative to the
    largest |corr_y| (``tests/test_torch_nn_omp.selection_margin``)."""
    from scipy.optimize import nnls as scipy_nnls

    y = mat.ravel()
    scale = np.abs(d.phi_rx.T @ mat @ d.phi_tx).max()
    resid, selected, margin = y, [], np.inf
    for r, t in zip(aoa_idx[:n_iters], aod_idx[:n_iters]):
        corr = (d.phi_rx.T @ resid.reshape(mat.shape) @ d.phi_tx).ravel()
        top2 = np.partition(corr, -2)[-2:]
        margin = min(margin, (top2[1] - top2[0]) / scale)
        selected.append((r, t))
        A = np.column_stack([np.outer(d.phi_rx[:, a], d.phi_tx[:, b]).ravel()
                             for a, b in selected])
        resid = y - A @ scipy_nnls(A, y)[0]
    return float(margin)


def paths_agree(np, got, want, valid_only=False):
    """Why two OmpPaths differ (None when they agree): valid equal, the
    selections of every slot (of the valid ones with ``valid_only``) and
    n_iters equal, power within RTOL."""
    if not np.array_equal(got.valid, want.valid):
        return "valid"
    keep = want.valid if valid_only else slice(None)
    for field in ("aoa_idx", "aod_idx"):
        if not np.array_equal(np.asarray(getattr(got, field))[keep],
                              np.asarray(getattr(want, field))[keep]):
            return field
    if not valid_only and int(got.n_iters) != int(want.n_iters):
        return "n_iters"
    sel = want.valid if valid_only else slice(0, int(want.n_iters))
    if not np.allclose(np.asarray(got.power)[sel], np.asarray(want.power)[sel], rtol=RTOL,
                       atol=1e-6):
        return "power"
    return None


def near_threshold(np, power, valid, thresholds_db):
    """(the LoS near a tie, per path: its ratio to the LoS lies within
    MARGIN_DB of a classifier threshold)."""
    power = np.asarray(power, np.float64)
    valid = np.asarray(valid, bool)
    near = np.zeros(len(power), bool)
    if not valid.any():
        return False, near
    los = int(np.argmax(np.where(valid, power, -np.inf)))
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = 10 * np.log10(power / power[los])
    others = valid.copy()
    others[los] = False
    for th in thresholds_db:
        near |= valid & (np.abs(ratio - th) < MARGIN_DB)
    return bool((others & (np.abs(ratio) < MARGIN_DB)).any()), near


def xlsx_close(np, a, b, int_cols):
    """Why two xlsx tables differ (None when they agree): the same columns
    and rows, ``int_cols`` equal, the rest within RTOL."""
    from slam_process_tpu_torch.io.xlsx import read_xlsx_table

    (na, va), (nb, vb) = read_xlsx_table(a), read_xlsx_table(b)
    if na != nb or va.shape != vb.shape:
        return f"columns {na} / {nb} or shapes {va.shape} / {vb.shape}"
    for i, name in enumerate(na):
        same = (np.array_equal(va[:, i], vb[:, i]) if name in int_cols
                else np.allclose(va[:, i], vb[:, i], rtol=RTOL, atol=1e-12))
        if not same:
            return name
    return None


def estimate_phase(np, torch, nnls, tmp, log, sessions, angles, zero_counts, read_counts,
                   dev, smi) -> dict:
    """The session estimator on the card: the estimate command's steps on
    the full multipath log (counted), each against ``device="cpu"`` and the
    float64 host engine; ``estimate_sessions`` over the 21 sessions against
    their per-session card runs; the RBF background against numpy; the LU
    and Gauss-Jordan NNLS solves; times and host syncs."""
    from slam_process_tpu_torch.io.xlsx import write_xlsx_table
    from slam_process_tpu_torch.models import registry
    from slam_process_tpu_torch.models.batch_estimation import (
        estimate_sessions, flavor_config, pack_scenes, packed_to_device)
    from slam_process_tpu_torch.models.dictionary import make_dictionary
    from slam_process_tpu_torch.models.nn_omp import nn_omp_scenes, run_nn_omp
    from slam_process_tpu_torch.ops.interp import rbf_interpolate_grid
    from slam_process_tpu_torch.pipeline import cli
    from slam_process_tpu_torch.render.estimation import rbf_background

    def ms(fn, n=EST_TIMED):
        """Median ms of ``n`` calls after a warm-up, each between two CUDA
        events; every call blocks on its results, so its host work is
        inside the interval."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def syncs(fn):
        """``fn()`` on the card and its NNLS host syncs, which K7 makes 0."""
        nnls.HOST_SYNCS = 0
        out = fn()
        if nnls.HOST_SYNCS:
            fail(f"estimate: {nnls.HOST_SYNCS} NNLS host syncs in a call on the card, not 0")
        return out, nnls.HOST_SYNCS

    def call(argv):
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        if rc != 0:
            fail(f"cli {' '.join(argv[:2])}: exit code {rc}: {buf.getvalue()[-500:]}")
        return [ln.replace(str(tmp), "") for ln in buf.getvalue().splitlines()
                if not ln.startswith(("INFO ", "WARNING ", "ERROR "))]

    def steps(device):
        """The estimate command's steps on ``device``: decode + correct,
        each flavor's table, ``--per-sweep`` through cli.main, then
        ``--tracks --changes`` through the command's own helpers (its
        track PNG needs matplotlib)."""
        out = tmp / f"estimate_{device}"
        out.mkdir()
        argv = ["estimate", "--input", str(log), "--mapping", str(angles), "--device", device]
        s, overrides = cli.estimate_inputs(cli.build_parser().parse_args(argv))
        tables = {name: registry.run_estimator(name, s, angles, **overrides)
                  for name in registry.FLAVORS}
        lines = call(argv + ["--per-sweep", "--output", str(out / "sweep_paths.xlsx")])
        args = cli.build_parser().parse_args(argv + ["--tracks", "--changes", "--output",
                                                     str(out / "tracks.xlsx")])
        s_t, overrides = cli.estimate_inputs(args)
        tracks, times, vel = s_t.path_tracks(args.mapping, gate_deg=args.gate_deg, **overrides)
        table = cli.tracks_table(tracks, times, vel)
        written = write_xlsx_table(args.output, cli.TRACK_COLUMNS, table)
        lines.append(f"tracks={int(tracks.n_tracks)} fitted={int(vel[2][:tracks.n_tracks].sum())}"
                     f" rows={len(table)}")
        lines.append(cli.write_changes(written, tracks, times, args)[1].replace(str(tmp), ""))
        return s, tables, lines, out

    # The estimate command's path on the card, counted.
    zero_counts()
    t0 = time.perf_counter()
    s, tables, lines, out_cuda = steps("cuda")
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    launches = read_counts()
    for key in ("K1", "K2", "K3", "K4", "K6"):
        if launches[key] == 0:
            fail(f"estimate: {key} never launched: {launches}")
    _, tables_cpu, lines_cpu, out_cpu = steps("cpu")
    if [ln.replace("estimate_cuda", "") for ln in lines] != [
            ln.replace("estimate_cpu", "") for ln in lines_cpu]:
        fail(f"estimate: printed {lines} on cuda, {lines_cpu} on cpu")
    for name, ints in (("sweep_paths.xlsx", {"Sweep", "CLK", "Path"}),
                       ("tracks.xlsx", {"Track", "Sweep", "CLK"}),
                       ("tracks_changes.xlsx", {"Sweep", "CLK", "Kind", "Track"})):
        why = xlsx_close(np, out_cuda / name, out_cpu / name, ints)
        if why:
            fail(f"estimate: {name} differs between cuda and cpu in {why}")
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        print("estimate: the estimation and track PNGs were not drawn: matplotlib is not "
              "installed on this machine (the CPU tests draw them)", flush=True)

    # Each flavor: the card against device="cpu" and the float64 host
    # engine, lane for lane; a difference is excused only at a near tie.
    flavors, scenes = {}, {}
    for name in registry.FLAVORS:
        dict_cfg, cfg, log_t, keep_rule, stop_np = registry.nn_omp_settings(name)
        matrix, ue, bs = registry.build_scene(s, angles, log_t)
        d = make_dictionary(ue, bs, dict_cfg)
        scenes[name] = (matrix, ue, bs, d, cfg, keep_rule, stop_np)
        runs = {"cuda": run_nn_omp(d, matrix, cfg, keep_rule, stop_np, device=dev),
                "cpu": run_nn_omp(d, matrix, cfg, keep_rule, stop_np, device="cpu"),
                "host": run_nn_omp(d, matrix, cfg, keep_rule, stop_np, engine="host")}
        excused, margin = [], None
        for other in ("cpu", "host"):
            why = paths_agree(np, runs["cuda"], runs[other])
            if why:
                ref = runs["host"]
                margin = selection_margin(np, d, matrix, int(ref.n_iters), ref.aoa_idx,
                                          ref.aod_idx)
                if margin >= NEAR_TIE:
                    fail(f"estimate {name}: the card and {other} differ in {why} "
                         f"(selection margin {margin:.3g})")
                excused.append(other)
        labels = {k: registry.classify_paths(name, r) for k, r in runs.items()}
        if registry.paths_table(labels["cuda"]).to_string() != tables[name].to_string():
            fail(f"estimate {name}: run_estimator's table is not its paths' table")
        los_tie, near = near_threshold(np, runs["host"].power, runs["host"].valid,
                                       THRESHOLDS_DB[name])
        for other in ("cpu", "host"):
            if other in excused or los_tie:
                continue
            if not np.array_equal(labels["cuda"].label[~near], labels[other].label[~near]):
                fail(f"estimate {name}: labels differ between the card and {other}")
        if len(tables[name]) == 0 or not np.isfinite(tables[name]["Power"]).all():
            fail(f"estimate {name}: no path, or a non-finite power")
        # The command's own tables, card against cpu: the same rows, angles
        # exact, power within RTOL, labels outside the thresholds' margin.
        g, w = tables[name], tables_cpu[name]
        far = ~near[runs["cuda"].valid]
        if "cpu" not in excused and not (
                len(g) == len(w) and np.array_equal(g["AoA"], w["AoA"])
                and np.array_equal(g["AoD"], w["AoD"])
                and np.allclose(g["Power"], w["Power"], rtol=RTOL)
                and (los_tie or [t for t, f in zip(g["PathType"], far) if f]
                     == [t for t, f in zip(w["PathType"], far) if f])):
            fail(f"estimate {name}: run_estimator's table differs between cuda and cpu")
        flavors[name] = {
            "grid": [len(d.aoa_grid), len(d.aod_grid)], "scene": list(matrix.shape),
            "max_paths": cfg.max_paths, "n_iters": int(runs["cuda"].n_iters),
            "paths": len(tables[name]), "table_lines": len(tables[name].to_string().splitlines()),
            "labels": sorted(set(tables[name]["PathType"])),
            "near_threshold_paths": int(near.sum()), "los_near_tie": los_tie,
            "excused_near_tie": excused, "selection_margin": margin,
            "power_max_rel_err_cpu": float(np.max(np.abs(
                runs["cuda"].power / np.where(runs["cpu"].power == 0, 1, runs["cpu"].power) - 1)
                * runs["cuda"].valid))}

    # Times and host syncs of the flagship.
    matrix, ue, bs, d, cfg, keep_rule, stop_np = scenes["nn_omp"]
    _, flagship_syncs = syncs(lambda: registry.run_estimator("nn_omp", s, angles))
    timing = {"run_estimator_nn_omp_ms": ms(lambda: registry.run_estimator("nn_omp", s, angles)),
              "run_estimator_nn_omp_host_engine_ms": ms(lambda: registry.run_estimator(
                  "nn_omp", s, angles, engine="host"), n=3),
              "run_nn_omp_ms": ms(lambda: run_nn_omp(d, matrix, cfg, keep_rule, stop_np)),
              "run_estimator_nn_omp_v1_ms": ms(lambda: registry.run_estimator(
                  "nn_omp_v1", s, angles))}
    busy, acts, top = device_profile(torch, lambda: registry.run_estimator("nn_omp", s, angles))
    profile = {"device_busy_ms": busy, "device_activities": acts,
               "busy_share": busy / timing["run_estimator_nn_omp_ms"], "top_us": top[:6]}

    # LU against Gauss-Jordan at K = 20: one session, then the 21.
    one = [torch.from_numpy(np.asarray(x, np.float32)).to(dev)[None]
           for x in (d.phi_rx, d.phi_tx, d.aoa_grid, d.aod_grid, matrix)]
    dict_cfg17, cfg17, log17, keep17, stop17 = flavor_config("v1-7")
    mats, dicts = [], []
    for sess in sessions:
        m, u, b = registry.build_scene(sess, angles, log17)
        mats.append(m)
        dicts.append(make_dictionary(u, b, dict_cfg17))
    p = packed_to_device(pack_scenes(mats, dicts), dev)
    batch = [p.phi_rx, p.phi_tx, p.aoa_grid, p.aod_grid, p.matrices]
    solvers = {}
    for key, args in (("single", one), ("batched_21", batch)):
        outs = {sv: syncs(lambda: nn_omp_scenes(*args, cfg17, keep17, stop17, nnls_solver=sv))
                for sv in ("lu", "auto")}
        lu, gj = outs["lu"][0], outs["auto"][0]
        same = all(torch.equal(getattr(lu, f), getattr(gj, f))
                   for f in ("aoa_idx", "aod_idx", "n_iters", "valid"))
        solvers[key] = {
            "same_selections": same,
            "power_max_rel_diff": float(((lu.power - gj.power).abs()
                                         / gj.power.abs().clamp_min(1e-30)).max()),
            "lu_ms": ms(lambda: nn_omp_scenes(*args, cfg17, keep17, stop17, nnls_solver="lu")),
            "gauss_jordan_ms": ms(lambda: nn_omp_scenes(*args, cfg17, keep17, stop17,
                                                        nnls_solver="auto")),
            "lu_syncs": outs["lu"][1], "gauss_jordan_syncs": outs["auto"][1]}
        if not same:
            print(f"estimate: LU and Gauss-Jordan select differently ({key})", flush=True)

    # estimate_sessions over the 21 sessions against per-session card runs.
    batched = {}
    for flavor in ("v1-7", "v1"):
        got, n_syncs = syncs(lambda: estimate_sessions(sessions, angles, flavor))
        dict_cfg, cfg, log_t, keep_rule, stop_np = flavor_config(flavor)
        excused = 0
        for i, (sess, g) in enumerate(zip(sessions, got)):
            m, u, b = registry.build_scene(sess, angles, log_t)
            dd = make_dictionary(u, b, dict_cfg)
            want = run_nn_omp(dd, m, cfg, keep_rule, stop_np)
            why = paths_agree(np, g, want, valid_only=not stop_np)
            if why:
                ref = run_nn_omp(dd, m, cfg, keep_rule, stop_np, engine="host")
                if selection_margin(np, dd, m, int(ref.n_iters), ref.aoa_idx,
                                    ref.aod_idx) >= NEAR_TIE:
                    fail(f"estimate_sessions {flavor}: session {i} differs from its own "
                         f"card run in {why}")
                excused += 1
        call_ms = ms(lambda: estimate_sessions(sessions, angles, flavor), n=3)
        batched[flavor] = {"sessions": len(sessions), "ms": call_ms,
                           "sessions_per_s": len(sessions) / (call_ms / 1e3),
                           "host_syncs": n_syncs, "excused_near_tie": excused,
                           "valid_paths": int(sum(int(g.valid.sum()) for g in got))}

    # The figure's background: the full scene's 4,096-centre solve.
    gx, gy, heat = rbf_background(matrix, ue, bs, smooth=0.1)
    t0 = time.perf_counter()
    want = rbf_interpolate_grid(bs, ue, matrix, gx, gy, smooth=0.1)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    rbf_err = float(np.abs(heat - want).max() / np.ptp(want))
    if not (np.isfinite(heat).all() and rbf_err <= 1e-6):
        fail(f"estimate: the card's RBF background is {rbf_err:.3g} of the range from numpy's")
    rbf = {"centres": int(matrix.size), "queries": int(heat.size),
           "max_err_share_of_range": rbf_err,
           "card_ms": ms(lambda: rbf_background(matrix, ue, bs, smooth=0.1)),
           "numpy_ms": numpy_ms}
    return {"card": smi, "seconds_card_steps": steps_s, "launches": launches,
            "printed": lines, "flavors": flavors, "flagship_host_syncs": flagship_syncs,
            "timing_ms": timing, "profile_run_estimator": profile, "nnls_solvers": solvers,
            "estimate_sessions": batched, "rbf": rbf}


EST_FORM_ORACLE = (0, 1, MP)         # sessions of the est_forms phase held against nn_omp_np
EST_FORM_DEVICE_RUNS = 3             # measure_device_time runs per form


def est_forms_phase(np, torch, tmp, logs, angles, zero_counts, read_counts, dev,
                    smi) -> dict:
    """The session estimator's comparator forms on the card: the 21
    sessions (v1-7, 0.1 deg grids) packed once on the card through
    ``_batched_nn_omp`` "vmap" and "gram" and ``nn_omp_sessions_device``,
    each against "vmap" (and a few sessions against ``nn_omp_np``); the
    multipath session's sweeps (the per-sweep config) through
    ``nn_omp_batch`` against ``nn_omp_gram_batch``; ``detect_scene_changes``
    on its K6 tracks against ``detect_scene_changes_np``.  A difference is
    excused only at a near tie of the float64 oracle.  Per form: wall ms
    (CUDA events around the call with its host work, median of 5 after a
    warm-up), device ms (``measure_device_time``, median of 3; one run of
    the per-session form) with its activities and top activity names, and
    beside it one ``device_profile`` run (busy ms, activities)."""
    from slam_process_tpu_torch.models import registry
    from slam_process_tpu_torch.models.batch_estimation import (
        _batched_nn_omp, flavor_config, nn_omp_sessions_device, pack_scenes, packed_to_device)
    from slam_process_tpu_torch.models.change_detection import (
        detect_scene_changes, detect_scene_changes_np)
    from slam_process_tpu_torch.models.dictionary import make_dictionary
    from slam_process_tpu_torch.models.nn_omp import (
        OmpPaths, nn_omp_batch, nn_omp_gram_batch, nn_omp_np)
    from slam_process_tpu_torch.models.sweep_estimation import _fill_per_sweep, path_power
    from slam_process_tpu_torch.models.tracking import Tracks, track_paths
    from slam_process_tpu_torch.ops import nnls
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.device_timing import (
        measure_device_time, op_device_counts, op_device_times)

    def timed(name, fn, runs=EST_FORM_DEVICE_RUNS, profile=True):
        """Wall ms; device ms per call from measure_device_time, with the
        device activities per call and the top activity names by device us
        per call from its kept trace; with ``profile`` one device_profile run
        beside it (busy ms, activities: the two measures side by side); and
        the host seconds of each step.  Its NNLS host syncs must be 0 (K7)."""
        nnls.HOST_SYNCS = 0
        t0 = time.perf_counter()
        out = {"wall_ms": event_ms(torch, fn, EST_TIMED)}
        if nnls.HOST_SYNCS:
            fail(f"est_forms {name}: {nnls.HOST_SYNCS} NNLS host syncs on the card, not 0")
        t1 = time.perf_counter()
        trace_dir = tmp / f"est_forms_{name}"
        t = measure_device_time(lambda i: fn(), n=runs, device=dev, trace_dir=trace_dir)
        per_call = {k: sum(v) / len(v) * 1e6 for k, v in t.all_modules.items()}
        counts = op_device_counts(trace_dir)
        op_s = op_device_times(trace_dir)
        k7_s = sum(v for name, v in op_s.items() if "nnls" in name)
        shutil.rmtree(trace_dir)
        t2 = time.perf_counter()
        out.update(device_ms=t.median * 1e3, device_ms_runs=[r * 1e3 for r in t.runs],
                   k7_device_ms=k7_s / runs * 1e3, k7_share_of_device=k7_s / sum(op_s.values()),
                   k7_kernels=sum(n for name, n in counts.items() if "nnls" in name) / runs,
                   device_activities=sum(counts.values()) / runs,
                   activity_names=len(per_call),
                   top_us=sorted(((k[:60], v) for k, v in per_call.items()),
                                 key=lambda kv: -kv[1])[:6])
        seconds = {"wall": t1 - t0, "measure_device_time": t2 - t1}
        if profile:
            busy, acts, _ = device_profile(torch, fn, cpu=False)
            out.update(device_profile_busy_ms=busy, device_profile_activities=acts)
            seconds["device_profile"] = time.perf_counter() - t2
        out["busy_share"] = out["device_ms"] / out["wall_ms"]
        out["seconds"] = seconds
        return out

    def host(out):
        if isinstance(out, list):
            out = OmpPaths(*(torch.stack(fs) for fs in zip(*out)))
        return OmpPaths(*(x.cpu().numpy() for x in out))

    def lane(paths, i):
        return OmpPaths(*(x[i] for x in paths))

    def compare(got, want, oracle, what):
        """Lanes of ``got`` against ``want``; a differing lane must be a
        near tie of the float64 oracle ``oracle(i)`` = (d, mat, ref)."""
        excused = []
        for i in range(want.power.shape[0]):
            why = paths_agree(np, lane(got, i), lane(want, i))
            if why:
                d, mat, ref = oracle(i)
                margin = selection_margin(np, d, mat, int(ref.n_iters), ref.aoa_idx,
                                          ref.aod_idx)
                if margin >= NEAR_TIE:
                    fail(f"est_forms {what}: lane {i} differs in {why} "
                         f"(selection margin {margin:.3g})")
                excused.append(i)
        return excused

    zero_counts()
    t_start = time.perf_counter()
    sessions = [Session.from_log(p) for p in logs]
    dict_cfg, cfg, log_t, keep, stop = flavor_config("v1-7")
    mats, dicts = [], []
    for sess in sessions:
        m, u, b = registry.build_scene(sess, angles, log_t)
        mats.append(m)
        dicts.append(make_dictionary(u, b, dict_cfg))
    packed = pack_scenes(mats, dicts)
    p = packed_to_device(packed, dev)
    forms = {"vmap": lambda: _batched_nn_omp(p, cfg, keep, stop),
             "gram": lambda: _batched_nn_omp(p, cfg, keep, stop, form="gram"),
             "sessions_device": lambda: nn_omp_sessions_device(p, cfg, keep, stop)}
    outs = {name: host(fn()) for name, fn in forms.items()}

    oracles = {}

    def session_oracle(i):
        if i not in oracles:
            oracles[i] = (dicts[i], mats[i], nn_omp_np(dicts[i], mats[i], cfg, keep, stop))
        return oracles[i]

    vmap = outs["vmap"]
    if vmap.power.shape != (len(sessions), cfg.max_paths) or not (
            np.isfinite(vmap.power).all() and vmap.valid.any(axis=1).all()):
        fail("est_forms: vmap gave non-finite power or a session with no valid path")
    excused = {name: compare(outs[name], vmap, session_oracle, f"{name} vs vmap")
               for name in ("gram", "sessions_device")}
    excused["vmap_vs_nn_omp_np"] = [i for i in EST_FORM_ORACLE if paths_agree(
        np, lane(vmap, i), session_oracle(i)[2])]
    for i in excused["vmap_vs_nn_omp_np"]:
        d, mat, ref = session_oracle(i)
        if selection_margin(np, d, mat, int(ref.n_iters), ref.aoa_idx, ref.aod_idx) >= NEAR_TIE:
            fail(f"est_forms: session {i} on the card differs from nn_omp_np")

    # The multipath session's sweeps: the chain form against the Gram form.
    mp = sessions[MP]
    sub, d_sw, est_key, n_sw = mp._sweep_estimation_inputs(angles, "nn_omp", None, dev)
    d_host = mp._sweep_host_prep(angles)[4]
    _, cfg_sw, keep_sw, stop_sw = est_key
    filled, _ = _fill_per_sweep(sub)
    sweep_args = (d_sw.phi_rx, d_sw.phi_tx, d_sw.aoa_grid, d_sw.aod_grid, filled, cfg_sw,
                  keep_sw, stop_sw)
    sweep_forms = {"nn_omp_batch": lambda: nn_omp_batch(*sweep_args),
                   "nn_omp_gram_batch": lambda: nn_omp_gram_batch(*sweep_args)}
    sweep_out = {name: host(fn()) for name, fn in sweep_forms.items()}
    filled_h = filled.double().cpu().numpy()

    def sweep_oracle(i):
        return d_host, filled_h[i], nn_omp_np(d_host, filled_h[i], cfg_sw, keep_sw, stop_sw)

    excused["sweeps_batch_vs_gram"] = compare(sweep_out["nn_omp_batch"],
                                              sweep_out["nn_omp_gram_batch"], sweep_oracle,
                                              "nn_omp_batch vs nn_omp_gram_batch")

    # Scene changes on the card's K6 tracks, bit-equal to the numpy oracle.
    paths, sweep_valid = mp.sweep_paths(angles)
    times = mp.sweep_times(len(sweep_valid), dev)
    valid = np.asarray(paths.valid, bool) & sweep_valid[:, None] & (times >= 0)[:, None]
    tracks = track_paths(*(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                           for x in (paths.aoa, paths.aod, path_power(paths), valid)))
    tracks_h = Tracks(*(x.cpu().numpy() for x in tracks[:5]), int(tracks.n_tracks))
    changes = {}
    for key, kw in (("defaults", {}), ("persist1_gone1_jump0.5",
                                       dict(min_persist=1, min_gone=1, jump_deg=0.5))):
        got = detect_scene_changes(tracks, **kw)
        want = detect_scene_changes_np(tracks_h, **kw)
        for g, w, field in zip(got, want, want._fields):
            if g.device.type != "cuda" or g.cpu().numpy().dtype != w.dtype or not np.array_equal(
                    g.cpu().numpy(), w):
                fail(f"est_forms: detect_scene_changes {field} ({key}) differs from numpy")
        changes[key] = {f: int(np.asarray(w).sum()) for f, w in zip(want._fields, want)
                        if f != "los_track"}
    torch.cuda.synchronize()
    launches = read_counts()
    for key in ("K1", "K2", "K4", "K6"):
        if launches[key] == 0:
            fail(f"est_forms: {key} never launched: {launches}")

    checks_s = time.perf_counter() - t_start
    # One run of the per-session form holds ~10^5 device activities (its
    # trace: a few hundred MB): one run is measured, with no device_profile.
    timing = {name: timed(name, fn, **(dict(runs=1, profile=False)
                                       if name == "sessions_device" else {}))
              for name, fn in forms.items()}
    sweep_timing = {name: timed(name, fn) for name, fn in sweep_forms.items()}
    # The flagship estimator on the multipath session: K7's share of its
    # device time (its K = 20 refits, one lane).
    timing["run_estimator_nn_omp"] = timed(
        "run_estimator_nn_omp", lambda: registry.run_estimator("nn_omp", sessions[MP], angles))
    changes_ms = event_ms(torch, lambda: detect_scene_changes(tracks), EST_TIMED)
    return {"card": smi, "launches": launches, "sessions": len(sessions),
            "packed": list(p.phi_rx.shape[:1]) + [p.matrices.shape[1], p.matrices.shape[2],
                                                  p.phi_rx.shape[2], p.phi_tx.shape[2]],
            "max_paths": cfg.max_paths, "n_iters": vmap.n_iters.tolist(),
            "valid_paths": int(vmap.valid.sum()), "excused_near_tie": excused,
            "oracle_sessions": list(EST_FORM_ORACLE), "checks_seconds": checks_s,
            "forms": timing,
            "sweeps": {"session": "full_multipath", "sweeps": n_sw,
                       "grid": [d_sw.phi_rx.shape[1], d_sw.phi_tx.shape[1]],
                       "max_paths": cfg_sw.max_paths,
                       "valid_paths": int(sweep_out["nn_omp_batch"].valid.sum()),
                       "forms": sweep_timing},
            "scene_changes": {"tracks": int(tracks.n_tracks), "sweeps": len(sweep_valid),
                              "events": changes, "wall_ms": changes_ms}}


STREAM_TIMED = 10                    # synchronized calls per median in the stream phases
XLSX_MEMBERS = ("xl/worksheets/sheet1.xml", "xl/workbook.xml")


def xlsx_same(a, b) -> bool:
    """Two xlsx files with byte-equal sheet and workbook XML."""
    import zipfile

    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        return all(za.read(m) == zb.read(m) for m in XLSX_MEMBERS)


def rendered_differ(np, r, w):
    """Why two ``RenderedHeatmap`` of one grid differ (None when they agree
    within the ``cli`` phase's tolerances: blurred within 1e-5 relative,
    norm_t within 1e-4, < 0.1 % LUT-bin flips, the same NaNs and angles),
    and the norm_t error and flip share."""
    if not (np.array_equal(r.aod_angles, w.aod_angles)
            and np.array_equal(r.aoa_angles, w.aoa_angles)):
        return "angle vectors", None, None
    if not (np.array_equal(np.isnan(r.blurred), np.isnan(w.blurred))
            and np.array_equal(np.isnan(r.norm_t), np.isnan(w.norm_t))):
        return "NaN patterns", None, None
    if not np.allclose(r.blurred, w.blurred, rtol=1e-5, atol=0.0, equal_nan=True):
        return "blurred", None, None
    fin = ~np.isnan(r.norm_t)
    if not fin.any():
        return "no finite cell", None, None
    d_t = float(np.abs(r.norm_t[fin] - w.norm_t[fin]).max())
    bins = [np.clip((np.nan_to_num(x.norm_t) * 256).astype(int), 0, 255) for x in (r, w)]
    flips = float((bins[0] != bins[1]).mean())
    if d_t > 1e-4 or flips >= 1e-3:
        return f"norm_t by {d_t} with {flips:.4%} bin flips", d_t, flips
    return None, d_t, flips


def table_differ(np, a, b, n_int):
    """Why two tables differ (None when they agree): the same shape, the
    first ``n_int`` columns equal, the rest within RTOL."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return f"shapes {a.shape} / {b.shape}"
    if not np.array_equal(a[:, :n_int], b[:, :n_int]):
        return "integer columns"
    if not np.allclose(a[:, n_int:], b[:, n_int:], rtol=RTOL, atol=1e-12):
        return "float columns"
    return None


def replay_phase(np, torch, tmp, mp_log, ds_logs, angles, zero_counts, read_counts) -> dict:
    """``replay --paths --changes``'s steps on the card (counted): the full
    multipath log at 64 KiB and the 19 dataset-scale logs at 1 MiB; each log
    against the same steps with ``--device cpu`` and with ``--engine host``
    (the stream, ``render()`` and the tables the exports write; the card's
    run writes the command's files)."""
    from slam_process_tpu_torch.io.angles import load_angle_lut
    from slam_process_tpu_torch.ops import cuda_decode
    from slam_process_tpu_torch.pipeline import cli

    lut = load_angle_lut(angles)
    runs = {"multipath_64KiB": ([mp_log], LIVE_CHUNK),
            "dataset_1MiB": (list(ds_logs), REPLAY_CHUNK)}

    def steps(tag, extra, export):
        """{run: [(name, stats, rendered, seconds, windows, tables, session)]}."""
        out = {}
        for run_name, (logs, chunk) in runs.items():
            outdir = tmp / f"replay_{tag}" / run_name
            args = cli.build_parser().parse_args(
                ["replay", "--logs", *map(str, logs), "--mapping", str(angles), "--outdir",
                 str(outdir), "--chunk-bytes", str(chunk), "--paths", "--changes", *extra])
            outdir.mkdir(parents=True)
            per_log = []
            for log in logs:
                k1 = cuda_decode.LAUNCHES
                name, s, seconds = cli.replay_stream(args, log)
                windows = cuda_decode.LAUNCHES - k1
                rendered = s.render(lut)
                stats = (cli.replay_exports(args, s, name, seconds) if export
                         else cli.replay_stats(s, name, seconds))
                tracks, times, vel = s.path_tracks()
                tables = {"filtered": s.filtered,
                          "stream_tracks": cli.tracks_table(tracks, times, vel),
                          "stream_changes": cli.change_events(tracks, times, args)}
                per_log.append((name, stats, rendered, seconds, windows, tables, s))
            out[run_name] = per_log
        return out

    zero_counts()
    got = steps("cuda", [], export=True)
    torch.cuda.synchronize()
    launches = read_counts()
    if min(launches.values()) == 0:
        fail(f"replay: a kernel never launched: {launches}")
    others = {"cpu": steps("cpu", ["--device", "cpu"], export=False),
              "host": steps("host", ["--engine", "host"], export=False)}

    report, rasters = {}, {}
    for run_name in runs:
        per_log = got[run_name]
        frames = sum(x[1]["frames"] for x in per_log)
        entry = {"logs": len(per_log), "frames": frames,
                 "kept": sum(x[1]["kept"] for x in per_log),
                 "groups": sum(x[1]["sweeps"] for x in per_log),
                 "windows_per_log": [x[4] for x in per_log],
                 "seconds": {"cuda": sum(x[3] for x in per_log)}}
        for tag, other in others.items():
            o_logs = other[run_name]
            entry["seconds"][tag] = sum(x[3] for x in o_logs)
            for (name, stats, rendered, _, _, tables, _), (_, o_stats, o_rendered, _, _,
                                                           o_tables, _) in zip(per_log, o_logs):
                a, b = dict(stats), dict(o_stats)
                a.pop("frames_per_sec")
                b.pop("frames_per_sec")
                if a != b:
                    fail(f"replay {run_name} {name}: stats {a} on the card, {b} with {tag}")
                if not np.array_equal(tables["filtered"], o_tables["filtered"]):
                    fail(f"replay {run_name} {name}: the filtered rows differ from {tag}")
                for table, n_int in (("stream_tracks", 3), ("stream_changes", 4)):
                    why = table_differ(np, tables[table], o_tables[table], n_int)
                    if why or not len(tables[table]):
                        fail(f"replay {run_name} {name}: {table} differs from {tag} in {why}")
                why, d_t, flips = rendered_differ(np, rendered, o_rendered)
                if why:
                    fail(f"replay {run_name} {name}: render() differs from {tag}: {why}")
                rasters[f"{run_name}/{name}/{tag}"] = (d_t, flips)
        entry["frames_per_s"] = {tag: frames / sec for tag, sec in entry["seconds"].items()}
        report[run_name] = entry
    worst = {tag: {"norm_t_max_abs_err": max(v[0] for k, v in rasters.items()
                                             if k.endswith(tag)),
                   "bin_flips_max": max(v[1] for k, v in rasters.items() if k.endswith(tag))}
             for tag in others}

    # render(): host ms (synchronized) and the device's busy share, on the
    # multipath session's stream; five calls profiled together.
    s = got["multipath_64KiB"][0][6]
    s.render(lut)
    times = []
    for _ in range(STREAM_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.render(lut)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    render_ms = statistics.median(times)
    busy, acts, top = device_profile(torch, lambda: [s.render(lut) for _ in range(5)])
    # The profiler's own per-op table as a second reading of the device time.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            s.render(lut)
        torch.cuda.synchronize()
    table_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
    return {"launches": launches, "runs": report, "rasters_vs": worst,
            "render_ms": render_ms, "render_ms_runs": times,
            "render_device_busy_ms": busy / 5, "render_busy_share": busy / 5 / render_ms,
            "render_device_activities": acts / 5, "render_top_us": top[:4],
            "render_self_device_ms_key_averages": table_us / 5 / 1e3,
            "render_profiler_events": len(prof.events())}


def watch_phase(np, torch, sd, tmp, log, angles, zero_counts, read_counts, dev) -> dict:
    """``watch --paths --changes --events --checkpoint --checkpoint-every``
    on the card over a file that a writer thread grows with the full
    multipath log's text in seeded random pieces; a second card watch
    resumed from a copy of a mid-stream checkpoint and of the events file at
    that moment, on the finished file; the same file watched with ``--device
    cpu`` and with ``--engine host``."""
    import json
    import shutil
    import threading

    from slam_process_tpu_torch.io.angles import load_angle_lut
    from slam_process_tpu_torch.pipeline import cli

    lut = load_angle_lut(angles)
    text = log.read_bytes()
    work = tmp / "watch"

    def open_watch(tag, path, *extra):
        args = cli.build_parser().parse_args(
            ["watch", "--log", str(path), "--mapping", str(angles), "--outdir",
             str(work / tag), "--paths", "--changes", "--events", str(work / f"{tag}.jsonl"),
             "--poll-interval", "0.02", "--idle-timeout", "0.5", *extra])
        cli.check_watch_flags(args)
        return cli.Watch(args)

    def finish(w):
        """run(), then render() (K3) and the exports: the command without
        its PNG."""
        w.run()
        rendered = w.session.render(lut)
        return rendered, w.export()

    # The live run: a paced writer (each piece waits until the watch has
    # read the one before), the polls and the checkpoint saves timed, a copy
    # of the checkpoint and the events at every save mid-stream.
    (work / "live").mkdir(parents=True)
    capture = work / "live" / "capture.txt"
    capture.write_bytes(b"")
    zero_counts()
    w = open_watch("live", capture, "--checkpoint", str(work / "live.ckpt"),
                   "--checkpoint-every", "0.2")
    consumed = threading.Event()
    poll_ms, save_ms, snaps = [], [], []
    read_growth, poll, save = w._read_growth, w.poll, w.save_checkpoint

    def paced_read():
        data = read_growth()
        if data is not None:
            consumed.set()
        return data

    def timed_poll():
        t0 = time.perf_counter()
        grew = poll()
        torch.cuda.synchronize()
        if grew:
            poll_ms.append((time.perf_counter() - t0) * 1e3)
        return grew

    def copying_save():
        t0 = time.perf_counter()
        save()
        save_ms.append((time.perf_counter() - t0) * 1e3)
        if not w.session._finalized and 0 < w.pos < len(text):
            snap = work / f"snap_{len(snaps)}"
            snap.mkdir()
            shutil.copy(work / "live.ckpt", snap / "ckpt.npz")
            events = work / "live.jsonl"         # written once the first sweep closes
            (snap / "events.jsonl").write_bytes(events.read_bytes() if events.exists() else b"")
            snaps.append((snap, w.pos))

    def grow():
        rng = np.random.default_rng(300)
        with open(capture, "ab") as f:
            off = 0
            while off < len(text):
                n = int(rng.integers(1, len(text) // 12))   # ~24 pieces
                f.write(text[off:off + n])
                f.flush()
                off += n
                if not consumed.wait(timeout=120):
                    return
                consumed.clear()

    w._read_growth, w.poll, w.save_checkpoint = paced_read, timed_poll, copying_save
    writer = threading.Thread(target=grow)
    writer.start()
    try:
        live_render, live_sum = finish(w)
    finally:
        consumed.set()
        writer.join(timeout=120)
    if writer.is_alive() or not snaps:
        fail(f"watch: the writer did not finish, or no checkpoint was saved mid-stream "
             f"({len(snaps)} snapshots)")

    # The resume, on the finished file: the middle one of the snapshots whose
    # events file holds an event, so the dedup set is put to work.
    held = [(p, pos) for p, pos in snaps if (p / "events.jsonl").stat().st_size]
    if not held:
        fail(f"watch: no mid-stream snapshot of {len(snaps)} holds an event")
    snap, snap_pos = held[len(held) // 2]
    (work / "resumed").mkdir()
    shutil.copy(capture, work / "resumed" / "capture.txt")
    shutil.copy(snap / "ckpt.npz", work / "resumed.ckpt")
    shutil.copy(snap / "events.jsonl", work / "resumed.jsonl")
    restore_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sd.DeviceStreamingSession.restore(work / "resumed.ckpt", device=dev)
        torch.cuda.synchronize()
        restore_ms.append((time.perf_counter() - t0) * 1e3)
    events_before = len((work / "resumed.jsonl").read_text().splitlines())
    r = open_watch("resumed", work / "resumed" / "capture.txt", "--checkpoint",
                   str(work / "resumed.ckpt"))
    if r.pos != snap_pos:
        fail(f"watch: resumed at byte {r.pos}, the checkpoint was taken at {snap_pos}")
    resumed_render, resumed_sum = finish(r)
    torch.cuda.synchronize()
    launches = read_counts()
    if min(launches.values()) == 0:
        fail(f"watch: a kernel never launched: {launches}")

    others = {}
    for tag, extra in (("cpu", ["--device", "cpu"]), ("host", ["--engine", "host"])):
        (work / tag).mkdir()
        shutil.copy(capture, work / tag / "capture.txt")
        others[tag] = finish(open_watch(tag, work / tag / "capture.txt", *extra))

    def events(tag):
        return [json.loads(ln) for ln in (work / f"{tag}.jsonl").read_text().splitlines()]

    live_events = events("live")
    resumed_events = events("resumed")
    keys = [(e["sweep"], e["kind"], e["track"]) for e in resumed_events]
    if resumed_events != live_events or len(set(keys)) != len(keys) or not live_events:
        fail(f"watch: the resumed events ({len(resumed_events)}) differ from the "
             f"uninterrupted run's ({len(live_events)}) or repeat an event")
    for table in ("filtered", "stream_tracks", "stream_changes"):
        if not xlsx_same(work / "live" / f"capture_{table}.xlsx",
                         work / "resumed" / f"capture_{table}.xlsx"):
            fail(f"watch: the resumed {table} xlsx differs from the uninterrupted run's")
    counts = ("frames", "kept", "sweeps", "bytes_seen")
    if any(resumed_sum[k] != live_sum[k] for k in counts):
        fail(f"watch: resumed summary {resumed_sum}, uninterrupted {live_sum}")
    if resumed_sum["events"] != live_sum["events"] - events_before:
        fail("watch: the resumed run wrote events that were already in the file")
    if rendered_differ(np, resumed_render, live_render)[0]:
        fail("watch: the resumed render differs from the uninterrupted run's")
    for tag, (rendered, summary) in others.items():
        want = events(tag)
        strip = [{k: v for k, v in e.items() if k != "power"} for e in want]
        if ([{k: v for k, v in e.items() if k != "power"} for e in live_events] != strip
                or not np.allclose([e["power"] for e in live_events],
                                   [e["power"] for e in want], rtol=RTOL)):
            fail(f"watch: the card's events differ from {tag}'s")
        if not xlsx_same(work / "live" / "capture_filtered.xlsx",
                         work / tag / "capture_filtered.xlsx"):
            fail(f"watch: the filtered xlsx differs from {tag}'s")
        for table, ints in (("stream_tracks", {"Track", "Sweep", "CLK"}),
                            ("stream_changes", {"Sweep", "CLK", "Kind", "Track"})):
            why = xlsx_close(np, work / "live" / f"capture_{table}.xlsx",
                             work / tag / f"capture_{table}.xlsx", ints)
            if why:
                fail(f"watch: {table} differs from {tag}'s in {why}")
        if any(summary[k] != live_sum[k] for k in counts + ("tokens", "events")):
            fail(f"watch: summary {live_sum} on the card, {summary} with {tag}")
        why = rendered_differ(np, live_render, rendered)[0]
        if why:
            fail(f"watch: render() differs from {tag}'s: {why}")
    return {"launches": launches, "bytes": len(text), "summary": live_sum,
            "polls_fed": len(poll_ms), "host_ms_per_poll_median": statistics.median(poll_ms),
            "host_ms_per_poll_mean": statistics.fmean(poll_ms),
            "host_ms_per_poll_max": max(poll_ms), "checkpoint_saves": len(save_ms),
            "checkpoint_save_ms_median": statistics.median(save_ms),
            "checkpoint_restore_ms_median": statistics.median(restore_ms),
            "checkpoint_bytes": (work / "live.ckpt").stat().st_size,
            "resumed_from_byte": snap_pos, "events": len(live_events),
            "events_before_resume": events_before, "compared_with": sorted(others)}


RUN_CONFIGS = ("serial_hex_to_excel_v3", "batched_session", "streaming_replay")
RUN_CONFIG_TIMING = {"timings_s", "elapsed_s", "frames_per_sec", "host_frames_per_sec"}


def run_config_phase(np, tmp, ds_logs, angles, zero_counts, read_counts) -> dict:
    """Three named configs on a data directory of four dataset-scale logs,
    on the card (counted) and with ``--device cpu``; the other two draw
    PNGs, so they run in the CPU tests only."""
    import shutil

    from slam_process_tpu_torch.pipeline.configs import run_named_config

    data = tmp / "run_config_data"
    data.mkdir()
    for log in list(ds_logs)[:4]:
        shutil.copy(log, data / log.name)
    zero_counts()
    got = {name: run_named_config(name, data, angles, tmp / "run_config_cuda")
           for name in RUN_CONFIGS}
    launches = read_counts()
    for key in ("K1", "K2", "K3", "K5"):
        if launches[key] == 0:
            fail(f"run_config: {key} never launched: {launches}")
    want = {name: run_named_config(name, data, angles, tmp / "run_config_cpu", device="cpu")
            for name in RUN_CONFIGS}
    for name in RUN_CONFIGS:
        a = {k: v for k, v in got[name].items() if k not in RUN_CONFIG_TIMING}
        b = {k: v for k, v in want[name].items() if k not in RUN_CONFIG_TIMING}
        if a != b:
            fail(f"run_config {name}: {a} on the card, {b} with --device cpu")
    parsed = sorted(p.name for p in (tmp / "run_config_cuda").glob("*.xlsx"))
    if not parsed or not all(xlsx_same(tmp / "run_config_cuda" / p, tmp / "run_config_cpu" / p)
                             for p in parsed):
        fail("run_config: the Parsed xlsx differs between the card and --device cpu")
    return {"launches": launches, "results_cuda": got, "results_cpu": want,
            "xlsx_equal_cpu": parsed}


def outputs_differ(torch, a, b, fields=None):
    """Names of the pipeline output fields (``DeviceSessionOut``) that
    differ between ``a`` and ``b``: dtype, shape, NaN pattern and every
    value, floats bit for bit."""
    bad = []
    for name in fields or b._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            if x is not y:
                bad.append(name)
            continue
        x, y = x.cpu(), y.cpu()
        if x.dtype != y.dtype or x.shape != y.shape:
            bad.append(name)
        elif x.is_floating_point():
            if not (torch.equal(torch.isnan(x), torch.isnan(y))
                    and torch.equal(x.nan_to_num(0.0), y.nan_to_num(0.0))):
                bad.append(name)
        elif not torch.equal(x, y):
            bad.append(name)
    return bad


def host_cpu() -> dict:
    """The host CPU as ``/proc/cpuinfo`` names it (the model name, or
    vendor, family and model where the file has no name) and
    whether it has AVX-512 BW and VBMI, which the native scanner's block
    path needs."""
    from slam_process_tpu_torch.runtime import hexscan

    info = hexscan.cpu_info()
    flags = info.get("flags", "").split()
    model = info.get("model name") or " ".join(
        f"{k}={info[k]}" for k in ("vendor_id", "cpu family", "model") if k in info)
    return {"model": model or "unknown", "avx512vbmi": "avx512vbmi" in flags,
            "avx512bw": "avx512bw" in flags, "cores": len(os.sched_getaffinity(0))}


INGEST_HOST_RUNS = 7                 # host-timed runs per median in the ingest phase


def ingest_phase(np, torch, tmp, raws, crlf_logs, zero_counts, read_counts, dev) -> dict:
    """The text ingest on the card: each log of ``raws`` (the full session
    and the 19 dataset sessions) written in the shipped stride-3 layout must
    give the same bytes from the native scanner, numpy and the card's
    ``tokenize_stride3`` (its proof flag True), the reference tokenizer on
    the full session once; ``run_session_from_text`` on the card must equal
    ``run_session_on_device(read_hex_log(...))`` on the card in every field,
    the raster bit-equal; the CRLF layout (``crlf_logs``) takes the host
    fallback with equal outputs.  Then the tokenizers' host ms per engine
    and layout, the card's tokenize ms and device activities, and the text
    path against ``Session.from_log``."""
    from slam_process_tpu_torch.io import hexlog
    from slam_process_tpu_torch.ops.tokenize import (
        prepare_text, stride3_offset, text_bucket, tokenize_stride3)
    from slam_process_tpu_torch.pipeline.device import (
        run_session_from_text, run_session_on_device)
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.runtime import hexscan
    from slam_process_tpu_torch.utils.synthetic import to_hex_text

    t_build = time.perf_counter()
    if not hexscan.available():
        fail("ingest: the native hex scanner does not build on this host")
    build_s = time.perf_counter() - t_build
    logs = []
    for i, raw in enumerate(raws):
        path = tmp / f"shipped_{i:02d}.txt"
        path.write_bytes(to_hex_text(raw, "shipped"))
        logs.append(path)

    def card_tokens(text):
        p = stride3_offset(text)
        body, n_text = prepare_text(text, p, text_bucket(len(text) - p))
        return torch.from_numpy(body).to(dev), n_text

    zero_counts()
    for path, raw in zip(logs, raws):
        text = path.read_bytes()
        body, n_text = card_tokens(text)
        b, n_tok, regular = tokenize_stride3(body, n_text)
        got = {"native": hexlog.tokenize(text, "native"), "numpy": hexlog.tokenize(text, "numpy"),
               "card": b[:int(n_tok)].cpu().numpy()}
        if not bool(regular):
            fail(f"ingest {path.name}: the shipped layout failed the stride-3 proof flag")
        for engine, tokens in got.items():
            if not np.array_equal(tokens, raw):
                fail(f"ingest {path.name}: {engine} tokens differ from the written bytes")
        res = run_session_from_text(text)
        if not bool(res.tokenize_regular) or int(res.n_tokens) != len(raw):
            fail(f"ingest {path.name}: the text path fell back or miscounted tokens")
        bad = outputs_differ(torch, res.out, run_session_on_device(
            hexlog.read_hex_log(path, engine="native")))
        if bad:
            fail(f"ingest {path.name}: run_session_from_text differs from the byte path in {bad}")
    t0 = time.perf_counter()
    if not np.array_equal(hexlog.tokenize(logs[0].read_bytes(), "reference"), raws[0]):
        fail("ingest: the reference tokenizer differs on the full session")
    reference_ms = (time.perf_counter() - t0) * 1e3
    fallbacks = []
    for path in crlf_logs[:3]:
        data = path.read_bytes()
        if not np.array_equal(hexlog.tokenize(data, "native"), hexlog.tokenize(data, "numpy")):
            fail(f"ingest {path.name}: native and numpy tokens differ on the CRLF layout")
        res = run_session_from_text(data)
        if bool(res.tokenize_regular):
            fail(f"ingest {path.name}: the CRLF layout passed the stride-3 proof flag")
        bad = outputs_differ(torch, res.out, run_session_on_device(hexlog.read_hex_log(path)))
        if bad:
            fail(f"ingest {path.name}: the fallback differs from the byte path in {bad}")
        fallbacks.append(path.name)
    torch.cuda.synchronize()
    launches = read_counts()
    for key in ("K1", "K2", "K3"):
        if launches[key] == 0:
            fail(f"ingest: {key} never launched: {launches}")

    # Timings on the full session (host clock for the host tokenizers and
    # the whole calls, CUDA events for the card's tokenize).
    def host_ms(fn, runs=INGEST_HOST_RUNS):
        fn()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    full_texts = {"shipped": logs[0].read_bytes(), "crlf": crlf_logs[0].read_bytes()}
    tokenize_ms = {f"{engine}_{layout}": host_ms(lambda: hexlog.tokenize(text, engine))
                   for layout, text in full_texts.items() for engine in ("native", "numpy")}
    tokenize_ms["reference_shipped_single_run"] = reference_ms
    body, n_text = card_tokens(full_texts["shipped"])
    for _ in range(3):
        tokenize_stride3(body, n_text)
    torch.cuda.synchronize()
    card = []
    for _ in range(N_TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(40_000_000)
        start.record()
        tokenize_stride3(body, n_text)
        end.record()
        end.synchronize()
        card.append(start.elapsed_time(end))
    busy, acts, top = device_profile(torch, lambda: tokenize_stride3(body, n_text))

    def synced(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    path_ms = {
        "run_session_from_text": host_ms(synced(lambda: run_session_from_text(
            logs[0].read_bytes()))),
        "run_session_on_device_native_tokens": host_ms(synced(lambda: run_session_on_device(
            hexlog.read_hex_log(logs[0], engine="native")))),
        "Session.from_log_shipped": host_ms(synced(lambda: Session.from_log(logs[0]))),
        "Session.from_log_crlf": host_ms(synced(lambda: Session.from_log(crlf_logs[0]))),
    }
    return {"launches": launches, "logs_equal": len(logs), "crlf_fallbacks_equal": fallbacks,
            "full_session_text_bytes": len(full_texts["shipped"]),
            "full_session_tokens": len(raws[0]), "host_cpu": host_cpu(),
            "hexscan_library": str(hexscan.library_path().relative_to(REPO)),
            "hexscan_build_s": build_s,
            "host_tokenize_ms_median_of_7": tokenize_ms,
            "card_tokenize_ms_median_of_20": statistics.median(card),
            "card_tokenize_device_busy_ms": busy, "card_tokenize_device_activities": acts,
            "card_tokenize_top_us": top[:5],
            "full_session_host_ms_median_of_7": path_ms}


PRELOG_RTOL = 1e-6                   # pre-log means against the float64 oracle


def ulps_apart(np, a, b):
    """The largest distance, in float32 ulps of ``b``, between two float32
    grids with the same NaN pattern (-1 where the patterns differ)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        return -1
    fin = ~np.isnan(b)
    if not fin.any():
        return 0
    return float(np.max(np.abs(a[fin].astype(np.float64) - b[fin])
                        / np.spacing(np.abs(b[fin]))))


def prelog_phase(np, torch, sd, tmp, raw_full, filtered_full, raw_mp, filtered_mp, zero_counts,
                 read_counts, dev) -> dict:
    """The pre-log scene on the card: ``run_session_on_device(log_transform_
    scene=True)`` against ``device="cpu"`` (integer fields exactly, means
    within one float32 ulp: float64 atomics add in no fixed order) and
    against the float64 oracle ``intensity_grid_np`` (counts equal, means
    within ``PRELOG_RTOL``); a pre-log live feed of the multipath log in 64
    KiB chunks with ``collect_filtered`` against the offline oracle, and
    the same stream resumed from a checkpoint."""
    from slam_process_tpu_torch.config import PipelineConfig, SceneConfig
    from slam_process_tpu_torch.ops.scene import intensity_grid_np
    from slam_process_tpu_torch.pipeline.device import run_session_on_device

    log_cfg = SceneConfig(log_transform=True)
    prelog = PipelineConfig(scene=log_cfg)

    def oracle(f):
        return intensity_grid_np(f[:, 0], f[:, 1], f[:, 2], cfg=log_cfg)

    def near_oracle(mean, counts, ref):
        return (np.array_equal(np.asarray(counts), ref.counts)
                and np.array_equal(np.isnan(mean), np.isnan(ref.mean))
                and np.allclose(mean, ref.mean, rtol=PRELOG_RTOL, atol=0, equal_nan=True))

    zero_counts()
    t0 = time.perf_counter()
    out = run_session_on_device(raw_full, log_transform_scene=True)
    torch.cuda.synchronize()
    session_s = time.perf_counter() - t0
    out_cpu = run_session_on_device(raw_full, device="cpu", log_transform_scene=True)
    bad = outputs_differ(torch, out, out_cpu, ("frames", "frame_valid", "n_frames",
                                               "corrected_bs", "keep", "correct_overflow",
                                               "n_kept", "counts"))
    if bad:
        fail(f"prelog: the pre-log session differs between cuda and cpu in {bad}")
    ulps = ulps_apart(np, out.mean_grid.cpu().numpy(), out_cpu.mean_grid.numpy())
    if not 0 <= ulps <= 1:
        fail(f"prelog: pre-log means {ulps} float32 ulps apart between cuda and cpu")
    ref = oracle(filtered_full)
    if not near_oracle(out.mean_grid.cpu().numpy(), out.counts.cpu().numpy(), ref):
        fail("prelog: the pre-log session's grid is not the float64 oracle's")
    t_cuda, t_cpu = out.norm_t.cpu(), out_cpu.norm_t
    if not torch.equal(torch.isnan(t_cuda), torch.isnan(t_cpu)) or float(
            (t_cuda - t_cpu).nan_to_num(0.0).abs().max()) > 1e-4:
        fail("prelog: the pre-log raster's norm_t differs by more than 1e-4 from cpu")

    def live(stop=None, session=None):
        s = session or sd.DeviceStreamingSession(prelog, chunk_bytes=LIVE_CHUNK,
                                                 collect_filtered=True, device=dev)
        start = 0 if session is None else stop
        end = len(raw_mp) if session is not None or stop is None else stop
        for off in range(start, end, LIVE_CHUNK):
            s.feed(raw_mp[off:off + LIVE_CHUNK])
        return s

    t0 = time.perf_counter()
    s = live()
    s.finalize()
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    ref_mp = oracle(filtered_mp)
    grid = s.intensity()
    if not np.array_equal(s.filtered, filtered_mp):
        fail("prelog: the pre-log live feed's filtered rows differ from the offline session's")
    if not near_oracle(grid.mean, grid.counts, ref_mp):
        fail("prelog: the pre-log live feed's grid is not the float64 oracle's")
    half = (len(raw_mp) // LIVE_CHUNK // 2) * LIVE_CHUNK
    part = live(stop=half)
    part.save_checkpoint(tmp / "prelog.ckpt", extra={"offset": half})
    resumed = sd.DeviceStreamingSession.restore(tmp / "prelog.ckpt", device=dev)
    live(stop=half, session=resumed).finalize()
    grid_r = resumed.intensity()
    if not (np.array_equal(resumed.filtered, filtered_mp)
            and near_oracle(grid_r.mean, grid_r.counts, ref_mp)
            and np.allclose(grid_r.mean, grid.mean, rtol=1e-12, atol=0, equal_nan=True)):
        fail("prelog: the resumed pre-log stream differs from the uninterrupted one")
    torch.cuda.synchronize()
    launches = read_counts()
    for key in ("K1", "K2", "K3", "K5"):
        if launches[key] == 0:
            fail(f"prelog: {key} never launched: {launches}")
    rel = lambda m, r: float(np.nanmax(np.abs(m - r.mean) / np.abs(r.mean)))  # noqa: E731
    return {"launches": launches, "session_ms": session_s * 1e3,
            "session_mean_ulps_cuda_vs_cpu": ulps,
            "session_max_rel_vs_oracle": rel(out.mean_grid.cpu().numpy(), ref),
            "live_feed_chunks": -(-len(raw_mp) // LIVE_CHUNK), "live_feed_s": stream_s,
            "live_feed_max_rel_vs_oracle": rel(grid.mean, ref_mp),
            "resumed_max_rel_vs_uninterrupted": float(np.nanmax(
                np.abs(grid_r.mean - grid.mean) / np.abs(grid.mean))),
            "resumed_from_byte": half, "sums_dtype": str(resumed._state.sums.dtype)}


SM_SIC_RTOL = 1e-6                   # SM-SIC metric between the card and the CPU / host


def sm_sic_phase(np, torch, sd, sessions, results, angles, raw_mp, zero_counts, read_counts,
                 dev) -> dict:
    """SM-SIC and the dataset's per-sweep paths on the card:
    ``run_estimator("sm_sic")`` against ``engine="host"`` and
    ``device="cpu"``; ``sweep_paths(estimator="sm_sic")`` and its
    ``path_tracks`` against ``device="cpu"`` on three sessions;
    ``sweep_paths_dataset`` (NN-OMP) over the 21 sessions against their
    per-session results of the sweep_paths phase, exactly; an SM-SIC stream
    of the multipath log in 64 KiB chunks against the offline
    ``sweep_paths`` / ``path_tracks(beam_ids=...)`` on the card, exactly."""
    from slam_process_tpu_torch.models.registry import run_estimator
    from slam_process_tpu_torch.models.sm_sic import SmSicPaths
    from slam_process_tpu_torch.pipeline.session import sweep_paths_dataset

    mp = sessions[MP]
    zero_counts()
    t0 = time.perf_counter()
    card = run_estimator("sm_sic", mp, angles)
    estimator_ms = (time.perf_counter() - t0) * 1e3
    for other, engine in ((run_estimator("sm_sic", mp, angles, engine="host"), "host"),
                          (run_estimator("sm_sic", mp, angles, device="cpu"), "cpu")):
        if not (list(card["type"]) == list(other["type"]) and len(card) > 0
                and np.array_equal(card["id"], other["id"])
                and np.array_equal(card["aoa"], other["aoa"])
                and np.array_equal(card["aod"], other["aod"])
                and np.allclose(card["metric"], other["metric"], rtol=SM_SIC_RTOL, atol=0)):
            fail(f"sm_sic: run_estimator on the card differs from {engine}:\n"
                 f"{card.to_string()}\n{other.to_string()}")

    compared = []
    for i in (0, 1, MP):
        s = sessions[i]
        (paths, valid), (want, want_valid) = (s.sweep_paths(angles, estimator="sm_sic"),
                                              s.sweep_paths(angles, estimator="sm_sic",
                                                            device="cpu"))
        if not isinstance(paths, SmSicPaths) or not np.array_equal(valid, want_valid):
            fail(f"sm_sic: session {i}'s sweep_valid differs between cuda and cpu")
        for field in ("aoa", "aod", "valid", "is_los"):
            if not np.array_equal(getattr(paths, field), getattr(want, field)):
                fail(f"sm_sic: session {i}'s per-sweep {field} differs between cuda and cpu")
        if not np.allclose(paths.metric, want.metric, rtol=SM_SIC_RTOL, atol=0):
            fail(f"sm_sic: session {i}'s per-sweep metric beyond rtol {SM_SIC_RTOL}")
        tr, tr_cpu = (s.path_tracks(angles, estimator="sm_sic", device=d) for d in (dev, "cpu"))
        if not (int(tr[0].n_tracks) == int(tr_cpu[0].n_tracks) > 0
                and all(np.array_equal(getattr(tr[0], f), getattr(tr_cpu[0], f))
                        for f in ("pos_aoa", "pos_aod", "observed", "created"))
                and np.allclose(tr[0].power, tr_cpu[0].power, rtol=SM_SIC_RTOL)):
            fail(f"sm_sic: session {i}'s SM-SIC tracks differ between cuda and cpu")
        compared.append(i)

    t0 = time.perf_counter()
    dataset = sweep_paths_dataset(sessions, angles)
    dataset_ms = (time.perf_counter() - t0) * 1e3
    shapes = {tuple(len(x) for x in s._sweep_host_prep(angles)[2:4]) for s in sessions}
    for i, ((paths, valid), (want, want_valid)) in enumerate(zip(dataset, results)):
        if not np.array_equal(valid, want_valid) or any(
                not np.array_equal(getattr(paths, f), getattr(want, f)) for f in want._fields):
            fail(f"sm_sic: sweep_paths_dataset differs from session {i}'s sweep_paths")

    spec = sd.make_paths_spec(angles, estimator="sm_sic", s_step=8)
    ids = (spec[0].ue_ids, spec[0].bs_ids)
    t0 = time.perf_counter()
    stream = sd.DeviceStreamingSession(chunk_bytes=LIVE_CHUNK, collect_paths=spec, device=dev)
    for off in range(0, len(raw_mp), LIVE_CHUNK):
        stream.feed(raw_mp[off:off + LIVE_CHUNK])
    stream.finalize()
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    offline = (mp.sweep_paths(angles, estimator="sm_sic", beam_ids=ids),
               mp.sweep_times(), mp.path_tracks(angles, estimator="sm_sic", beam_ids=ids))
    bad = paths_differ(np, stream_readers(stream), offline, exact=True)
    if bad:
        fail(f"sm_sic: the SM-SIC stream differs from the offline paths in {bad}")
    torch.cuda.synchronize()
    launches = read_counts()
    for key in ("K1", "K2", "K4", "K5", "K6"):
        if launches[key] == 0:
            fail(f"sm_sic: {key} never launched: {launches}")
    return {"launches": launches, "run_estimator_ms": estimator_ms,
            "table_rows": len(card), "table": card.to_string(index=False).splitlines(),
            "per_sweep_compared_with_cpu": compared,
            "dataset_sessions": len(dataset), "dataset_beam_shapes": sorted(shapes),
            "dataset_ms": dataset_ms, "stream_sweeps": stream.n_sweeps_closed,
            "stream_tracks": int(stream.path_tracks()[0].n_tracks), "stream_s": stream_s}


ESTIMATORS = ("svd", "omp_dense", "lasso_refine", "peak_picking", "fusion", "nn_omp_v13",
              "geometric")


def estimator_tables_differ(np, name, got, want, vs):
    """Where the eleventh slice's table ``got`` (the card's) departs from
    ``want`` (``vs``: "cpu" or "host"), or None.  Every family: the same
    rows, labels and cells (angles equal; the NN-OMP device grid's float32
    against the float32 of the host's).  Values: svd Power and
    SingularValue within rtol 1e-9; omp_dense Power 1e-6 (normal equations
    against lstsq); fusion the NLoS metric 1e-9 and the LoS row's (the v1
    NN-OMP's float32 power) 2e-4; nn_omp_v13 Power 2e-4; lasso_refine
    against the CPU Power 1e-9 and against the tol-stopped float32-design
    host JAX's own bounds (angles 0.11 deg, Power 2e-3); peak_picking and
    geometric equal text."""
    if name in ("peak_picking", "geometric"):
        return None if got.to_string(index=False) == want.to_string(index=False) else "text"
    type_col = {"fusion": "type", "nn_omp_v13": "PathType"}.get(name, "Type")
    if len(got) != len(want) or len(got) == 0:
        return f"rows {len(got)} against {len(want)}"
    if list(got[type_col]) != list(want[type_col]):
        return f"labels {list(got[type_col])} against {list(want[type_col])}"
    angles = ("aoa", "aod") if name == "fusion" else ("AoA", "AoD")
    for c in angles:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if name == "nn_omp_v13":
            g, w = g.astype(np.float32), w.astype(np.float32)
        if name == "lasso_refine" and vs == "host":
            if not np.allclose(g, w, rtol=0, atol=0.11):
                return c
        elif not np.array_equal(g, w):
            return c
    rtol = {"svd": 1e-9, "omp_dense": 1e-6, "nn_omp_v13": 2e-4,
            "lasso_refine": 1e-9 if vs == "cpu" else 2e-3}
    if name == "fusion":
        los = np.asarray(want["type"]) == "LoS"
        ok = (np.allclose(got["metric"][~los], want["metric"][~los], rtol=1e-9, atol=0)
              and np.allclose(got["metric"][los], want["metric"][los], rtol=2e-4, atol=0))
        return None if ok else "metric"
    for c in (("Power", "SingularValue") if name == "svd" else ("Power",)):
        if not np.allclose(got[c], want[c], rtol=rtol[name], atol=0):
            return c
    return None


def estimators_phase(np, torch, logs, angles, zero_counts, read_counts, dev) -> dict:
    """The eleventh slice's estimator families on the card: each of
    ``ESTIMATORS`` through ``run_estimator`` at full width (the shipped
    grids) on the full multipath and noise sessions decoded and corrected
    on the card (counted: K1 and K2 must launch), against ``device="cpu"``
    and ``engine="host"``; the table text; host ms of the first card call
    and of the host engine (one run each); on the multipath session the
    card call's host ms (median of 5 after a warm-up, synchronized), its
    device busy ms and activities under ``torch.profiler``, and the LASSO
    loop's own ms and activities."""
    import importlib.util
    import warnings

    from slam_process_tpu_torch.models import lasso_refine, registry
    from slam_process_tpu_torch.models.peak_picking import mapped_pair_means
    from slam_process_tpu_torch.pipeline.session import Session

    def call(name, s, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)   # geometric's device warning
            return registry.run_estimator(name, s, angles, **kw)

    def host_ms(fn, n=5, warm=True):
        if warm:
            fn()
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    zero_counts()
    sessions = {key: Session.from_log(path) for key, path in logs.items()}
    for s in sessions.values():
        s.correct()
    torch.cuda.synchronize()
    launches = read_counts()
    for key in ("K1", "K2"):
        if launches[key] == 0:
            fail(f"estimators: {key} never launched: {launches}")

    out, hosts = {}, {}
    for key, s in sessions.items():
        for name in ESTIMATORS:
            t0 = time.perf_counter()
            card = call(name, s)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            host = call(name, s, engine="host")
            host_engine_ms = (time.perf_counter() - t0) * 1e3
            cpu = call(name, s, device="cpu")
            for other, vs in ((cpu, "cpu"), (host, "host")):
                why = estimator_tables_differ(np, name, card, other, vs)
                if why:
                    fail(f"estimators {name} ({key}): the card differs from {vs} in {why}:\n"
                         f"{card.to_string(index=False)[:1500]}\n"
                         f"{other.to_string(index=False)[:1500]}")
            hosts[f"{name}/{key}"] = host
            out[f"{name}/{key}"] = {"rows": len(card),
                                    "table_head": card.to_string(index=False).splitlines()[:8],
                                    "first_card_ms": first_ms, "host_engine_ms": host_engine_ms}
    # Times and device work on the multipath session (the traffic the
    # estimators are for): the card call's host ms (median of 5 after the
    # warm-up above), one profiled call; the LASSO loop alone (its patches
    # at this session's shapes), the profiler on the device side only
    # (~10^5 activities).
    s = sessions["multipath"]
    for name in ESTIMATORS:
        busy, acts, top = device_profile(torch, lambda: call(name, s),
                                         cpu=name != "lasso_refine")
        out[f"{name}/multipath"].update({
            "card_ms": host_ms(lambda: call(name, s), warm=False),
            "device_busy_ms": busy, "device_activities": acts, "top_us": top[:4]})
    aoa, aod, rss = lasso_refine.mapped_row_means(s, angles)
    grids = lasso_refine.make_heatmap_interpolated(aoa, aod, rss)
    peaks = lasso_refine.peak_regions_np(grids[2], 65.0)

    def loop():
        return lasso_refine.refine_patches_device(aoa, aod, rss, grids[0], grids[1],
                                                  grids[2].shape, peaks)

    busy, acts, _ = device_profile(torch, loop, cpu=False)
    out["lasso_loop/multipath"] = {"patches": min(len(peaks), 20), "samples": len(aoa),
                                   "ms": host_ms(loop, n=1, warm=False), "device_busy_ms": busy,
                                   "device_activities": acts}
    # The column norms of the atoms in the omp_dense host table (JAX's
    # device rule never selects one of norm <= 1e-15).
    sig2 = 2 * (1.4 / 2.355) ** 2
    for key, sess in sessions.items():
        a, d, _ = mapped_pair_means(sess, angles)
        host = hosts[f"omp_dense/{key}"]
        out[f"omp_dense/{key}"]["host_selected_min_norm"] = min(
            float(np.sqrt(np.sum(np.exp(-(a - x) ** 2 / sig2) ** 2
                                 * np.exp(-(d - z) ** 2 / sig2) ** 2)))
            for x, z in zip(host["AoA"], host["AoD"]))
    if importlib.util.find_spec("matplotlib") is None:
        print("estimators: the estimators' PNGs were not drawn: matplotlib is not installed "
              "on this machine (the CPU tests draw them)", flush=True)
    return {"launches": launches, "sessions": {k: len(s.filtered) for k, s in sessions.items()},
            "families": out}


def device_profile(torch, fn, count=(), cpu=True):
    """Run ``fn`` once under ``torch.profiler``: (device busy ms, device
    activities, top 10 names by device us), and with ``count`` a fourth
    item, {name part: device activities whose name holds it}.  Busy time is
    the union of the device activities' intervals
    (``utils/device_timing.interval_union``: kernels, copies, memsets; not
    the CPU-side aten rows, which would count each kernel twice, nor the
    profiler's own buffer requests).  ``cpu=False`` traces
    the device only (cheaper for ~10^5 activities)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kinds = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=kinds) as prof:
        fn()
        torch.cuda.synchronize()
    from slam_process_tpu_torch.utils.device_timing import interval_union

    acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith("Activity Buffer")]
    busy_us = interval_union((e.time_range.start, e.time_range.end) for e in acts)
    by_name = {}
    for e in acts:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us()
    out = busy_us / 1e3, len(acts), sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    if count:
        out += ({part: sum(part in e.name for e in acts) for part in count},)
    return out


def k1_bare_launch(torch, _build, cuda_decode, b, limit):
    """K1's kernel alone on ``b``: one C launch into outputs made once (the
    wrapper's checks and allocations, host work only, left out)."""
    n = b.numel()
    r = -(-n // 11)
    outs = (torch.empty((r, 5), dtype=torch.int32, device=b.device),
            torch.empty(r, dtype=torch.bool, device=b.device),
            torch.empty((), dtype=torch.int32, device=b.device))
    stream = _build.stream_of(b)
    args = (b.data_ptr(), n, min(int(limit), n), 0xCC, 0x33, *(t.data_ptr() for t in outs),
            cuda_decode.ticket_for(b.device, stream).data_ptr(), stream)
    fn = cuda_decode._fn()
    return lambda: fn(*args)


def k3_cases(torch) -> dict:
    """K3's tiles {(S, (h, w), sigma): mats [S, h, w] on the CPU}: S = 1, 4
    and 66 random RSS-sized tiles with 5 % NaN (where S > 1, tile 0 all NaN
    and tile 1 one finite cell) of 64 x 64, 48 x 100 and 5 x 7 (fewer rows
    than the cluster's eight bands), at sigma 0, 0.5, 1, 2.3 and 3 (1 x 1 to
    19 x 19 taps: 7 x 7 through the kernel built for that width, the others
    through the one that reads the width at run time)."""
    out = {}
    for s in (1, 4, 66):
        for shape in ((64, 64), (48, 100), (5, 7)):
            gen = torch.Generator().manual_seed(s * 1000 + shape[1])
            mats = torch.rand((s, *shape), generator=gen) * (1 << 18)
            mats[torch.rand((s, *shape), generator=gen) < 0.05] = float("nan")
            if s > 1:
                mats[:2] = float("nan")
                mats[1, shape[0] // 2, shape[1] // 3] = 1234.0
            for sigma in (0.0, 0.5, 1.0, 2.3, 3.0):
                out[(s, shape, sigma)] = mats
    return out


def k2_work(torch, gid, clk, packed, *, bmax, cycle, tol):
    """(candidates, search steps) that the corrector's verdicts need on these
    inputs.  Candidates: per row, the live baselines of its group whose
    residue lies within ``tol`` of the row's (resid <= tol, the formula of
    ``ops/correct.py::baseline_plane_verdicts``), the only ones the minimum
    is taken over.  Search steps: per row with a group, 2 ceil(log2(n + 1))
    compares to find the two ends of its arc in the group's n sorted
    residues.  Counted on the card, in slices of rows."""
    g_rows = packed.shape[0]
    r_tab = ((packed[:, :bmax].int() << 8) | packed[:, bmax:2 * bmax].int())
    n_tab = packed[:, 3 * bmax].int().clamp(0, bmax)
    cols = torch.arange(bmax, device=packed.device, dtype=torch.int32)
    half = cycle // 2
    cand = steps = 0
    for lo in range(0, gid.numel(), 1 << 16):
        g, c = gid[lo:lo + (1 << 16)], clk[lo:lo + (1 << 16)]
        ok = (g >= 0) & (g < g_rows)
        gg = g.long().clamp(0, g_rows - 1)
        n = torch.where(ok, n_tab[gg], 0)
        diff = torch.remainder(c, cycle)[:, None] - r_tab[gg]
        k_frac = (diff >= cycle - half).int() - (diff < -half).int()
        live = cols[None, :] < n[:, None]
        cand += int((((diff - k_frac * cycle).abs() <= tol) & live).sum())
        steps += int((2 * torch.ceil(torch.log2(n[ok].double() + 1))).sum())
    return cand, steps


def k2_ops(candidates, steps, rows):
    """K2's int32 operations: 8 per candidate scored (difference, two
    compares, the wrap, |.|, the test, the packed score, the minimum), 2 per
    search step (a compare and a select), 10 per row (the floor division,
    the outputs)."""
    return candidates * 8 + steps * 2 + rows * 10


WINDOW_WRAPPERS = {"K1": ("cuda_decode", "decode_rows_cuda"),
                   "K1s": ("cuda_decode", "decode_rows_streams_cuda"),
                   "K2": ("cuda_correct", "correct_verdicts_cuda"),
                   "K4": ("cuda_sweep_sums", "sweep_sums_cuda")}


def eager_windows(sd, s):
    """``s`` (a ``DeviceStreamingSession``) with every window run by the
    eager body, ``_WindowRound._round``, in place of its CUDA graph: the
    graphs' comparator, and a stream whose kernel calls can be recorded (a
    graph replay calls no wrapper).  A checkout from before the graphs is
    eager already and is returned as it is."""
    if not hasattr(s, "_load_window"):
        return s

    def step(piece, n_bytes):
        s._load_window(piece, n_bytes)
        s._round(sd._map_state(s._state, sd._lift), *s._window_inputs())

    s._step = step
    return s


def stream_window_inputs(sd, raw, chunk, dev, paths_spec=None):
    """{key: (args, kwargs)} of K1's, K2's and, with ``paths_spec`` (the
    stream then estimates paths, K4 once a window), K4's call in a stream's
    second full window of ``chunk`` bytes (the stream run by its eager body),
    recorded from the wrappers of the
    ``slam_process_tpu_torch`` that ``sd`` belongs to while the stream runs (a
    first feed of ``chunk`` bytes runs one full window and keeps 10 bytes;
    the second feed runs a full window, then a 20-byte one).  A stream that
    decodes through the stream-axis entry at S = 1 has its K1 call given as
    the single entry's arguments (the bytes [N] and the limit)."""
    import importlib

    keys = ("K1", "K1s", "K2", "K4") if paths_spec is not None else ("K1", "K1s", "K2")
    pkg = sd.__name__.split(".")[0]
    mods = {k: (importlib.import_module(f"{pkg}.ops.{WINDOW_WRAPPERS[k][0]}"),
                WINDOW_WRAPPERS[k][1]) for k in keys}
    mods = {k: (mod, attr) for k, (mod, attr) in mods.items() if hasattr(mod, attr)}
    calls = {k: [] for k in mods}
    originals = {k: getattr(mod, attr) for k, (mod, attr) in mods.items()}

    def recorder(key):
        def call(*args, **kw):
            if key == "K1s":
                b, lim, *rest = args
                calls["K1"].append(((b[0], b.shape[1] if lim is None else int(lim[0]), *rest),
                                    kw))
            else:
                calls[key].append((args, kw))
            return originals[key](*args, **kw)
        return call

    for key, (mod, attr) in mods.items():
        setattr(mod, attr, recorder(key))
    try:
        s = eager_windows(sd, sd.DeviceStreamingSession(
            chunk_bytes=chunk, collect_filtered=True, collect_paths=paths_spec, device=dev))
        s.feed(raw[:chunk])
        s.feed(raw[chunk:2 * chunk])
    finally:
        for key, (mod, attr) in mods.items():
            setattr(mod, attr, originals[key])
    calls.pop("K1s", None)
    if min(len(c) for c in calls.values()) < 2 or calls["K1"][1][0][1] != chunk:
        fail(f"stream window of {chunk} bytes: the second window is not a full one "
             f"({ {k: len(c) for k, c in calls.items()} } calls)")
    return {k: c[1] for k, c in calls.items()}


def k7_calls(pkg: str, fn) -> list:
    """K7's calls while ``fn()`` runs: (G, b, max_outer, solver, x0, P0),
    copies of what the ``cuda_nnls`` wrapper of the package ``pkg`` was
    given."""
    import importlib

    mod = importlib.import_module(f"{pkg}.ops.cuda_nnls")
    real, calls = mod.nnls_gram_cuda, []

    def record(G, b, max_outer=64, solver="auto", x0=None, P0=None):
        calls.append((G.clone(), b.clone(), max_outer, solver,
                      None if x0 is None else x0.clone(), None if P0 is None else P0.clone()))
        return real(G, b, max_outer, solver, x0, P0)

    mod.nnls_gram_cuda = record
    try:
        fn()
    finally:
        mod.nnls_gram_cuda = real
    return calls


def k7_stream_calls(sd, raw, chunk, dev, spec) -> list:
    """K7's calls in a paths stream's second full window of ``chunk``
    bytes, one per NN-OMP iteration (``k7_calls``), recorded while the
    stream of the package that ``sd`` belongs to runs by its eager body
    (``eager_windows``; the first feed runs one full window, the second a
    full and a 20-byte one)."""
    pkg = sd.__name__.split(".")[0]
    s = eager_windows(sd, sd.DeviceStreamingSession(chunk_bytes=chunk, collect_paths=spec,
                                                    device=dev))
    first = k7_calls(pkg, lambda: s.feed(raw[:chunk]))
    rest = k7_calls(pkg, lambda: s.feed(raw[chunk:2 * chunk]))
    if not first or len(rest) != 2 * len(first):
        fail(f"paths stream of {chunk}-byte windows: {len(first) + len(rest)} NNLS calls in "
             "three windows, not the same number in each")
    return rest[:len(first)]


def estimator_k7_calls(sd, sessions, angles, device=None) -> dict:
    """K7's calls where the session estimator makes them (K = 20, one call
    an NN-OMP iteration, ``k7_calls``), in the package that ``sd`` belongs
    to: ``run_estimator("nn_omp")`` on the full multipath session
    (``sessions[MP]``: 1 lane) and the "vmap" form of
    ``batch_estimation._batched_nn_omp`` over the sessions packed at the
    v1-7 flavor (one lane a session), on ``device`` (None: CUDA)."""
    import importlib

    pkg = sd.__name__.split(".")[0]
    registry = importlib.import_module(f"{pkg}.models.registry")
    est = importlib.import_module(f"{pkg}.models.batch_estimation")
    dictionary = importlib.import_module(f"{pkg}.models.dictionary")
    dict_cfg, cfg, log_t, keep, stop = est.flavor_config("v1-7")
    mats, dicts = [], []
    for sess in sessions:
        m, u, b = registry.build_scene(sess, angles, log_t)
        mats.append(m)
        dicts.append(dictionary.make_dictionary(u, b, dict_cfg))
    packed = est.pack_scenes(mats, dicts)
    return {"estimate_1_lane": k7_calls(pkg, lambda: registry.run_estimator(
                "nn_omp", sessions[MP], angles, device=device)),
            f"vmap_{len(sessions)}_lanes": k7_calls(pkg, lambda: est._batched_nn_omp(
                packed, cfg, keep, stop, device=device))}


def k7_work(nnls, args) -> tuple:
    """(outer steps, passive solves) that K7's lanes take on ``args`` =
    (G, b, max_outer, solver, x0, P0): each lane run alone through the plain
    version with its loop bodies counted (a lane alone stops at its own
    end, as it does in the kernel)."""
    G, b, max_outer, solver, x0, P0 = args
    n = {"outer": 0, "solves": 0}
    matvec, solve = nnls._matvec, nnls._solve_passive

    def counted_matvec(*a):
        n["outer"] += 1
        return matvec(*a)

    def counted_solve(*a):
        n["solves"] += 1
        return solve(*a)

    def lane(t, i):
        return None if t is None else t[i:i + 1]

    nnls._matvec, nnls._solve_passive = counted_matvec, counted_solve
    try:
        for i in range(G.shape[0]):
            nnls.nnls_gram_plain(lane(G, i), lane(b, i), max_outer, solver, lane(x0, i),
                                 lane(P0, i))
    finally:
        nnls._matvec, nnls._solve_passive = matvec, solve
    return n["outer"], n["solves"]


def k7_ops(k: int, solver: str, outer: int, solves: int) -> tuple:
    """K7's arithmetic for ``outer`` outer steps and ``solves`` passive
    solves at K = k, as (float32, float64) operations: an outer step's G x
    and gradient (2 k^2 + k) and argmax (k); a solve's masked tile (2 k^2 +
    k), its elimination (the adjugate's 54 at K = 3; Gauss-Jordan's k (k + 1)
    (2 k + 1); LU's 2 k^3 / 3 + 2 k^2, in float64) and the step back (6 k)."""
    f64 = 0
    if k == 3:
        elim = 54
    elif k > 3 and solver == "auto":
        elim = k * (k + 1) * (2 * k + 1)
    else:
        elim, f64 = 0, 2 * k ** 3 // 3 + 2 * k ** 2
    return outer * (2 * k * k + 2 * k) + solves * (2 * k * k + k + elim + 6 * k), solves * f64


def k7_bound(nnls, calls) -> dict:
    """The work of K7's ``calls`` (each (G, b, max_outer, solver, x0, P0)):
    outer steps and solves (``k7_work``), bytes (G, b, x0 and P0 read once, x
    and P written once), float32 and float64 operations (``k7_ops``), and
    the least time: the larger of the bytes at the memory rate and the
    operations at their type's peak (the float32 and float64 units side by
    side)."""
    n = {"outer_steps": 0, "solves": 0, "bytes": 0, "f32_ops": 0, "f64_ops": 0}
    for args in calls:
        lanes, k = args[0].shape[:2]
        outer, solves = k7_work(nnls, args)
        f32, f64 = k7_ops(k, args[3], outer, solves)
        n["outer_steps"] += outer
        n["solves"] += solves
        n["bytes"] += lanes * k * (4 * k + 4 + 4 + 1 + 4 + 1)
        n["f32_ops"] += f32
        n["f64_ops"] += f64
    t_bytes = n["bytes"] / PEAK_BYTES_PER_S
    t_ops = max(n["f32_ops"] / PEAK_F32_PER_S, n["f64_ops"] / PEAK_F64_PER_S)
    return {**n, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def k4_cases(np, torch, dev, p, bs, val, n_sweeps):
    """K4's inputs {case: (p, bs, val, max_sweeps)} on the card: (a) the
    full session's rows; (b) an unsorted stream over 65 sweeps (the TPU
    kernel's spill case); (c) p and bs outside their ranges and dropped
    rows; (d) every row in one cell, summing to 2^24 - 1; (e) 66 sweeps,
    wider than the TPU kernel's 4224 columns; (f) no rows."""
    rng = np.random.default_rng(5)

    def put(*xs):
        return tuple(torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)
                     for x in xs)

    f = 200_000
    out = {"a_main_path": (p, bs, val, n_sweeps)}
    out["b_unsorted_65_sweeps"] = (*put(rng.integers(0, 65 * 64, f), rng.integers(0, 64, f),
                                        rng.integers(0, 1 << 18, f)), 65)
    out["c_out_of_range_and_dropped"] = (*put(
        np.where(rng.random(f) < 0.1, -1, rng.integers(-70, 8 * 64 + 70, f)),
        rng.integers(-2, 66, f), rng.integers(0, 1 << 18, f)), 8)
    n = 255                       # 255 x 65,793 = 2^24 - 1
    out["d_one_cell_2^24-1"] = (*put(np.full(n, 3 * 64 + 17), np.full(n, 40),
                                     np.full(n, 65_793)), 4)
    out["e_66_sweeps"] = (*put(np.sort(rng.integers(0, 66 * 64, f)), rng.integers(0, 64, f),
                               rng.integers(0, 1 << 18, f)), 66)
    out["f_no_rows"] = (*put(np.zeros(0), np.zeros(0), np.zeros(0)), 5)
    return out


def k5_inputs(torch, sd, raw, dev):
    """K5's main-path inputs: the dataset replay's second 1 MiB window (the
    first window's open group carried, then the window's rows), as the
    stream hands them to the carry compaction and to the emit ring."""
    s = sd.DeviceStreamingSession(chunk_bytes=REPLAY_CHUNK, collect_filtered=True,
                                  emit_capacity=len(raw) // 11 + 1, device=dev)
    s.feed(raw[:REPLAY_CHUNK])
    lo = REPLAY_CHUNK - sd.CARRY_BYTES
    piece = raw[lo:lo + REPLAY_CHUNK]
    w = s._close_groups(piece, len(piece))
    return {"rows": w.combined, "open": w.open_mask, "kept": sd._kept_rows(w.combined, w.corrected),
            "keep": w.keep, "ring": s._state.emit_buf, "offset": s._state.emit_count,
            "ecap": s._ecap}


def k5_race_check(torch, compact, cuda_compact, dev):
    """The look-back's race test (compute-sanitizer does not run on the
    card's machine): 4,194,304 rows (4,096 tiles, more than the card holds
    at once) at 50 % density into two destinations, 200 times; every result
    must equal the first, and the first the plain version."""
    f = 4_194_304
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = torch.randint(-(1 << 30), 1 << 30, (f, 5), generator=gen, dtype=torch.int32,
                         device=dev)
    mask = torch.rand(f, generator=gen, device=dev) < 0.5
    cap = (1 << 21) + 5_000
    ring = torch.zeros((f, 5), dtype=torch.int32, device=dev)
    offset = torch.tensor(12_345, dtype=torch.int32, device=dev)
    dests = [(cap, None, None), (f, ring, offset)]
    (first, first_ring), n = cuda_compact.compact_rows_multi_cuda(rows, mask, dests)
    first_ring = first_ring.clone()
    (want, want_ring), n_want = compact.compact_rows_multi_plain(
        rows, mask, [(cap, None, None), (f, torch.zeros_like(ring), offset)])
    if not (torch.equal(first, want) and torch.equal(first_ring, want_ring)
            and int(n) == int(n_want)):
        fail("K5 4M_rows_50pct: kernel and plain version differ")
    for rep in range(200):
        (got, got_ring), n_got = cuda_compact.compact_rows_multi_cuda(rows, mask, dests)
        if not (torch.equal(got, first) and torch.equal(got_ring, first_ring)
                and int(n_got) == int(n)):
            fail(f"K5 4M_rows_50pct: repetition {rep} differs from the first")


def k6_cases(np, torch, dev):
    """K6's inputs {case: (args, gate_deg)} on the card: 65 lanes (s_step
    64) with 33 live from a carry of 3 tracks, 9 lanes (s_step 8) all live,
    planted ties at the gate (``tests/test_torch_tracker.py``), m_eff 0;
    then T * K = 40, just above one warp's 32 pairs; the limits T = 16, K =
    20, all lanes live, with uniform angles and on an integer grid (exact
    ties across the warp's threads); 600 lanes (the offline tracker's
    length, two staging tiles at K = 3 and eight at K = 20); m_eff = s1 - 1
    and m_eff > s1."""
    rng = np.random.default_rng(17)

    def lanes(s1, k_n, live, t_n, n_created, grid=False):
        bounds = ((-4, 5), (-4, 5), (0, 1)) if grid else ((-45, 45), (-45, 45), (0, 1))
        f32 = [torch.from_numpy((rng.integers(lo, hi, (s1, k_n)) if grid and hi > 1 else
                                 rng.uniform(lo, hi, (s1, k_n))).astype(np.float32)).to(dev)
               for lo, hi in bounds]
        pos = torch.from_numpy(rng.uniform(-45, 45, (t_n, 2)).astype(np.float32)).to(dev)
        return (*f32, torch.from_numpy(rng.random((s1, k_n)) < 0.7).to(dev),
                torch.tensor(live, dtype=torch.int32, device=dev), pos,
                torch.arange(t_n, device=dev) < n_created,
                torch.tensor(n_created, dtype=torch.int32, device=dev))

    f32 = np.float32
    planted = [torch.from_numpy(np.array(x, dtype)).to(dev) for x, dtype in (
        ([[0, 10, 0], [5, 3, 13], [8, 2, 5]], f32), ([[0, 0, 0], [0, 4.0001, 4], [4, -4, 5]], f32),
        ([[1, 2, 3], [4, 5, 6], [7, 8, 9]], f32), ([[1, 1, 0], [1, 1, 1], [1, 1, 1]], bool))]
    planted += [torch.tensor(3, dtype=torch.int32, device=dev),
                torch.zeros((4, 2), dtype=torch.float32, device=dev),
                torch.zeros(4, dtype=torch.bool, device=dev),
                torch.tensor(0, dtype=torch.int32, device=dev)]
    return {"main_65_lanes": (lanes(65, 3, 33, 8, 3), 10.0),
            "live_9_lanes": (lanes(9, 3, 9, 8, 0), 10.0),
            "planted_ties_gate": (tuple(planted), 5.0),
            "m_eff_0": (lanes(65, 3, 0, 8, 5), 10.0),
            "T8_K5_65_lanes": (lanes(65, 5, 65, 8, 0), 10.0),
            "T16_K20_all_live": (lanes(40, 20, 40, 16, 0), 15.0),
            "T16_K20_grid_ties": (lanes(40, 20, 40, 16, 0, grid=True), 6.0),
            "offline_600_lanes": (lanes(600, 3, 600, 8, 0), 10.0),
            "offline_600_lanes_T16_K20": (lanes(600, 20, 600, 16, 0, grid=True), 6.0),
            "m_eff_s1_minus_1": (lanes(65, 3, 64, 8, 3), 10.0),
            "m_eff_past_s1": (lanes(65, 3, 80, 8, 3), 10.0)}


def k6_live(args) -> int:
    return max(0, min(int(args[4]), args[0].shape[0]))


def k6_bytes(args) -> int:
    """Inputs of the live lanes only (a dead lane's paths are never read),
    every output column, the carry both ways and m_eff."""
    s1, k_n = args[0].shape
    t_n = args[5].shape[0]
    return k6_live(args) * k_n * 13 + s1 * t_n * 13 + 2 * (t_n * 9 + 4) + 4


def streaming_phase(np, torch, sd, nnls, tmp, angles, raw_live, raw_ds, raw_straddle, kernels,
                    dev):
    """Phase 6: the five streams on the card, checked and timed."""
    import traceback
    import warnings

    from slam_process_tpu_torch.ops.correct import correct_frames_np
    from slam_process_tpu_torch.ops.decode import decode_frames_np
    from slam_process_tpu_torch.ops.scene import intensity_grid_np
    from slam_process_tpu_torch.pipeline.session import Session

    live_spec = sd.make_paths_spec(angles, s_step=8)
    ds_spec = sd.make_paths_spec(angles, s_step=64)

    def feed(raw, chunk, device=dev, stop=None, **kw):
        s = sd.DeviceStreamingSession(chunk_bytes=chunk, device=device, **kw)
        for off in range(0, len(raw) if stop is None else stop, chunk):
            s.feed(raw[off:off + chunk])
        return s

    def live_feed(device=dev):
        s = feed(raw_live, LIVE_CHUNK, device, collect_filtered=True,
                 collect_paths=live_spec)
        s.finalize()
        return s

    def dataset_replay():
        return sd.replay_log_device(raw_ds, chunk_bytes=REPLAY_CHUNK, collect_filtered=True,
                                    collect_paths=ds_spec, device=dev)

    def straddle(device=dev):
        s = feed(raw_straddle, STRADDLE_CHUNK, device, collect_filtered=True)
        s.finalize()
        return s

    def dataset_grow():
        """The dataset as a live stream with the default emit ring: it
        starts at 2^18 rows and must grow in place to hold the stream."""
        s = feed(raw_ds, REPLAY_CHUNK, collect_filtered=True)
        s.finalize()
        return s

    def resumed():
        half = (len(raw_live) // LIVE_CHUNK // 2) * LIVE_CHUNK
        s = feed(raw_live, LIVE_CHUNK, stop=half, collect_filtered=True,
                 collect_paths=live_spec)
        s.save_checkpoint(tmp / "live.ckpt", extra={"offset": half})
        r = sd.DeviceStreamingSession.restore(tmp / "live.ckpt", device=dev)
        if r.checkpoint_extra != {"offset": half}:
            fail("checkpoint: extra did not round-trip")
        for off in range(half, len(raw_live), LIVE_CHUNK):
            r.feed(raw_live[off:off + LIVE_CHUNK])
        r.finalize()
        return r

    for m in kernels.values():
        m.LAUNCHES = 0
    kernels["K7"].LAUNCHES_BY_K.clear()
    t0 = time.perf_counter()
    streams = {"live_feed": live_feed(), "dataset_replay": dataset_replay(),
               "straddle": straddle(), "checkpoint": resumed(), "dataset_grow": dataset_grow()}
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: m.LAUNCHES for k, m in kernels.items()}
    k7_by_k = dict(kernels["K7"].LAUNCHES_BY_K)
    if min(launches[k] for k in ("K1", "K2", "K4", "K5", "K6", "K7")) == 0:
        fail(f"a kernel of the streaming path never launched: {launches}")
    # Two K5 calls per window (K1 decodes once per window: the carry, and one
    # fused call for the kept rows), and the fused one at each stream's flush.
    if launches["K5"] != 2 * launches["K1"] + len(streams):
        fail(f"streams: {launches['K5']} K5 calls in {launches['K1']} windows and "
             f"{len(streams)} flushes, not two per window and one per flush")

    raw_of ={"live_feed": raw_live, "dataset_replay": raw_ds, "straddle": raw_straddle,
              "checkpoint": raw_live, "dataset_grow": raw_ds}
    spec_of = {"live_feed": live_spec, "dataset_replay": ds_spec, "checkpoint": live_spec}
    cpu = {"live_feed": live_feed("cpu"), "straddle": straddle("cpu")}
    cpu["checkpoint"] = cpu["live_feed"]
    offline, summary = {}, {}
    for name, s in streams.items():
        raw = raw_of[name]
        frames = decode_frames_np(raw).frames
        want = correct_frames_np(frames).filtered
        if s.overflow or s.n_frames != len(frames) or s.n_kept != len(want):
            fail(f"stream {name}: overflow, or frame / kept counts differ from the host engine")
        if not np.array_equal(s.filtered, want):
            fail(f"stream {name}: filtered differs from the host engine")
        grid, ours = intensity_grid_np(want[:, 0], want[:, 1], want[:, 2]), s.intensity()
        if not (np.array_equal(ours.counts, grid.counts)
                and np.array_equal(ours.mean, grid.mean, equal_nan=True)):
            fail(f"stream {name}: intensity differs from the host pivot")
        summary[name] = {"bytes": len(raw), "frames": s.n_frames, "kept": s.n_kept,
                         "groups": s.n_groups}
        if name in spec_of:
            key = "live" if raw is raw_live else name     # streams 1 and 4 share one log
            if key not in offline:
                spec = spec_of[name][0]
                off = Session(name)
                off.frames = frames
                beam_ids = (spec.ue_ids, spec.bs_ids)
                paths, valid = off.sweep_paths(angles, beam_ids=beam_ids, device=dev)
                offline[key] = ((paths, valid), off.sweep_times(len(valid)),
                                off.path_tracks(angles, beam_ids=beam_ids, engine="device",
                                                device=dev))
            bad = paths_differ(np, stream_readers(s), offline[key], exact=True)
            if bad:
                fail(f"stream {name}: {bad} differ from the offline Session on the card")
            p_valid = s.sweep_paths()[0].valid
            summary[name].update(sweeps=s.n_sweeps_closed, valid_paths=int(p_valid.sum()),
                                 tracks=int(s.path_tracks()[0].n_tracks))
        if name in cpu:
            c = cpu[name]
            if not (np.array_equal(s.filtered, c.filtered)
                    and np.array_equal(ours.mean, c.intensity().mean, equal_nan=True)):
                fail(f"stream {name}: filtered or intensity differ between cuda and cpu")
            if name in spec_of:
                bad = paths_differ(np, stream_readers(s), stream_readers(c), exact=False)
                if bad:
                    fail(f"stream {name}: {bad} differ between cuda and cpu")
    if streams["dataset_replay"].n_kept <= 1 << 18:
        fail("dataset replay: the emit ring did not hold more than 2^18 rows")
    if streams["dataset_grow"]._ecap <= 1 << 18:
        fail("dataset as a live stream: the emit ring did not grow past its 2^18 rows")

    # Throughput: CUDA events around feed + finalize + block_until_ready.
    def timed(fn):
        fn().block_until_ready()
        times = []
        for _ in range(N_STREAM_RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn().block_until_ready()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), times

    # Host syncs: every synchronizing call torch reports in sync debug mode
    # inside ``feed`` and ``finalize`` (the windows and the flush; not the
    # constructor), by the line that made it, against the counters.  A sync
    # the counters miss fails the run.
    def sync_sites(fn):
        cls = sd.DeviceStreamingSession
        plain = {n: getattr(cls, n) for n in ("feed", "finalize")}

        def watched(method):
            def call(self, *args):
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return method(self, *args)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            return call

        sites, notes = {}, {}

        def record(message, *_):
            """Each sync, by the innermost frame of the package's own code
            on the stack (and the innermost frame, when it lies elsewhere)."""
            stack = [f for f in traceback.extract_stack()[:-1]
                     if not f.filename.endswith("warnings.py")]
            if "synchroniz" not in str(message):
                return
            if stack[-1].name == "set_sync_debug_mode":     # torch's note on the mode itself
                notes[str(message)[:120]] = notes.get(str(message)[:120], 0) + 1
                return
            pkg = REPO / "slam_process_tpu_torch"
            ours = [f for f in stack if Path(f.filename).is_relative_to(pkg)]
            key = "outside the package"
            if ours:
                f = ours[-1]
                key = f"{Path(f.filename).relative_to(REPO)}:{f.lineno} {(f.line or '').strip()}"
            if not ours or stack[-1] is not ours[-1]:
                key += f" via {Path(stack[-1].filename).name}:{stack[-1].lineno} {stack[-1].name}"
            sites[key] = sites.get(key, 0) + 1

        sd.HOST_SYNCS = nnls.HOST_SYNCS = 0
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            for n, method in plain.items():
                setattr(cls, n, watched(method))
            try:
                fn().block_until_ready()
            finally:
                for n, method in plain.items():
                    setattr(cls, n, method)
        return sites, notes, {"m_eff_reads": sd.HOST_SYNCS, "nnls": nnls.HOST_SYNCS}

    # Per-window host time, synchronized before and after each window, split
    # into full windows and the short ones (a feed of exactly chunk_bytes
    # leaves 20 bytes for a second, padded window, as in the JAX package).
    def window_ms(fn):
        step, rec = sd.DeviceStreamingSession._step, []

        def timed_step(self, chunk, n_bytes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(self, chunk, n_bytes)
            torch.cuda.synchronize()
            rec.append((n_bytes == self.chunk_bytes, (time.perf_counter() - t0) * 1e3))

        sd.DeviceStreamingSession._step = timed_step
        try:
            fn()
        finally:
            sd.DeviceStreamingSession._step = step
        out = {}
        for kind, full in (("full", True), ("short", False)):
            t = [ms for f, ms in rec if f == full]
            out[f"{kind}_windows"] = len(t)
            out[f"ms_per_{kind}_window_median"] = statistics.median(t) if t else None
            out[f"ms_per_{kind}_window_mean"] = statistics.fmean(t) if t else None
        return out

    timing = {}
    for name, fn in (("live_feed", live_feed), ("dataset_replay", dataset_replay),
                     ("straddle", straddle)):
        k1 = kernels["K1"].LAUNCHES
        sites, notes, counted = sync_sites(fn)
        windows = kernels["K1"].LAUNCHES - k1
        synced = sum(sites.values())
        if synced != sum(counted.values()):
            fail(f"stream {name}: {synced} host syncs in sync debug mode, the counters say "
                 f"{counted}: {sites}")
        if synced:     # every window reads nothing back, with paths too (K7)
            fail(f"stream {name}: {synced} host syncs in feed / finalize, not 0: {sites}")
        timing[name] = {"windows": windows, "host_syncs": synced, "host_sync_sites": sites,
                        "sync_debug_mode_notes": notes,
                        "host_syncs_per_window": {k: v / windows for k, v in counted.items()}}
        if name == "straddle":
            continue
        ms, runs = timed(fn)
        b, f = summary[name]["bytes"], summary[name]["frames"]
        timing[name].update({"ms": ms, "runs_ms": runs, "ms_per_window": ms / windows,
                             "bytes_per_s": b / (ms / 1e3), "frames_per_s": f / (ms / 1e3),
                             "sweeps_per_s": summary[name]["sweeps"] / (ms / 1e3),
                             "window_host_ms": window_ms(fn)})
    for m in kernels.values():
        m.LAUNCHES = 0
    names = {"K1": "decode_rows_kernel", "K4": "sweep_sums_kernel", "K5": "compact_kernel",
             "K6": "track_block_kernel", "K7": "nnls_kernel"}
    busy, acts, top, named = device_profile(torch, lambda: live_feed().block_until_ready(),
                                            count=tuple(names.values()))
    calls = {k: kernels[k].LAUNCHES for k in names}
    if [named[n] for n in names.values()] != list(calls.values()):
        fail(f"live feed: device kernels {named} differ from the wrapper calls {calls}")
    timing["live_feed"].update(device_busy_ms=busy,
                               device_busy_share=busy / timing["live_feed"]["ms"],
                               device_activities=acts, top_us=top[:6],
                               windows_profiled=kernels["K1"].LAUNCHES,
                               wrapper_calls=calls, device_kernels=named)
    return {"seconds": run_s, "launches": launches, "k7_by_k": k7_by_k, "streams": summary,
            "compared_with_cpu": sorted(cpu), "timing": timing,
            "emit_ring_rows": {k: streams[k]._ecap for k in ("dataset_replay", "dataset_grow")}}


def stream_readers(s):
    return s.sweep_paths(), s.sweep_times(), s.path_tracks()


def paths_differ(np, a, b, exact):
    """Names of the paths readers' fields that differ: (sweep_paths,
    sweep_times, path_tracks) of two sources; power within rtol 2e-4 unless
    ``exact``."""
    (pa, va), ta, (tra, tta, vela) = a
    (pb, vb), tb, (trb, ttb, velb) = b
    bad = [n for n, x, y in (("sweep_valid", va, vb), ("sweep_times", ta, tb),
                             ("track_times", tta, ttb)) if not np.array_equal(x, y)]
    fields = [(f"paths.{n}", getattr(pa, n), getattr(pb, n)) for n in pb._fields]
    fields += [(f"tracks.{n}", getattr(tra, n), getattr(trb, n)) for n in (
        "pos_aoa", "pos_aod", "power", "observed", "created")]
    for n, x, y in fields:
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape:
            bad.append(n)
        elif n.endswith("power") and not exact:
            if not np.allclose(x, y, rtol=2e-4, atol=1e-6):
                bad.append(n)
        elif not np.array_equal(x, y):
            bad.append(n)
    if int(tra.n_tracks) != int(trb.n_tracks):
        bad.append("n_tracks")
    if exact and not all(np.array_equal(x, y) for x, y in zip(vela, velb)):
        bad.append("velocities")
    return bad


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


# -- the stream axis: a multi-stream round's kernel calls, the batch, the streams --

MULTI_CHUNK = REPLAY_CHUNK           # the 19 streams' window: the replay cell's
MULTI_WRAPPERS = {"K1s": ("cuda_decode", "decode_rows_streams_cuda"),
                  "K2": ("cuda_correct", "correct_verdicts_cuda"),
                  "K4": ("cuda_sweep_sums", "sweep_sums_cuda"),
                  "K5s": ("cuda_compact", "compact_rows_streams_cuda"),
                  "K6s": ("cuda_tracker", "track_block_streams_cuda")}


def multi_round_inputs(sd, raws, dev, spec, ecap):
    """{key: [(args, kwargs), ...]} of the wrapper calls in the first round
    of a ``MultiStreamingSession`` over ``raws`` (one stream each, each
    shorter than a window) at 1 MiB windows with ``collect_paths``, run by
    its eager halves (``eager_rounds``): K1, K2, K4, K5 (the carry, then the
    kept rows), K6."""
    import importlib

    pkg = sd.__name__.split(".")[0]
    mods = {k: (importlib.import_module(f"{pkg}.ops.{m}"), a) for k, (m, a) in
            MULTI_WRAPPERS.items()}
    calls = {k: [] for k in mods}
    originals = {k: getattr(mod, attr) for k, (mod, attr) in mods.items()}

    def recorder(key):
        def call(*args, **kw):
            calls[key].append((args, kw))
            return originals[key](*args, **kw)
        return call

    for key, (mod, attr) in mods.items():
        setattr(mod, attr, recorder(key))
    try:
        ms = eager_rounds(sd.MultiStreamingSession(len(raws), chunk_bytes=MULTI_CHUNK,
                                                   collect_paths=spec, emit_capacity=ecap,
                                                   device=dev))
        ms.feed(raws)
    finally:
        for key, (mod, attr) in mods.items():
            setattr(mod, attr, originals[key])
    got = {k: len(c) for k, c in calls.items()}
    if got != {"K1s": 1, "K2": 1, "K4": 1, "K5s": 2, "K6s": 1}:
        fail(f"multi-stream round: wrapper calls {got}, not one per stage (K5 twice)")
    return calls


def recorded_calls(mod, attr, fn) -> list:
    """The (args, kwargs) of every call of ``mod.attr`` while ``fn()`` runs."""
    calls, original = [], getattr(mod, attr)

    def call(*args, **kw):
        calls.append((args, kw))
        return original(*args, **kw)

    setattr(mod, attr, call)
    try:
        fn()
    finally:
        setattr(mod, attr, original)
    return calls


def k1s_calls(torch, sd, dev, angles, multi=None) -> dict:
    """{name: (bytes [S, N], limits int64 [S] or None)}: K1's stream-axis
    calls where the package makes them, recorded from the wrapper of the
    ``slam_process_tpu_torch`` that ``sd`` belongs to: grids of several
    waves of blocks, ``streams_19_1MiB``, the 19 dataset streams' first 1
    MiB round (from ``multi``, ``multi_round_inputs``, or a round run here),
    and ``batch_<S>x<N>``, ``run_dataset``'s largest bucket group over phase
    4's 21 sessions; grids of one wave, ``streams_19_64KiB``, the 19
    streams' second 64 KiB round (the steady round), ``S1_full_session``
    (the full session's padded bytes, as ``run_session_on_device`` decodes
    them) and ``S1_64KiB_window`` (the live feed's second full 64 KiB
    window)."""
    import importlib

    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes

    pkg = sd.__name__.split(".")[0]
    cuda_decode = importlib.import_module(f"{pkg}.ops.cuda_decode")
    batch = importlib.import_module(f"{pkg}.parallel.batch")
    device = importlib.import_module(f"{pkg}.pipeline.device")
    raws_ds = [synthetic_session_bytes(**c) for c in DATASET]
    raw_full, raw_mp = synthetic_session_bytes(**FULL), synthetic_session_bytes(**MULTIPATH)
    spec = sd.make_paths_spec(angles, s_step=64)
    ecap = -(-(max(len(r) for r in raws_ds) // 11 + 1) // (1 << 16)) * (1 << 16)
    if multi is None:
        multi = multi_round_inputs(sd, raws_ds, dev, spec, ecap)
    out = {"streams_19_1MiB": tuple(multi["K1s"][0][0][:2])}
    with eager_batch(batch):
        calls = recorded_calls(cuda_decode, "decode_rows_streams_cuda",
                               lambda: batch.run_dataset(None, [raw_full, *raws_ds, raw_mp]))
    b, lim = max((c[0][:2] for c in calls), key=lambda c: c[0].numel())
    out[f"batch_{b.shape[0]}x{b.shape[1]}"] = (b, lim)

    feeds = [one_round_feeds(r, LIVE_CHUNK, sd.CARRY_BYTES)[:2] for r in raws_ds]
    ms = eager_rounds(sd.MultiStreamingSession(len(raws_ds), chunk_bytes=LIVE_CHUNK,
                                               collect_paths=spec, emit_capacity=ecap, device=dev))
    calls = recorded_calls(cuda_decode, "decode_rows_streams_cuda",
                           lambda: [ms.feed([f[k] for f in feeds]) for k in range(2)])
    out["streams_19_64KiB"] = tuple(calls[-1][0][:2])
    padded = torch.from_numpy(device.pad_bytes(raw_full, device.bucket_size(len(raw_full))))
    out["S1_full_session"] = (padded.to(dev)[None], None)
    (b, lim, *_), _ = stream_window_inputs(sd, raw_mp, LIVE_CHUNK, dev)["K1"]
    out["S1_64KiB_window"] = (b[None], torch.tensor([lim], dtype=torch.int64, device=dev))
    for name, (b, lim) in out.items():
        if b.dtype != torch.uint8 or b.dim() != 2 or not b.is_contiguous():
            fail(f"K1s {name}: recorded bytes are not a contiguous uint8 [S, N]")
    return out


def stream_axis_cases(np, torch, dev, exact, decode, compact, correct, scene, tracker,
                      cuda_decode, cuda_compact, cuda_correct, cuda_sweep_sums, cuda_tracker,
                      multi, k6, k1s):
    """The stream-axis kernels (K1, K5, K6) against their plain versions,
    and the flattened K2 and K4 calls against S separate kernel calls, at
    the multi-stream round's shapes (``multi``: ``multi_round_inputs``), at
    K1's recorded calls (``k1s``: ``k1s_calls``) and on edge cases."""
    from slam_process_tpu_torch.utils.synthetic import decode_stream_cases, track_stream_cases

    def bits(xs):
        """Float tensors as their int32 bits (NaN equal to the same NaN)."""
        return tuple(x.view(torch.int32) if x.is_floating_point() else x for x in xs)

    # K1: the 19 streams' window, twice on one stream (the S ticket words
    # reset); ragged limits; widths at the row blocks' edges; S = 1.
    (b, lim, ft, ff), _ = multi["K1s"][0]
    for rep in range(2):
        exact("K1s", f"19_streams_1MiB_call_{rep}", cuda_decode.decode_rows_streams_cuda(
            b, lim, ft, ff), decode.decode_rows_streams_plain(b, n_valid=lim))
    ragged = (lim - torch.arange(lim.numel(), device=dev) * 4099).clamp(min=0)
    exact("K1s", "19_streams_ragged_limits", cuda_decode.decode_rows_streams_cuda(
        b, ragged, ft, ff), decode.decode_rows_streams_plain(b, n_valid=ragged))
    gen = torch.Generator().manual_seed(8)
    for s_n, n in ((3, 0), (5, 11), (4, 2816), (4, 2827), (2, 11 * 1024 + 3), (1, 5121)):
        bb = torch.randint(0, 256, (s_n, n), generator=gen, dtype=torch.uint8).to(dev)
        bb[:, ::13] = 0xCC
        exact("K1s", f"S{s_n}_N{n}", cuda_decode.decode_rows_streams_cuda(bb, None, ft, ff),
              decode.decode_rows_streams_plain(bb))
    # K1 on the stream-axis calls the package makes (the batch's largest
    # bucket, the 1 MiB and 64 KiB rounds, the S = 1 calls); the seeded stream cases
    # (ragged limits of 0, mid-frame, exactly n and past n; n = 2^20 - 5,
    # a multiple of neither 11 nor 16; one stream of 19.9 MB, S = 1); a view
    # at an odd byte offset; a multi-wave call captured in a CUDA graph and
    # replayed twice, its S ticket words zero after each replay.
    for name, (bb, ll) in k1s.items():
        exact("K1s", f"recorded_{name}", cuda_decode.decode_rows_streams_cuda(bb, ll, ft, ff),
              decode.decode_rows_streams_plain(bb, n_valid=ll))
    # (The seeded cases' plain versions run on the same inputs on the host:
    # on the card their temporaries would stay cached in this process.)
    seeded = decode_stream_cases()
    plain = {}
    for name, (bn, ln) in seeded.items():
        lc = None if ln is None else torch.from_numpy(ln)
        plain[name] = decode.decode_rows_streams_plain(torch.from_numpy(bn), n_valid=lc)
        exact("K1s", f"seeded_{name}", cuda_decode.decode_rows_streams_cuda(
            torch.from_numpy(bn).to(dev), None if lc is None else lc.to(dev), ft, ff),
            plain[name])
    bn, ln = seeded["ragged_limits"]
    ll = torch.from_numpy(ln).to(dev)
    want = plain["ragged_limits"]
    flat = torch.zeros(bn.size + 16, dtype=torch.uint8, device=dev)
    bb = flat[1:1 + bn.size].view(bn.shape)
    bb.copy_(torch.from_numpy(bn))
    exact("K1s", "unaligned_view_19_streams_1MiB", cuda_decode.decode_rows_streams_cuda(
        bb, ll, ft, ff), want)
    del flat, bb
    bb = torch.from_numpy(bn).to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_decode.decode_rows_streams_cuda(bb, ll, ft, ff)      # its scratch, before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = cuda_decode.decode_rows_streams_cuda(bb, ll, ft, ff)
    tickets = cuda_decode.tickets_for(bb.device, side.cuda_stream, bb.shape[0])
    for rep in range(2):
        for t in got:
            t.fill_(1)
        graph.replay()
        torch.cuda.synchronize()
        exact("K1s", f"graph_replay_{rep}_19_streams_1MiB", got, want)
        if int(tickets.count_nonzero()) != 0:
            fail(f"K1s graph replay {rep}: the ticket words are not left zero")
    del graph, got

    # K5: the round's two calls (the carry; the emit rings + the paths'
    # buffers at the rings' counts), then rings that fill and the race test
    # at S > 1.
    for i, ((rows, mask, dests), _) in enumerate(multi["K5s"]):
        def fresh(ds):
            return [(c, None if o is None else o.clone(), off) for c, o, off in ds]
        got_o, got_n = cuda_compact.compact_rows_streams_cuda(rows, mask, fresh(dests))
        want_o, want_n = compact.compact_rows_streams_plain(rows, mask, fresh(dests))
        exact("K5s", ["carry_19_streams", "emit_and_paths_19_streams"][i], (*got_o, got_n),
              (*want_o, want_n))
    (rows, mask, dests), _ = multi["K5s"][1]
    cap, ring, off = dests[0]
    for case, o2 in (("offsets_at_capacity", torch.full_like(off, cap)),
                     ("rings_fill", (off + cap - int(mask.sum(dim=1).max()) // 2).clamp(max=cap))):
        ds = [(cap, ring.clone(), o2), (rows.shape[1], None, None)]
        got_o, got_n = cuda_compact.compact_rows_streams_cuda(rows, mask, ds)
        want_o, want_n = compact.compact_rows_streams_plain(
            rows, mask, [(cap, ring.clone(), o2), (rows.shape[1], None, None)])
        exact("K5s", case, (*got_o, got_n), (*want_o, want_n))
    empty = torch.zeros((3, 0, 5), dtype=torch.int32, device=dev)
    got_o, got_n = cuda_compact.compact_rows_streams_cuda(
        empty, torch.zeros((3, 0), dtype=torch.bool, device=dev), [(GCAP, None, None)])
    want_o, want_n = compact.compact_rows_streams_plain(
        empty.cpu(), torch.zeros((3, 0), dtype=torch.bool), [(GCAP, None, None)])
    exact("K5s", "no_rows", (*got_o, got_n), (*want_o, want_n))
    # S = 2 and 64 (one chunk a block at S = 2, chunks of several tiles at
    # 64): rings at nonzero offsets that overflow, and a zero-tailed buffer
    # smaller than the masked count.
    for s_n, f in ((2, 70_000), (64, 9_000)):
        gen_s = torch.Generator(device=dev).manual_seed(40 + s_n)
        rows = torch.randint(-(1 << 30), 1 << 30, (s_n, f, 5), generator=gen_s,
                             dtype=torch.int32, device=dev)
        mask = torch.rand((s_n, f), generator=gen_s, device=dev) < 0.4
        cap = f // 3
        ring = torch.randint(0, 9, (s_n, cap, 5), generator=gen_s, dtype=torch.int32,
                             device=dev)
        offs = torch.randint(0, cap + 1, (s_n,), generator=gen_s, dtype=torch.int32,
                             device=dev)
        got_o, got_n = cuda_compact.compact_rows_streams_cuda(
            rows, mask, [(cap, ring.clone(), offs), (f // 4, None, None)])
        want_o, want_n = compact.compact_rows_streams_plain(
            rows, mask, [(cap, ring.clone(), offs), (f // 4, None, None)])
        if not bool((offs + want_n > cap).any()) or int(want_n.max()) <= f // 4:
            fail(f"K5s S{s_n}_overflow_offsets: no destination overflows")
        exact("K5s", f"S{s_n}_overflow_offsets", (*got_o, got_n), (*want_o, want_n))
    f = 1 << 20
    gen_d = torch.Generator(device=dev).manual_seed(9)
    rows = torch.randint(-(1 << 30), 1 << 30, (4, f, 5), generator=gen_d, dtype=torch.int32,
                         device=dev)
    mask = torch.rand((4, f), generator=gen_d, device=dev) < 0.5
    ring = torch.zeros((4, f, 5), dtype=torch.int32, device=dev)
    offs = torch.tensor([0, 7, 12_345, f // 3], dtype=torch.int32, device=dev)
    dests = [((1 << 19) + 777, None, None), (f, ring, offs)]
    (first, first_ring), n = cuda_compact.compact_rows_streams_cuda(rows, mask, dests)
    first, first_ring = first.clone(), first_ring.clone()
    (want, want_ring), n_want = compact.compact_rows_streams_plain(
        rows, mask, [((1 << 19) + 777, None, None), (f, torch.zeros_like(ring), offs)])
    exact("K5s", "4_streams_1M_rows_50pct", (first, first_ring, n), (want, want_ring, n_want))
    for rep in range(100):
        (got, got_ring), n_got = cuda_compact.compact_rows_streams_cuda(rows, mask, dests)
        if not (torch.equal(got, first) and torch.equal(got_ring, first_ring)
                and torch.equal(n_got, n)):
            fail(f"K5s 4_streams_1M_rows_50pct: repetition {rep} differs from the first")

    # K6: the round's 19 trackers; K6's single-stream cases of one shape as
    # the streams of one call (65 lanes: 33 live, m_eff 0, s1 - 1, past s1).
    args6, kw6 = multi["K6s"][0]
    exact("K6s", "19_streams_65_lanes", cuda_tracker.track_block_streams_cuda(*args6, **kw6),
          tracker.track_block_streams_plain(*args6, **kw6))
    names = ("main_65_lanes", "m_eff_0", "m_eff_s1_minus_1", "m_eff_past_s1")
    stacked = tuple(torch.stack([k6[n][0][j] for n in names]) for j in range(8))
    exact("K6s", "4_streams_of_the_K6_cases", cuda_tracker.track_block_streams_cuda(
        *stacked, 10.0), tracker.track_block_streams_plain(*stacked, 10.0))
    big = tuple(torch.stack([k6[n][0][j] for n in ("T16_K20_all_live", "T16_K20_all_live")])
                for j in range(8))
    exact("K6s", "2_streams_T16_K20", cuda_tracker.track_block_streams_cuda(*big, 15.0),
          tracker.track_block_streams_plain(*big, 15.0))
    # Chains over several staging tiles, T = 16 with K = 20 at m_eff 0, s1 -
    # 1, s1 and past s1, planted ties and a NaN cost: bit for bit (the plain
    # version's lane loop on the same inputs on the host, where it is fast).
    for name, (*arrays, gate) in track_stream_cases().items():
        args = [torch.from_numpy(a) for a in arrays]
        exact("K6s", f"seeded_{name}",
              bits(cuda_tracker.track_block_streams_cuda(*(a.to(dev) for a in args), gate)),
              bits(tracker.track_block_streams_plain(*args, gate)))

    # K2 flattened: the round's one call (19 streams' rows, ids offset by
    # s * max_groups) against 19 calls of the single-stream kernel; and tiny
    # sessions, whose 256-row blocks span up to five sessions' groups.
    (gid, clk, packed), kw2 = multi["K2"][0]
    g_n = packed.shape[0] // 19
    flat = cuda_correct.correct_verdicts_cuda(gid, clk, packed, **kw2)
    per = gid.numel() // 19
    sep = [cuda_correct.correct_verdicts_cuda(
        (gid[i * per:(i + 1) * per] - i * g_n).contiguous(), clk[i * per:(i + 1) * per].contiguous(),
        packed[i * g_n:(i + 1) * g_n].contiguous(), **kw2) for i in range(19)]
    exact("K2", "flattened_19_streams_vs_19_calls", flat,
          tuple(torch.cat([s[j] for s in sep]) for j in range(3)))
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes
    tiny = [synthetic_session_bytes(n_groups=1 + i % 3, frames_per_beam=1, baselines_per_group=2,
                                    junk_frac=0.1, seed=500 + i) for i in range(12)]
    width = max(len(r) for r in tiny)
    tb = torch.zeros((12, width), dtype=torch.uint8)
    for i, r in enumerate(tiny):
        tb[i, :len(r)] = torch.from_numpy(r)
    frames, valid, _ = decode.decode_rows_streams(tb.to(dev))
    gid_t, packed_t, _ = correct.baseline_table(frames, valid, 8, 16)
    args_t = dict(bmax=16, cycle=61_000, tol=500)
    flat = cuda_correct.correct_verdicts_cuda(gid_t.reshape(-1).contiguous(),
                                              frames[..., 4].reshape(-1).contiguous(), packed_t,
                                              **args_t)
    sep = [cuda_correct.correct_verdicts_cuda(
        (gid_t[i] - i * 8).contiguous(), frames[i, :, 4].contiguous(),
        packed_t[i * 8:(i + 1) * 8].contiguous(), **args_t) for i in range(12)]
    exact("K2", "flattened_12_tiny_sessions_blocks_span_sessions", flat,
          tuple(torch.cat([s[j] for s in sep]) for j in range(3)))

    # K4 flattened: the round's one call over 19 s1 sweep lanes (ids offset
    # by s * s1) against 19 calls of s1 lanes.
    (p, bs4, val, s_all, nb4), _ = multi["K4"][0]
    s1 = s_all // 19
    flat = cuda_sweep_sums.sweep_sums_cuda(p, bs4, val, s_all, nb4)
    per = p.numel() // 19
    sep = []
    for i in range(19):
        pi = p[i * per:(i + 1) * per]
        pi = torch.where(pi >= 0, pi - i * s1 * nb4, -1).contiguous()
        sep.append(cuda_sweep_sums.sweep_sums_cuda(pi, bs4[i * per:(i + 1) * per].contiguous(),
                                                   val[i * per:(i + 1) * per].contiguous(), s1,
                                                   nb4))
    exact("K4", "flattened_19_streams_vs_19_calls", flat,
          tuple(torch.cat([s[j] for s in sep]) for j in range(2)))


def batch_phase(np, torch, raws, zero_counts, read_counts, raster_close, cuda_ms, dev) -> dict:
    """Phase 17: ``parallel/batch.run_dataset`` over the 21 sessions of phase
    4 in both forms, on the card: field for field equal to the per-session
    ``run_session_on_device`` on the card (rasters bit-equal), the vmap form
    against ``device="cpu"`` under the raster bounds, K1, K2 and K3 once per
    bucket group in the vmap form; sessions/s of vmap, scan and the
    per-session loop."""
    from slam_process_tpu_torch.parallel import batch
    from slam_process_tpu_torch.pipeline.device import bucket_size, run_session_on_device

    groups = len({bucket_size(len(r)) for r in raws})
    out, launches = {}, {}
    for axis in ("vmap", "scan"):
        zero_counts()
        out[axis] = batch.run_dataset(None, raws, session_axis=axis)
        torch.cuda.synchronize()
        launches[axis] = read_counts()
    if not all(launches["vmap"][k] == groups for k in ("K1", "K2", "K3")):
        fail(f"batch: the vmap form launched {launches['vmap']} for {groups} bucket groups, "
             "not K1, K2 and K3 once per group")
    if not all(launches["scan"][k] == len(raws) for k in ("K1", "K2", "K3")):
        fail(f"batch: the scan form launched {launches['scan']}, not once per session")
    singles = [run_session_on_device(r, device=dev) for r in raws]
    fields = batch.SessionSummaryOut._fields
    for i, one in enumerate(singles):
        for axis in ("vmap", "scan"):
            got = out[axis][i]
            for f in fields:
                want = getattr(one, f).cpu().numpy()
                g = getattr(got, f)
                if g.dtype != want.dtype or g.shape != want.shape or g.tobytes() != want.tobytes():
                    fail(f"batch {axis}: session {i} {f} differs from run_session_on_device")
        if out["vmap"][i].correct_overflow or int(out["vmap"][i].n_kept) == 0:
            fail(f"batch: session {i} overflowed or kept nothing")
    t0 = time.perf_counter()
    cpu = batch.run_dataset(None, raws, device="cpu")
    cpu_s = time.perf_counter() - t0
    for i, (g, c) in enumerate(zip(out["vmap"], cpu)):
        for f in ("n_frames", "correct_overflow", "n_kept", "counts", "mean_grid"):
            if not np.array_equal(getattr(g, f), getattr(c, f), equal_nan=True):
                fail(f"batch: session {i} {f} differs between cuda and cpu")
        raster_close("batch", f"session_{i}_cuda_vs_cpu",
                     tuple(torch.from_numpy(getattr(g, f))[None] for f in (
                         "rgba", "norm_t", "blurred")),
                     tuple(torch.from_numpy(getattr(c, f))[None] for f in (
                         "rgba", "norm_t", "blurred")), bit_equal=False)

    def loop():
        outs = [run_session_on_device(r, device=dev) for r in raws]
        torch.cuda.synchronize()
        return outs

    ms = {"vmap": cuda_ms(lambda: batch.run_dataset(None, raws), primed=False),
          "scan": cuda_ms(lambda: batch.run_dataset(None, raws, session_axis="scan"),
                          primed=False),
          "per_session_loop": cuda_ms(loop, primed=False)}
    return {"sessions": len(raws), "bucket_groups": groups, "launches": launches["vmap"],
            "launches_scan": launches["scan"], "compared_with": ["run_session_on_device", "cpu"],
            "cpu_seconds": cpu_s, "ms": ms,
            "sessions_per_s": {k: len(raws) / (v / 1e3) for k, v in ms.items()},
            "frames": int(sum(int(o.n_frames) for o in out["vmap"]))}


def multi_stream_phase(np, torch, sd, nnls, tmp, angles, raws, zero_counts, read_counts,
                       dev) -> dict:
    """Phase 18: the 19 dataset-scale sessions as 19 streams of one
    ``MultiStreamingSession`` at 1 MiB windows with ``collect_paths`` (s_step
    64, K = 3, T = 8) and a fixed emit ring, on the card: each stream against
    its own ``DeviceStreamingSession`` on the card, exactly; a ragged
    finalize with a reset and a checkpoint resume at 256 KiB windows; then
    ``watch --logs`` on three growing captures against ``--device cpu``.
    Ms per round, bytes/s, the device's busy share and the host syncs per
    round under ``torch.cuda.set_sync_debug_mode``; ms per steady round at
    64 KiB windows (``steady_rounds``)."""
    import traceback
    import warnings

    spec = sd.make_paths_spec(angles, s_step=64)
    ecap = -(-(max(len(r) for r in raws) // 11 + 1) // (1 << 16)) * (1 << 16)

    def run_multi():
        ms = sd.MultiStreamingSession(len(raws), chunk_bytes=MULTI_CHUNK, collect_paths=spec,
                                      emit_capacity=ecap, device=dev)
        ms.feed(raws)
        ms.finalize()
        return ms

    rounds, blocks = [], []
    step, count_blocks = sd.MultiStreamingSession._window, sd._WindowRound._blocks
    sd.MultiStreamingSession._window = lambda self, *a: rounds.append(1) or step(self, *a)
    sd._WindowRound._blocks = lambda self, mid: blocks.append(count_blocks(self, mid)) or blocks[-1]
    try:
        zero_counts()
        t0 = time.perf_counter()
        ms = run_multi().block_until_ready()
        run_s = time.perf_counter() - t0
        launches = read_counts()
    finally:
        sd.MultiStreamingSession._window = step
        sd._WindowRound._blocks = count_blocks
    if min(launches[k] for k in ("K1", "K2", "K4", "K5", "K6")) == 0:
        fail(f"multi_stream: a kernel never launched: {launches}")
    if launches["K1"] != len(rounds) or launches["K6"] != len(rounds) + 1 or \
            launches["K5"] != 2 * len(rounds) + 1:
        fail(f"multi_stream: {launches} in {len(rounds)} rounds and one flush, not one launch "
             "per stage (K5 twice) for all 19 streams")
    # The block form: one estimator call per 8-lane block, each of its
    # NN-OMP iterations one K7 launch.
    s1, iters = spec[0].s_step + 1, spec[0].est_key[1].max_paths
    k7_want = sum(len(sd._lane_groups(n, s1, False)) for n in blocks) * iters
    if launches["K7"] != k7_want or len(blocks) != len(rounds) + 1:
        fail(f"multi_stream: K7 launched {launches['K7']} times for blocks {blocks}, not "
             f"{k7_want} (a launch per block and NN-OMP iteration)")

    def single(raw, chunk=MULTI_CHUNK, **kw):
        s = sd.DeviceStreamingSession(chunk_bytes=chunk, collect_filtered=True,
                                      emit_capacity=ecap, device=dev, **kw)
        for off in range(0, len(raw), chunk):
            s.feed(raw[off:off + chunk])
        s.finalize()
        return s

    def check(m, i, s, what):
        nf, nk, ng, sums, counts, ovf = m.results()
        if ovf[i] or (nf[i], nk[i], ng[i]) != (s.n_frames, s.n_kept, s.n_groups):
            fail(f"multi_stream {what}: stream {i}'s counts differ from its single stream")
        if not (np.array_equal(sums[i], s._state.sums.cpu().numpy())
                and np.array_equal(counts[i], s._state.counts.cpu().numpy())
                and np.array_equal(m.stream_filtered(i), s.filtered)):
            fail(f"multi_stream {what}: stream {i}'s sums or filtered rows differ")
        if m._paths_spec is not None:
            got = (m.stream_paths(i), m.stream_tracks(i)[1], m.stream_tracks(i))
            bad = paths_differ(np, got, stream_readers(s), exact=True)
            if bad:
                fail(f"multi_stream {what}: stream {i}'s {bad} differ from its single stream")

    sweeps = 0
    for i, raw in enumerate(raws):
        s = single(raw, collect_paths=spec)
        check(ms, i, s, "19 streams")
        sweeps += s.n_sweeps_closed

    # Ragged: stream 0 ends after 256 KiB and is finalized alone, its slot
    # reset for stream 3's bytes; a checkpoint resume; 256 KiB windows.
    small, chunk = raws[:3], 1 << 18
    m = sd.MultiStreamingSession(3, chunk_bytes=chunk, collect_paths=spec, emit_capacity=ecap,
                                 device=dev)
    m.feed([small[0][:chunk], small[1][:chunk], small[2][:chunk]])
    m.finalize_streams([0])
    check(m, 0, single(small[0][:chunk], chunk, collect_paths=spec), "ragged first tenant")
    m.reset_streams([0])
    m.save_checkpoint(tmp / "multi.npz", extra={"at": chunk})
    r = sd.MultiStreamingSession.restore(tmp / "multi.npz", device=dev)
    if r.checkpoint_extra != {"at": chunk}:
        fail("multi_stream: the checkpoint's extra did not round-trip")
    rest = [raws[3], small[1][chunk:], small[2][chunk:]]
    for x in (m, r):
        for off in range(0, max(len(y) for y in rest), chunk):
            x.feed([y[off:off + chunk] for y in rest])
        x.finalize()
    for i, raw in enumerate((raws[3], small[1], small[2])):
        s = single(raw, chunk, collect_paths=spec)
        check(m, i, s, "ragged + reset")
        check(r, i, s, "checkpoint resume")

    # Throughput: CUDA events around the whole feed + finalize, median of 5
    # after a warm-up; then the host syncs by source line in sync debug mode
    # against the counters, and the device busy share under the profiler.
    times = []
    run_multi().block_until_ready()
    for _ in range(N_STREAM_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_multi().block_until_ready()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    run_ms = statistics.median(times)
    n_bytes = sum(len(x) for x in raws)

    sites = {}

    def record(message, *_):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if not f.filename.endswith("warnings.py")]
        if stack[-1].name == "set_sync_debug_mode":
            return
        pkg = REPO / "slam_process_tpu_torch"
        ours = [f for f in stack if Path(f.filename).is_relative_to(pkg)]
        key = (f"{Path(ours[-1].filename).relative_to(REPO)}:{ours[-1].lineno}" if ours
               else "outside the package")
        sites[key] = sites.get(key, 0) + 1

    ms_sync = sd.MultiStreamingSession(len(raws), chunk_bytes=MULTI_CHUNK, collect_paths=spec,
                                       emit_capacity=ecap, device=dev)
    torch.cuda.synchronize()
    sd.HOST_SYNCS = nnls.HOST_SYNCS = 0
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ms_sync.feed(raws)
            ms_sync.finalize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counted = {"m_eff_reads": sd.HOST_SYNCS, "nnls": nnls.HOST_SYNCS}
    if sum(sites.values()) != sum(counted.values()):
        fail(f"multi_stream: {sum(sites.values())} host syncs in sync debug mode, the counters "
             f"say {counted}: {sites}")
    if counted != {"m_eff_reads": len(rounds) + 1, "nnls": 0}:
        fail(f"multi_stream: host syncs {counted} in {len(rounds)} rounds and a flush, not "
             "one count read a round and flush and no NNLS sync")
    busy, acts, top = device_profile(torch, lambda: run_multi().block_until_ready())

    steady = steady_rounds(np, torch, sd, raws, spec, ecap, check, dev)
    watch = multi_watch_check(np, torch, tmp, angles, dev)
    n_rounds = len(rounds)
    return {"first_run_s": run_s, "launches": launches, "blocks_per_round_and_flush": blocks,
            "streams": len(raws), "rounds": n_rounds,
            "flushes": 1, "bytes": n_bytes, "sweeps": sweeps, "emit_ring_rows": ecap,
            "compared_with": ["19 DeviceStreamingSession on the card", "ragged + reset",
                              "checkpoint resume", "watch --logs vs --device cpu"],
            "ms": run_ms, "runs_ms": times, "ms_per_round_and_flush": run_ms / (n_rounds + 1),
            "bytes_per_s": n_bytes / (run_ms / 1e3),
            "single_stream_equivalent_windows": n_rounds * len(raws),
            "host_syncs": sum(sites.values()), "host_sync_sites": sites,
            "host_syncs_per_round_and_flush": {k: v / (n_rounds + 1) for k, v in counted.items()},
            "device_busy_ms": busy, "device_busy_share": busy / run_ms,
            "device_activities": acts, "top_us": top[:6], "steady_64KiB": steady,
            "watch": watch}


def one_round_feeds(raw, chunk, carry):
    """``raw`` as feeds of one window each: ``chunk`` bytes first, then
    ``chunk - carry`` (the carried bytes complete the window)."""
    out = [raw[:chunk]]
    for off in range(chunk, len(raw), chunk - carry):
        out.append(raw[off:off + chunk - carry])
    return out


def steady_rounds(np, torch, sd, raws, spec, ecap, check, dev) -> dict:
    """The 19 streams at 64 KiB windows (the live feed's chunk), one round
    a feed, so that every round after the first carries open groups, open
    sweeps and ring offsets from the round before: ms per round from CUDA
    events around each feed, the median over the rounds in which every
    stream fed a full window, over ``N_STREAM_RUNS`` runs after a warm-up;
    one single stream fed the same windows, timed the same way, in the
    same call.  Each stream of the last run equals its own
    ``DeviceStreamingSession`` fed the same windows, exactly."""
    chunk = LIVE_CHUNK
    feeds = [one_round_feeds(r, chunk, sd.CARRY_BYTES) for r in raws]
    n_feeds = max(len(f) for f in feeds)
    full = [k for k in range(1, n_feeds)
            if all(k < len(f) and len(f[k]) == chunk - sd.CARRY_BYTES for f in feeds)]

    def timed(session, rounds):
        events = []
        for pieces in rounds:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            session.feed(pieces)
            end.record()
            events.append((start, end))
        session.finalize()
        session.block_until_ready()
        return [a.elapsed_time(b) for a, b in events]

    def multi_run():
        m = sd.MultiStreamingSession(len(raws), chunk_bytes=chunk, collect_paths=spec,
                                     emit_capacity=ecap, device=dev)
        t = timed(m, [[f[k] if k < len(f) else b"" for f in feeds] for k in range(n_feeds)])
        return m, [t[k] for k in full]

    def single_run(i):
        s = sd.DeviceStreamingSession(chunk_bytes=chunk, collect_filtered=True,
                                      emit_capacity=ecap, collect_paths=spec, device=dev)
        t = timed(s, feeds[i])
        return s, [t[k] for k in full if k < len(t)]

    multi_run()
    single_run(0)
    multi_ms, single_ms = [], []
    for _ in range(N_STREAM_RUNS):
        m, t = multi_run()
        multi_ms += t
        single_ms += single_run(0)[1]
    for i in range(len(raws)):
        check(m, i, single_run(i)[0], "64 KiB rounds")
    round_ms = statistics.median(multi_ms)
    window_ms = statistics.median(single_ms)
    return {"window_bytes": chunk, "streams": len(raws), "rounds": n_feeds,
            "steady_rounds_per_run": len(full), "runs": N_STREAM_RUNS,
            "ms_per_round": round_ms, "ms_per_round_min_max": [min(multi_ms), max(multi_ms)],
            "bytes_per_s": len(raws) * (chunk - sd.CARRY_BYTES) / (round_ms / 1e3),
            "single_stream_ms_per_window": window_ms,
            "single_stream_bytes_per_s": (chunk - sd.CARRY_BYTES) / (window_ms / 1e3),
            "single_windows_per_round_time": round_ms / window_ms}


def multi_watch_check(np, torch, tmp, angles, dev) -> dict:
    """``watch --logs A B C --paths --changes --events`` on the card over
    three captures that a writer thread grows in turn (each piece after the
    watch read the one before), the PNGs left out, against the same command
    with ``--device cpu`` on the finished files: the filtered xlsx byte for
    byte, the track and change tables, the events of each session."""
    import json
    import threading

    from slam_process_tpu_torch.pipeline import cli
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, to_hex_text

    work = tmp / "multi_watch"
    texts = [to_hex_text(synthetic_session_bytes(n_groups=(2, 5, 6)[i], frames_per_beam=12,
                                                 baselines_per_group=40, junk_frac=0.02,
                                                 seed=400 + i, n_paths=3)) for i in range(3)]

    def open_watch(tag, logs, *extra):
        args = cli.build_parser().parse_args(
            ["watch", "--logs", *map(str, logs), "--mapping", str(angles), "--outdir",
             str(work / tag), "--paths", "--changes", "--events", str(work / f"{tag}.jsonl"),
             "--poll-interval", "0.02", "--idle-timeout", "0.5", *extra])
        if not cli.check_watch_flags(args):
            fail("watch --logs: three files did not make a multi-stream watch")
        return cli.MultiWatch(args)

    def finish(w):
        w.run()
        return [w.render(i) for i in range(3)], w.export()

    logs = []
    for i in range(3):
        (work / "card" / f"c{i}").mkdir(parents=True)
        logs.append(work / "card" / f"c{i}" / "capture.txt")
        logs[-1].write_bytes(b"")
    w = open_watch("card_out", logs)
    consumed = threading.Event()
    read_growth = w._read_growth
    fed = []

    def paced_read(i):
        data = read_growth(i)
        if data is not None:
            fed.append(i)
            consumed.set()
        return data

    def grow():
        """A piece for each live capture, then wait until the watch has read
        them.  Capture 0 ends first; the others then grow by small pieces
        until it has idled out and been finalized alone, then to their
        ends."""
        rng = np.random.default_rng(301)
        offs = [0] * len(texts)
        while any(o < len(t) for o, t in zip(offs, texts)):
            for i, (log, text) in enumerate(zip(logs, texts)):
                if offs[i] >= len(text):
                    continue
                top = 200 if offs[0] >= len(texts[0]) and not zero_done.is_set() else 12_000
                n = int(rng.integers(1, top))
                with open(log, "ab") as f:
                    f.write(text[offs[i]:offs[i] + n])
                offs[i] += n
            if not consumed.wait(timeout=120):
                return
            consumed.clear()

    early, zero_done = [None], threading.Event()
    finalize_streams = w.session.finalize_streams

    def watched_finalize(indices):
        if early[0] is None and list(indices) == [0] and not w.session._stream_finalized[1:].any():
            early[0] = [int(i) for i in indices]
        out = finalize_streams(indices)
        zero_done.set()
        return out

    w._read_growth = paced_read
    w.session.finalize_streams = watched_finalize
    writer = threading.Thread(target=grow)
    writer.start()
    try:
        card_render, card_sum = finish(w)
    finally:
        consumed.set()
        writer.join(timeout=120)
    if writer.is_alive():
        fail("watch --logs: the writer did not finish")
    cpu_logs = []
    for i, text in enumerate(texts):
        (work / "cpu" / f"c{i}").mkdir(parents=True)
        cpu_logs.append(work / "cpu" / f"c{i}" / "capture.txt")
        cpu_logs[-1].write_bytes(text)
    cpu_render, cpu_sum = finish(open_watch("cpu_out", cpu_logs, "--device", "cpu"))

    def events(tag):
        by = {}
        for ln in (work / f"{tag}.jsonl").read_text().splitlines():
            e = json.loads(ln)
            by.setdefault(e["session"], []).append(e)
        return by

    ev_card, ev_cpu = events("card_out"), events("cpu_out")
    if sorted(ev_card) != sorted(ev_cpu) or not ev_card:
        fail(f"watch --logs: sessions with events differ: {sorted(ev_card)} / {sorted(ev_cpu)}")
    for name in ev_card:
        a, b = ev_card[name], ev_cpu[name]
        strip = [[{k: v for k, v in e.items() if k != "power"} for e in x] for x in (a, b)]
        if strip[0] != strip[1] or not np.allclose([e["power"] for e in a],
                                                   [e["power"] for e in b], rtol=RTOL):
            fail(f"watch --logs: {name}'s events differ between cuda and cpu")
    names = [x["session"] for x in card_sum[:3]]
    for name in names:
        if not xlsx_same(work / "card_out" / f"{name}_filtered.xlsx",
                         work / "cpu_out" / f"{name}_filtered.xlsx"):
            fail(f"watch --logs: {name}'s filtered xlsx differs between cuda and cpu")
        for table, ints in (("stream_tracks", {"Track", "Sweep", "CLK"}),
                            ("stream_changes", {"Sweep", "CLK", "Kind", "Track"})):
            why = xlsx_close(np, work / "card_out" / f"{name}_{table}.xlsx",
                             work / "cpu_out" / f"{name}_{table}.xlsx", ints)
            if why:
                fail(f"watch --logs: {name}'s {table} differs between cuda and cpu in {why}")
    strip = [[{k: v for k, v in x.items() if k != "png"} for x in s] for s in (card_sum, cpu_sum)]
    if strip[0] != strip[1]:
        fail(f"watch --logs: summaries differ: {strip}")
    for i, (a, b) in enumerate(zip(card_render, cpu_render)):
        why = rendered_differ(np, a, b)[0]
        if why:
            fail(f"watch --logs: stream {i}'s render differs between cuda and cpu: {why}")
    if early[0] is None:
        fail("watch --logs: capture 0 was not finalized while the others were live")
    return {"captures": len(texts), "bytes": [len(t) for t in texts], "polls_fed": len(fed),
            "finalized_alone": early[0],
            "summary": card_sum, "events": sum(len(v) for v in ev_card.values())}



# -- mesh and multihost -----------------------------------------------------------------

def same_results(a, b) -> bool:
    """Equal nested results: numpy arrays by dtype, shape and bytes (floats
    bitwise), tuples and lists item by item, other values by ==."""
    import numpy as np

    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(same_results(x, y) for x, y in zip(a, b)))
    return a == b


def stream_results(ms, n) -> tuple:
    """A multi-stream session's per-stream readers: results, closed-sweep
    counts, filtered rows, paths and tracks of streams 0..n-1."""
    return (ms.results(), ms.n_sweeps_closed_all(),
            [(ms.stream_filtered(i), ms.stream_paths(i), ms.stream_tracks(i)) for i in range(n)])


def event_ms(torch, fn, runs: int = 5) -> float:
    """Median ms of ``fn`` over ``runs`` CUDA-event-timed calls after one
    warm-up, the host work included (each call ends in a host read)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def mesh_forms(np, torch, sd, angles, raws, sessions, dev) -> dict:
    """{form: (call(mesh), meshes)}: the mesh forms of phase 19, each with
    the meshes it runs on (positions repeating cuda:0; distinct cards too
    where the machine has more than one)."""
    from slam_process_tpu_torch.models.batch_estimation import estimate_sessions
    from slam_process_tpu_torch.parallel import batch
    from slam_process_tpu_torch.parallel.mesh import make_mesh
    from slam_process_tpu_torch.pipeline.session import sweep_paths_dataset

    c0 = [torch.device(dev.type, 0)]
    meshes = {"(1, 1)": make_mesh((1, 1), devices=c0), "(4, 1)": make_mesh((4, 1), devices=c0 * 4),
              "(2, 2)": make_mesh((2, 2), devices=c0 * 4)}
    n_dev = torch.cuda.device_count()
    if n_dev > 1:
        meshes[f"({n_dev}, 1) distinct"] = make_mesh((n_dev, 1))
        meshes[f"({n_dev // 2}, 2) distinct"] = make_mesh((n_dev // 2, 2),
                                                          devices=make_mesh((n_dev, 1)).devices.flat)
    distinct = [k for k in meshes if "distinct" in k]
    ds = raws[DS]
    spec = sd.make_paths_spec(angles, s_step=64)
    ecap = -(-(max(len(r) for r in ds) // 11 + 1) // (1 << 16)) * (1 << 16)

    def streams(mesh):
        ms = sd.MultiStreamingSession(len(ds), chunk_bytes=MULTI_CHUNK, collect_paths=spec,
                                      emit_capacity=ecap, mesh=mesh,
                                      device=None if mesh is not None else dev)
        ms.feed(ds)
        ms.finalize()
        return stream_results(ms, len(ds))

    def on(mesh, **kw):
        return dict(mesh=mesh) if mesh is not None else dict(device=dev, **kw)

    forms = {
        "run_dataset": (lambda m: batch.run_dataset(m, raws, **({} if m is not None else
                                                                 dict(device=dev))),
                        ["(1, 1)", "(4, 1)", "(2, 2)"] + distinct),
        "sweep_paths_multipath": (lambda m: sessions[MP].sweep_paths(angles, **on(m)),
                                  ["(2, 2)"] + distinct),
        "sweep_paths_dataset": (lambda m: sweep_paths_dataset(sessions, angles, **on(m)),
                                ["(2, 2)"] + distinct),
        "estimate_sessions_multipath": (lambda m: estimate_sessions([sessions[MP]], angles,
                                                                    **on(m)),
                                        ["(2, 2)"] + distinct),
        "estimate_sessions": (lambda m: estimate_sessions(sessions, angles, **on(m)),
                              ["(2, 2)"] + distinct),
        "multi_stream_19": (streams, ["(4, 1)"] + distinct),
    }
    return {name: (fn, {k: meshes[k] for k in keys}) for name, (fn, keys) in forms.items()}


def mesh_phase(np, torch, sd, angles, raws, sessions, zero_counts, read_counts, dev) -> dict:
    """Phase 19: the mesh forms on the card (``mesh_forms``): ``run_dataset``
    over the 21 sessions at (1, 1), (4, 1) and (2, 2);
    ``Session.sweep_paths`` of the multipath session, ``sweep_paths_dataset``
    and ``estimate_sessions`` of the multipath session and of the 21 at
    (2, 2); the 19 dataset streams of ``MultiStreamingSession`` at (4, 1),
    padded to 20 (1 MiB windows, ``collect_paths``): each equal to
    ``mesh=None`` on the card, every field, floats bitwise.  The mesh runs
    alone are counted (``launches``); then ms of each form beside
    ``mesh=None`` (CUDA events, median of 5 after a warm-up)."""
    forms = mesh_forms(np, torch, sd, angles, raws, sessions, dev)
    want = {name: fn(None) for name, (fn, _) in forms.items()}
    torch.cuda.synchronize()
    zero_counts()
    got = {(name, key): fn(m) for name, (fn, meshes) in forms.items()
           for key, m in meshes.items()}
    torch.cuda.synchronize()
    launches = read_counts()
    if min(launches.values()) == 0:
        fail(f"mesh: a kernel never launched on the mesh forms: {launches}")
    for (name, key), out in got.items():
        if not same_results(out, want[name]):
            fail(f"mesh: {name} on the {key} mesh differs from mesh=None")
    n_streams = len(want["multi_stream_19"][2])
    if forms["multi_stream_19"][1]["(4, 1)"].shape["data"] != 4 or n_streams != len(DATASET):
        fail("mesh: the 19 streams were not run on four data shards")
    ms = {name: {"mesh=None": event_ms(torch, lambda: fn(None)),
                 **{key: event_ms(torch, lambda m=m: fn(m)) for key, m in meshes.items()}}
          for name, (fn, meshes) in forms.items()}
    return {"cuda_device_count": torch.cuda.device_count(),
            "compared": sorted(f"{n} {k}" for n, k in got), "launches": launches, "ms": ms,
            "ms_over_mesh_none": {n: {k: v / t["mesh=None"] for k, v in t.items()
                                      if k != "mesh=None"} for n, t in ms.items()}}


MULTIHOST_WORKER = r'''"""One process of chip_smoke.py's multihost phase (two processes, gloo on
127.0.0.1, two mesh positions each, on the process's CUDA device).

Usage: python <this file> <repo> <mode> <pid> <nproc> <host:port> <out.npz> <angles.xlsx>
       <json>

mode "sessions" (json: the synthetic configs and stream parameters):
run_batched_multihost over four dataset sessions (model = 2),
estimate_sessions_multihost of the same four (grid 0.5, model = 2) and a
MultihostMultiStream over the 19 dataset sessions split 10 / 9; writes this
process's results to out.npz.  mode "watch" (json: the watch's argv): one
process of ``cli watch --coordinator``, its steps without the PNGs.
Prints one JSON line: the process id, its kernel launches and, for the
watch, its summary lines.
"""
import json
import sys
from pathlib import Path


def main():
    repo, mode, pid, nproc, coord = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
        int(sys.argv[4]), sys.argv[5]
    out, angles, arg = Path(sys.argv[6]), sys.argv[7], json.loads(sys.argv[8])
    sys.path.insert(0, repo)
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    from slam_process_tpu_torch.parallel import multihost as mh
    from slam_process_tpu_torch.parallel._dryrun_worker import launch_counts

    if mode == "watch":
        from slam_process_tpu_torch.pipeline import cli

        args = cli.build_parser().parse_args(arg)
        cli.check_watch_flags(args)
        w = cli.MultihostWatch(args)
        try:
            w.run()
            lines = w.export()
        finally:
            w.close()
        print(json.dumps({"pid": pid, "lines": lines, "launches": launch_counts()}), flush=True)
        return

    from slam_process_tpu_torch.parallel.streaming_device import make_paths_spec
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, to_hex_text

    mh.initialize_multihost(coord, nproc, pid, 2, device=arg["device"])
    res = {}
    mine = slice(2 * pid, 2 * pid + 2)
    raws = [synthetic_session_bytes(**c) for c in arg["batch"]][mine]
    got = mh.run_batched_multihost(mh.global_data_mesh(model=2), raws)
    for f in got._fields:
        res["batch_" + f] = mh.local_shard(getattr(got, f))
    sessions = []
    for k, raw in enumerate(raws):
        path = out.parent / f"p{pid}_{k}.txt"
        path.write_bytes(to_hex_text(raw))
        sessions.append(Session.from_log(path, device=arg["device"]))
    got = mh.estimate_sessions_multihost(sessions, angles, mh.global_data_mesh(model=2),
                                         grid_res=0.5)
    for f in got._fields:
        res["est_" + f] = mh.local_shard(getattr(got, f))
    streams = [synthetic_session_bytes(**c) for c in arg["streams"]]
    local = list(range(10)) if pid == 0 else list(range(10, len(streams)))
    s = mh.MultihostMultiStream(mh.global_data_mesh(model=1), len(local),
                                chunk_bytes=arg["chunk"],
                                collect_paths=make_paths_spec(angles, s_step=64),
                                emit_capacity=arg["ecap"])
    s.feed([streams[i] for i in local])
    s.finalize()
    for k, x in enumerate(s.local_results()):
        res[f"stream_results_{k}"] = x
    res["stream_closed"] = s.n_sweeps_closed_all()
    for k in range(len(local)):
        res[f"stream_filtered_{k}"] = s.local_stream_filtered(k)
        paths, valid = s.local_stream_paths(k)
        for f in paths._fields:
            res[f"stream_paths_{k}_{f}"] = np.asarray(getattr(paths, f))
        res[f"stream_valid_{k}"] = valid
        tracks, times, _ = s.local_stream_tracks(k)
        res[f"stream_times_{k}"] = times
        for f in ("pos_aoa", "pos_aod", "power", "observed", "created"):
            res[f"stream_tracks_{k}_{f}"] = np.asarray(getattr(tracks, f))
    launches = launch_counts()
    mh.shutdown_multihost()
    np.savez(out, **res)
    print(json.dumps({"pid": pid, "local_streams": local, "launches": launches}), flush=True)


if __name__ == "__main__":
    main()
'''

GRAPH_TIMED = 20                     # event-timed session calls per median in the graphs phase


def graphs_phase(np, torch, sd, tmp, raws, paths, angles, zero_counts, read_counts, dev,
                 smi) -> dict:
    """Phase 21: the compiled programs as CUDA graphs against their eager
    bodies on the card, then eager against graph in time.

    Exactness, floats bit for bit: ``compiled_session_pipeline`` on two
    sessions of one bucket alternated (the full and the multipath session;
    two dataset-scale sessions), each call against ``session_pipeline``;
    ``compiled_text_session_pipeline`` on their shipped-layout text against
    ``session_pipeline_from_text``; the pre-log program against the eager
    pre-log body (integer fields exactly, means within one float32 ulp:
    float64 atomics); the window graph of a stream without paths against
    the eager round (``eager_windows``), the whole state after the feed and
    after the flush: the live feed (the multipath log in 64 KiB feeds), the
    straddle (the full session at 16 KiB) and the 19 dataset logs replayed at
    1 MiB (a short last window); the paths window graph against the eager
    round after every feed and after the flush: the live feed with s_step 8
    and the replay with s_step 64.  Each replay adds its capture's launches to
    the counters (checked: one K1, K2 and K3 a session call).

    Times (the card's name and power limit printed beside them): per session
    program, eager and graph, wall ms (CUDA events around the call on device
    inputs, host work included, median of ``GRAPH_TIMED`` after a warm-up),
    frames/s, device ms (``utils/device_timing.measure_device_time``, median
    of 3, one profiler window each) and device activities a call; each
    graph's capture ms and pool bytes; the entry point
    ``run_session_on_device`` on the full session; ms per window of the live
    feed and the replay, eager and graph (CUDA events around feed, finalize
    and ``block_until_ready``, median of 5 after a warm-up) and the windows
    whose staging copy made the host wait; with paths also the device ms a
    window (``measure_device_time`` over whole streams, median of 3);
    ``cli.replay_stream`` as the command runs it (64 KiB windows, the
    multipath log; with and without ``--paths``, each window a graph
    replay), timed the same way."""

    from slam_process_tpu_torch.ops.tokenize import prepare_text, stride3_offset, text_bucket
    from slam_process_tpu_torch.pipeline import cli
    from slam_process_tpu_torch.pipeline.device import (
        bucket_size, compiled_session_pipeline, compiled_text_session_pipeline, device_lut,
        pad_bytes, run_session_on_device, session_pipeline, session_pipeline_from_text)
    from slam_process_tpu_torch.utils.device_timing import (
        measure_device_time, op_device_counts, op_device_times)
    from slam_process_tpu_torch.utils.synthetic import to_hex_text

    lut = device_lut(dev)
    counted = ("K1", "K2", "K3")

    def wall_ms(fn, n=GRAPH_TIMED):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device(fn, name, per_run=False):
        """Device ms (median of 3 runs) and activities a run of ``fn()``, or
        of ``fn(i)`` for runs i = 0, 1, 2 with ``per_run``."""
        trace = tmp / f"graphs_trace_{name}"
        t = measure_device_time(fn if per_run else (lambda i: fn()), n=3, trace_dir=trace)
        acts = sum(op_device_counts(trace).values()) / 3
        shutil.rmtree(trace, ignore_errors=True)
        return t.median * 1e3, acts

    def replayed(fn, calls):
        """Each call of a graph program against its eager body, and the
        launches each replay adds."""
        for call, want in calls:
            before = read_counts()
            got = call()
            after = read_counts()
            if any(after[k] - before[k] != 1 for k in counted):
                fail(f"graphs: a replay added {[after[k] - before[k] for k in counted]} K1-K3 "
                     "launches, not one each")
            yield got, want()

    zero_counts()
    sessions = {}
    # The full and the multipath session share the full bucket; two
    # dataset-scale sessions of one bucket.
    ds = [i for i in range(1, len(raws) - 1)]
    ds_pair = next((i, j) for i in ds for j in ds if i < j
                   and bucket_size(len(raws[i])) == bucket_size(len(raws[j])))
    for scale, (a, b) in (("full", (0, len(raws) - 1)), ("dataset", ds_pair)):
        n = bucket_size(len(raws[a]))
        if bucket_size(len(raws[b])) != n:
            fail(f"graphs: sessions {a} and {b} are not in one bucket")
        frames = [int(np.count_nonzero(run_session_on_device(raws[i], device=dev).frame_valid
                                       .cpu().numpy())) for i in (a, b)]
        padded = [torch.from_numpy(pad_bytes(raws[i], n)).to(dev) for i in (a, b)]
        fn = compiled_session_pipeline(n, device=dev)
        fn(padded[0], lut)                                   # captured here, if not before
        for got, want in replayed(fn, [(lambda k=k: fn(padded[k], lut),
                                        lambda k=k: session_pipeline(padded[k], lut))
                                       for k in (0, 1, 0, 1)]):
            bad = outputs_differ(torch, got, want)
            if bad:
                fail(f"graphs {scale}: the session graph differs from the eager body in {bad}")
        texts = [to_hex_text(raws[i], "shipped") for i in (a, b)]
        m = max(text_bucket(len(t) - stride3_offset(t)) for t in texts)
        bodies = []
        for t in texts:
            body, n_text = prepare_text(t, stride3_offset(t), m)
            bodies.append((torch.from_numpy(body).to(dev), n_text))
        fn_t = compiled_text_session_pipeline(m, device=dev)
        fn_t(*bodies[0], lut)
        for got, want in replayed(fn_t, [(lambda k=k: fn_t(*bodies[k], lut),
                                          lambda k=k: session_pipeline_from_text(*bodies[k], lut))
                                         for k in (0, 1, 0, 1)]):
            bad = outputs_differ(torch, got.out, want.out)
            if bad or not (bool(got.tokenize_regular) and int(got.n_tokens) == int(want.n_tokens)):
                fail(f"graphs {scale}: the text graph differs from the eager body in {bad} or "
                     "its token count")
        timed = {}
        for kind, g_call, e_call, prog in (
                ("bytes", lambda: fn(padded[0], lut), lambda: session_pipeline(padded[0], lut),
                 fn),
                ("text", lambda: fn_t(*bodies[0], lut),
                 lambda: session_pipeline_from_text(*bodies[0], lut), fn_t)):
            row = {}
            for form, call in (("eager", e_call), ("graph", g_call)):
                ms = wall_ms(call)
                dev_ms, acts = device(call, f"{scale}_{kind}_{form}")
                row[form] = {"wall_ms": ms, "frames_per_s": frames[0] / (ms / 1e3),
                             "device_ms": dev_ms, "device_activities": acts}
            row.update(capture_ms=prog.runner.capture_ms, pool_bytes=prog.runner.pool_bytes,
                       wall_ratio_graph_over_eager=row["graph"]["wall_ms"]
                       / row["eager"]["wall_ms"])
            timed[kind] = row
        sessions[scale] = {"bytes": len(raws[a]), "bucket": n, "text_bucket": m,
                           "frames": frames[0], **timed}
    sessions["full"]["run_session_on_device_wall_ms"] = wall_ms(
        lambda: run_session_on_device(raws[0], device=dev))

    # The pre-log program: one float32 ulp (float64 atomics add in no order).
    n = bucket_size(len(raws[0]))
    padded = torch.from_numpy(pad_bytes(raws[0], n)).to(dev)
    fn_log = compiled_session_pipeline(n, device=dev, log_transform_scene=True)
    for _ in range(3):
        got = fn_log(padded, lut)
        want = session_pipeline(padded, lut, log_transform_scene=True)
        bad = outputs_differ(torch, got, want, [f for f in want._fields
                                                 if f not in ("mean_grid", "rgba", "blurred",
                                                              "norm_t", "n_discarded")])
        ulps = ulps_apart(np, got.mean_grid.cpu().numpy(), want.mean_grid.cpu().numpy())
        if bad or not 0 <= ulps <= 1:
            fail(f"graphs prelog: {bad} differ, or the means are {ulps} ulps apart")

    # Streams without paths: graph against the eager round, state bit for bit.
    raw_ds = np.concatenate([raws[i] for i in ds])
    n_kept_max = len(raw_ds) // 11 + 1

    def stream(raw, chunk, eager=False, replay=False, spec=None):
        kw = dict(chunk_bytes=chunk, collect_filtered=True, collect_paths=spec, device=dev)
        if replay:
            if eager:
                s = eager_windows(sd, sd.DeviceStreamingSession(
                    emit_capacity=-(-n_kept_max // (1 << 16)) * (1 << 16), **kw))
                for off in range(0, len(raw), chunk):
                    s.feed(raw[off:off + chunk])
                s.finalize()
                return s
            return sd.replay_log_device(raw, **kw)
        s = sd.DeviceStreamingSession(**kw)
        if eager:
            eager_windows(sd, s)
        for off in range(0, len(raw), chunk):
            s.feed(raw[off:off + chunk])
        s.finalize()
        return s

    def same_state(a, b):
        la, lb = sd._leaves(a._state), sd._leaves(b._state)
        return len(la) == len(lb) and all(
            x.dtype == y.dtype and x.shape == y.shape
            and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
            for x, y in zip(la, lb))

    def stream_ms(fn):
        fn().block_until_ready()
        times = []
        for _ in range(N_STREAM_RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn().block_until_ready()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    streams = {}
    for name, raw, chunk, replay in (("live_64KiB", raws[-1], LIVE_CHUNK, False),
                                     ("straddle_16KiB", raws[0], STRADDLE_CHUNK, False),
                                     ("replay_1MiB", raw_ds, REPLAY_CHUNK, True)):
        k1 = read_counts()["K1"]
        got = stream(raw, chunk, replay=replay)
        windows = read_counts()["K1"] - k1
        want = stream(raw, chunk, eager=True, replay=replay)
        if not same_state(got, want) or got._graph is None or got._graph.replays < 1:
            fail(f"graphs {name}: the window graph's state differs from the eager round's "
                 "(or no window replayed)")
        streams[name] = {"bytes": len(raw), "windows": windows,
                         "graph_replays": got._graph.replays,
                         "capture_ms": got._graph.capture_ms,
                         "pool_bytes": got._graph.pool_bytes}
        if name == "straddle_16KiB":
            continue
        row = {}
        for form, eager in (("eager", True), ("graph", False)):
            waits = sd.STAGING_WAITS
            ms = stream_ms(lambda: stream(raw, chunk, eager=eager, replay=replay))
            row[form] = {"ms": ms, "ms_per_window": ms / windows,
                         "bytes_per_s": len(raw) / (ms / 1e3),
                         "staging_waits_per_window": (sd.STAGING_WAITS - waits)
                         / (windows * (N_STREAM_RUNS + 1))}
        streams[name].update(row, window_ratio_graph_over_eager=row["graph"]["ms"]
                             / row["eager"]["ms"])

    # Streams with paths (the live feed at 64 KiB with s_step 8, the 19 logs
    # replayed at 1 MiB with s_step 64): graph windows and eager windows fed
    # side by side, the whole state equal after every feed and after the
    # flush; then wall and device ms a window, eager and graph.
    paths_streams = {}
    for name, raw, chunk, replay, s_step in (
            ("live_paths_64KiB", raws[-1], LIVE_CHUNK, False, 8),
            ("replay_paths_1MiB", raw_ds, REPLAY_CHUNK, True, 64)):
        spec = sd.make_paths_spec(angles, s_step=s_step)
        kw = dict(chunk_bytes=chunk, collect_filtered=True, collect_paths=spec, device=dev)
        if replay:
            kw["emit_capacity"] = -(-n_kept_max // (1 << 16)) * (1 << 16)
        k1 = read_counts()["K1"]
        got = sd.DeviceStreamingSession(**kw)
        want = eager_windows(sd, sd.DeviceStreamingSession(**kw))
        feeds = 0
        for off in range(0, len(raw), chunk):
            got.feed(raw[off:off + chunk])
            want.feed(raw[off:off + chunk])
            feeds += 1
            if not same_state(got, want):
                fail(f"graphs {name}: the paths window graph's state differs from the eager "
                     f"round's after feed {feeds}")
        got.finalize()
        want.finalize()
        windows = read_counts()["K1"] - k1
        if (not same_state(got, want) or got._graph is None or got._graph.replays < 1
                or got.n_sweeps_closed < 1):
            fail(f"graphs {name}: the state differs after the flush, or no window replayed, "
                 "or no sweep closed")
        row = {"bytes": len(raw), "windows_each": windows // 2, "feeds_compared": feeds,
               "sweeps": got.n_sweeps_closed, "graph_replays": got._graph.replays,
               "capture_ms": got._graph.capture_ms, "pool_bytes": got._graph.pool_bytes}
        n_win = windows // 2
        for form, eager in (("eager", True), ("graph", False)):
            def run_stream(eager=eager):
                return stream(raw, chunk, eager=eager, replay=replay, spec=spec)

            ms = stream_ms(run_stream)
            dev_ms, acts = device(lambda: run_stream().block_until_ready(), f"{name}_{form}")
            row[form] = {"ms": ms, "ms_per_window": ms / n_win,
                         "device_ms_per_window": dev_ms / n_win,
                         "device_activities_per_window": acts / n_win,
                         "bytes_per_s": len(raw) / (ms / 1e3)}
        row["window_ratio_graph_over_eager"] = row["graph"]["ms"] / row["eager"]["ms"]
        paths_streams[name] = row

    # cli.replay_stream as the command runs it: the multipath log at the
    # command's 64 KiB windows, timed as the streaming phase times streams.
    replay = {}
    for tag, extra in (("default", []), ("paths", ["--paths"])):
        args = cli.build_parser().parse_args(
            ["replay", "--logs", str(paths[-1]), "--mapping", str(angles), "--outdir",
             str(tmp / "graphs_replay"), *extra])
        k1 = read_counts()["K1"]
        name, s, _ = cli.replay_stream(args, paths[-1])
        windows = read_counts()["K1"] - k1
        ms = stream_ms(lambda: cli.replay_stream(args, paths[-1])[1])
        replay[tag] = {"ms": ms, "windows": windows, "ms_per_window": ms / windows,
                       "frames_per_s": s.n_frames / (ms / 1e3),
                       "window_graph": s._graph is not None}
        if s._graph is None:
            fail(f"graphs: cli.replay_stream ({tag}) ran its windows eagerly")
    t0 = time.perf_counter()
    batch_out = batch_graphs(torch, raws, read_counts, wall_ms, device, dev)
    t1 = time.perf_counter()
    multi_out = multi_graphs(np, torch, sd, raws[DS], angles, device, dev)
    batch_out["seconds"], multi_out["seconds"] = t1 - t0, time.perf_counter() - t1
    return {"card": smi, "sessions": sessions, "streams": streams,
            "paths_streams": paths_streams, "cli_replay_stream_64KiB": replay,
            "batch": batch_out, "multi_stream": multi_out, "launches": read_counts()}


class EagerRunner:
    """``utils/graphs.GraphRunner``'s interface with the body run eagerly at
    every call: patched into ``parallel/batch.py``, the batch's eager
    comparator (same packing, same single host copy)."""

    def __init__(self, fn, inputs=(), device=None, pool=None):
        self._fn = fn

    def __call__(self, *inputs):
        return self._fn(*inputs)


def eager_batch(batch):
    """``parallel/batch.py`` with every program's body run eagerly (a
    context manager; the program cache is cleared on entry and exit).  A
    checkout from before the batch's graphs is eager already."""
    import contextlib

    @contextlib.contextmanager
    def patched():
        if not hasattr(batch, "GraphRunner"):
            yield
            return
        batch.batched_session_pipeline.cache_clear()
        graph_runner, batch.GraphRunner = batch.GraphRunner, EagerRunner
        try:
            yield
        finally:
            batch.GraphRunner = graph_runner
            batch.batched_session_pipeline.cache_clear()
    return patched()


def eager_rounds(ms):
    """``ms`` (a ``MultiStreamingSession``) with every shard's round run by
    its eager halves, ``_round_pre`` / ``_round_post``, in place of its CUDA
    graphs: the multi-stream graphs' comparator, and a session whose kernel
    calls can be recorded (a graph replay calls no wrapper).  A checkout
    from before these graphs is eager already and is returned as it is."""
    if not hasattr(ms, "_init_rounds"):
        return ms
    for sh in ms._shards:
        sh._pre = lambda sh=sh: sh._round_pre(sh._state, *sh._win_inputs())
        sh._post = lambda mid, nblk, sh=sh: None if mid is None else sh._round_post(
            sh._state, mid, nblk)
    return ms


def same_multi_state(torch, sd, a, b) -> bool:
    """Two multi-stream sessions' whole state, shard by shard, tensor for
    tensor, bit for bit."""
    la = [x for sh in a._shards for x in sd._leaves(sh._state)]
    lb = [x for sh in b._shards for x in sd._leaves(sh._state)]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def batch_graphs(torch, raws, read_counts, wall_ms, device, dev) -> dict:
    """Phase 21, the batch: ``batched_session_pipeline`` in both forms and
    both ``outputs``, the 21 sessions in their two buckets alternated, each
    call against the eager body (every field bit for bit) and adding K1, K2
    and K3 once per bucket (vmap) or session (scan); ``run_dataset`` against
    its eager bodies; then eager against graph: ``run_dataset`` wall ms,
    sessions/s and device ms, each graph's capture ms and pool bytes."""
    from slam_process_tpu_torch.parallel import batch
    from slam_process_tpu_torch.pipeline.device import bucket_size, device_lut

    lut = device_lut(dev)
    groups = {}
    for r in raws:
        groups.setdefault(bucket_size(len(r)), []).append(r)
    if len(groups) != 2:
        fail(f"graphs batch: the 21 sessions fall in {len(groups)} buckets, not 2")
    stacked = {b: batch.stack_sessions(rs, b) for b, rs in groups.items()}
    order = sorted(groups) * 2
    counted = ("K1", "K2", "K3")
    forms = {}
    for axis in ("vmap", "scan"):
        for outputs in ("full", "summary"):
            fns = {b: batch.batched_session_pipeline(None, b, outputs=outputs, session_axis=axis,
                                                     device=dev) for b in groups}
            for b in order:
                before = read_counts()
                got = fns[b](*stacked[b], lut)
                after = read_counts()
                per = 1 if axis == "vmap" else len(groups[b])
                if any(after[k] - before[k] != per for k in counted):
                    fail(f"graphs batch {axis} {outputs}: a call added "
                         f"{[after[k] - before[k] for k in counted]} K1-K3 launches, not {per}")
                want = fns[b]._body(torch.from_numpy(stacked[b][0]).to(dev), lut)
                bad = outputs_differ(torch, got, want)
                if bad:
                    fail(f"graphs batch {axis} {outputs}: bucket {b}'s graph differs from the "
                         f"eager body in {bad}")
            runners = [r for fn in fns.values() for _, r, _ in fn.runners.values()]
            forms[f"{axis}_{outputs}"] = {
                "replays": sum(r.replays for r in runners),
                "capture_ms": [r.capture_ms for r in runners],
                "pool_bytes": [r.pool_bytes for r in runners]}
    fns = {b: batch.batched_session_pipeline(None, b, outputs="summary", device=dev)
           for b in groups}
    want = {b: fns[b]._body(torch.from_numpy(stacked[b][0]).to(dev), lut) for b in groups}
    for _ in range(2):
        got = batch.run_dataset(None, raws)
        for i, r in enumerate(raws):
            b = bucket_size(len(r))
            row = [j for j, x in enumerate(groups[b]) if x is r][0]
            for f in batch.SessionSummaryOut._fields:
                g, w = getattr(got[i], f), getattr(want[b], f)[row].cpu().numpy()
                if g.dtype != w.dtype or g.shape != w.shape or g.tobytes() != w.tobytes():
                    fail(f"graphs batch: run_dataset session {i} {f} differs from the eager body")
    def call():
        return batch.run_dataset(None, raws)

    # Eager, graph, graph, eager: wall ms of each turn; device ms once each.
    turns = {"eager": [], "graph": []}
    timed = {}
    for form in ("eager", "graph", "graph", "eager"):
        if form == "eager":
            with eager_batch(batch):
                turns[form].append(wall_ms(call))
                if form not in timed:
                    timed[form] = device(call, "batch_eager")
        else:
            turns[form].append(wall_ms(call))
            if form not in timed:
                timed[form] = device(call, "batch_graph")
    for form in ("eager", "graph"):
        ms = statistics.median(turns[form])
        timed[form] = {"wall_ms": ms, "wall_ms_turns": turns[form],
                       "sessions_per_s": len(raws) / (ms / 1e3), "device_ms": timed[form][0],
                       "device_activities": timed[form][1]}
    timed["wall_ratio_graph_over_eager"] = timed["graph"]["wall_ms"] / timed["eager"]["wall_ms"]
    return {"buckets": {str(b): len(rs) for b, rs in sorted(groups.items())},
            "calls_compared": 4 * len(order), "forms": forms, "run_dataset": timed}


MULTI_RAGGED = (0, 7, 13)            # streams finalized alone in phase 21's multi-stream check


def multi_graphs(np, torch, sd, raws, angles, device, dev) -> dict:
    """Phase 21, the multi-stream round: the 19 dataset logs as 19 streams
    (each stream several logs back to back, so that there are rounds to
    replay) at 1 MiB and at steady 64 KiB rounds with s_step 64, one round a
    feed; a graph session and an eager one (``eager_rounds``) fed the same
    rounds, the whole state equal after every feed, and after a ragged flush
    (``MULTI_RAGGED``) and the final one; the same with a mesh of two
    positions of cuda:0 at 64 KiB.  Then eager against graph: ms per round
    (CUDA events around each feed, median over the rounds that captured
    nothing), device ms per round (``measure_device_time``, 3 rounds), host
    syncs and staging waits per round; the graphs by block count with their
    capture ms and pool bytes."""
    from slam_process_tpu_torch.parallel.mesh import make_mesh

    spec = sd.make_paths_spec(angles, s_step=64)
    out = {}
    for name, chunk, n_logs, compare, timed_n in (("1MiB", MULTI_CHUNK, 20, 2, 5),
                                                  ("steady_64KiB", LIVE_CHUNK, 2, 6, 10)):
        streams = [np.concatenate([raws[(i + k) % len(raws)] for k in range(n_logs)])
                   for i in range(len(raws))]
        feeds = [one_round_feeds(r, chunk, sd.CARRY_BYTES) for r in streams]
        rounds = [[f[k] if k < len(f) else b"" for f in feeds]
                  for k in range(min(len(f) for f in feeds))]
        if len(rounds) < compare + timed_n + 3 + 1:
            fail(f"graphs multi_stream {name}: {len(rounds)} rounds are too few")
        ecap = -(-(max(len(r) for r in streams) // 11 + 1) // (1 << 16)) * (1 << 16)

        def session(mesh=None):
            return sd.MultiStreamingSession(len(raws), chunk_bytes=chunk, collect_paths=spec,
                                            emit_capacity=ecap, mesh=mesh,
                                            device=None if mesh is not None else dev)

        meshes = {"mesh_none": None}
        if name == "steady_64KiB":
            meshes["mesh_2x1_cuda0"] = make_mesh((2, 1), devices=[torch.device(dev.type, 0)] * 2)
        row = {}
        for tag, mesh in meshes.items():
            g, e = session(mesh), eager_rounds(session(mesh))
            for k in range(compare):
                g.feed(rounds[k])
                e.feed(rounds[k])
                if not same_multi_state(torch, sd, g, e):
                    fail(f"graphs multi_stream {name} {tag}: the graphs' state differs from the "
                         f"eager rounds' after feed {k + 1}")
            used = compare
            if tag == "mesh_none":
                row.update(timed_rounds(torch, sd, g, e, rounds[compare:], timed_n, device,
                                        f"multi_{name}"))
                used += timed_n + 3
            for x in (g, e):
                x.finalize_streams(list(MULTI_RAGGED))
            if not same_multi_state(torch, sd, g, e):
                fail(f"graphs multi_stream {name} {tag}: the state differs after the ragged flush")
            for x in (g, e):
                x.feed([b"" if i in MULTI_RAGGED else p for i, p in enumerate(rounds[used])])
                x.finalize()
            if (not same_multi_state(torch, sd, g, e)
                    or any(sh._pre_graph is None or not sh._post_graphs for sh in g._shards)):
                fail(f"graphs multi_stream {name} {tag}: the state differs after the flush, or "
                     "a shard has no graphs")
            row[tag] = graphs_of(g)
            del g, e
        out[name] = {"streams": len(raws), "logs_per_stream": n_logs, "rounds": len(rounds),
                     "rounds_compared": compare, "window_bytes": chunk, **row}
    return out


def graphs_of(ms) -> dict:
    """A multi-stream session's graphs: per shard the pre-read graph's and
    each post-read graph's (by block count) replays, capture ms and pool
    bytes, and the pools' bytes counted once each."""
    from slam_process_tpu_torch.utils.graphs import pool_bytes

    shards, pools = [], {}
    for sh in ms._shards:
        graphs = {"pre": sh._pre_graph, **{f"post_nblk_{k}": g
                                           for k, g in sorted(sh._post_graphs.items())}}
        shards.append({k: None if g is None else {
            "replays": g.replays, "capture_ms": g.capture_ms, "pool_bytes": g.pool_bytes}
            for k, g in graphs.items()})
        for g in graphs.values():
            if g is not None:
                pools[tuple(g.graph.pool())] = None
    return {"graphs": shards,
            "pool_bytes_total": sum(pool_bytes(p) for p in pools),
            "pools": len(pools)}


def timed_rounds(torch, sd, g, e, rounds, timed_n, device, name) -> dict:
    """Eager against graph on ``rounds`` (each form fed the same rounds, in
    turn): ms per round from CUDA events around each feed, the median over
    the graph rounds that captured nothing (and the same rounds eager); then
    3 more rounds each under ``measure_device_time``; host syncs and
    staging waits per round."""
    row = {}
    for form, x in (("eager", e), ("graph", g)):
        syncs, waits = sd.HOST_SYNCS, sd.STAGING_WAITS
        times, captured = [], []
        for pieces in rounds[:timed_n]:
            n_graphs = len(x._post_graphs) + (x._pre_graph is not None)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            x.feed(pieces)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            captured.append(len(x._post_graphs) + (x._pre_graph is not None) != n_graphs)
        row[form] = {"ms_per_round_all": times,
                     "host_syncs_per_round": (sd.HOST_SYNCS - syncs) / timed_n,
                     "staging_waits_per_round": (sd.STAGING_WAITS - waits) / timed_n}
        row[form]["captured"] = captured
    keep = [k for k, c in enumerate(row["graph"]["captured"]) if not c]
    if not keep:
        fail(f"graphs {name}: every timed round captured a graph")
    for form in ("eager", "graph"):
        row[form]["ms_per_round"] = statistics.median(row[form]["ms_per_round_all"][k]
                                                      for k in keep)
    prof = rounds[timed_n:timed_n + 3]
    for form, x in (("eager", e), ("graph", g)):
        dev_ms, acts = device(lambda i, x=x: x.feed(prof[i]), f"{name}_{form}", per_run=True)
        row[form].update(device_ms_per_round=dev_ms, device_activities_per_round=acts)
    row["round_ratio_graph_over_eager"] = (row["graph"]["ms_per_round"]
                                           / row["eager"]["ms_per_round"])
    return row


MULTIHOST_TIMEOUT_S = 300            # each process of the multihost phase
MULTIHOST_WATCH = [dict(n_groups=n, frames_per_beam=12, baselines_per_group=40, junk_frac=0.02,
                        seed=500 + i, n_paths=3) for i, n in enumerate((2, 5, 6))]


def multihost_phase(np, torch, sd, tmp, angles, raws, sessions, dev) -> dict:
    """Phase 20: three two-process gloo clusters on 127.0.0.1, every process
    on cuda:0 with two mesh positions, each process under its own timeout:
    the dry-run worker; ``MULTIHOST_WORKER`` with ``run_batched_multihost``
    over four dataset sessions (model = 2), ``estimate_sessions_multihost``
    (grid 0.5) and ``MultihostMultiStream`` over the 19 dataset sessions
    split 10 / 9; ``cli watch --coordinator`` on three captures split 2 / 1,
    ended by SIGINT once each process has read its captures to the end
    (``cli.WATCH_CAUGHT_UP``).  Each process's results equal the
    single-process run of the same bytes on the card, every field, floats
    bitwise."""
    from concurrent.futures import ThreadPoolExecutor

    from slam_process_tpu_torch.io.hexlog import tokenize_hex
    from slam_process_tpu_torch.io.schemas import write_filtered_table
    from slam_process_tpu_torch.models.batch_estimation import estimate_sessions
    from slam_process_tpu_torch.parallel import _dryrun_worker as dry
    from slam_process_tpu_torch.parallel import batch
    from slam_process_tpu_torch.parallel.multihost import run_local_cluster
    from slam_process_tpu_torch.pipeline import cli
    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, to_hex_text

    # The six worker processes share the card with this one: release the
    # blocks this process's allocator keeps cached but no tensor holds.
    reserved = {"before": torch.cuda.memory_reserved(dev) if dev.type == "cuda" else 0}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reserved["after"] = torch.cuda.memory_reserved(dev) if dev.type == "cuda" else 0
    work = tmp / "multihost"
    work.mkdir()
    worker = work / "chip_smoke_multihost_worker.py"
    worker.write_text(MULTIHOST_WORKER)
    ds = raws[DS]
    ecap = -(-(max(len(r) for r in ds) // 11 + 1) // (1 << 16)) * (1 << 16)
    on_cpu = ["cpu"] if dev.type == "cpu" else []     # a rehearsal without a card
    sess_arg = json.dumps({"batch": DATASET[:4], "streams": DATASET, "chunk": MULTI_CHUNK,
                           "ecap": ecap, "device": (on_cpu or [None])[0]})
    logs = []
    for i, cfg in enumerate(MULTIHOST_WATCH):
        logs.append(work / f"cap{i}" / "capture.txt")
        logs[-1].parent.mkdir()
        logs[-1].write_bytes(to_hex_text(synthetic_session_bytes(**cfg)))
    split = (logs[:2], logs[2:])

    def watch_argv(k, coord):
        return ["watch", "--logs", *map(str, split[k]), "--mapping", str(angles), "--outdir",
                str(work / "watch_out"), "--coordinator", coord,
                "--num-processes", "2", "--process-id", str(k), "--local-devices", "2",
                "--idle-timeout", "0", "--poll-interval", "0.05", "--paths", "--changes",
                "--events", str(work / f"events_{k}.jsonl"), "--device", dev.type]

    py = sys.executable
    clusters = {
        "dryrun": (lambda coord: [[py, "-m", "slam_process_tpu_torch.parallel._dryrun_worker",
                                   str(k), "2", coord, *on_cpu] for k in range(2)], None),
        "sessions": (lambda coord: [[py, str(worker), str(REPO), "sessions", str(k), "2", coord,
                                     str(work / f"out_{k}.npz"), str(angles), sess_arg]
                                    for k in range(2)], None),
        "watch": (lambda coord: [[py, str(worker), str(REPO), "watch", str(k), "2", coord,
                                  str(work / "unused.npz"), str(angles),
                                  json.dumps(watch_argv(k, coord))] for k in range(2)],
                  cli.WATCH_CAUGHT_UP),
    }
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(clusters)) as pool:
        futures = {name: pool.submit(run_local_cluster, argvs_for, MULTIHOST_TIMEOUT_S,
                                     cwd=str(REPO), interrupt_when=marker)
                   for name, (argvs_for, marker) in clusters.items()}
        try:
            res = {name: f.result() for name, f in futures.items()}
        except TimeoutError as e:
            fail(f"multihost: a process outlived its {MULTIHOST_TIMEOUT_S} s: {e}")
    wall_s = time.perf_counter() - t0
    lines = {}
    for name, procs in res.items():
        for k, (rc, out, err) in enumerate(procs):
            if rc != 0:
                fail(f"multihost: {name} process {k} exited {rc}: {err[-2000:]}")
        lines[name] = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in procs]
    launches = {k: sum(ln["launches"][k] for v in lines.values() for ln in v)
                for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7")}
    if min(launches.values()) == 0:
        fail(f"multihost: a kernel never launched in the worker processes: {launches}")

    # The dry run against one process's four streams.
    streams = [dry.synthetic_stream_bytes(180, seed=10 * pid + i) for pid in range(2)
               for i in range(2)]
    m = sd.MultiStreamingSession(4, chunk_bytes=4096, group_capacity=1024, max_groups=8,
                                 max_baselines_per_group=16, device=dev)
    half = len(streams[0]) // 2
    m.feed([x[:half] for x in streams])
    m.feed([x[half:] for x in streams])
    m.finalize()
    nf, _, ng, _, _, _ = m.results()
    for pid, ln in enumerate(lines["dryrun"]):
        if not ln["ok"] or ln["n_frames"] != nf[2 * pid:2 * pid + 2].tolist() or \
                ln["n_groups"] != ng[2 * pid:2 * pid + 2].tolist():
            fail(f"multihost: the dry run's process {pid} differs: {ln}")

    # Sessions: the batch, the estimator and the 19 streams.
    four = [raws[1 + i] for i in range(4)]
    n = max(len(r) for r in four)
    want_b = batch.batched_session_pipeline(None, n, outputs="summary", device=dev)(
        *batch.stack_sessions(four, n), batch.device_lut(dev))
    want_e = estimate_sessions(sessions[1:5], angles, device=dev, grid_res=0.5)
    spec = sd.make_paths_spec(angles, s_step=64)
    ms = sd.MultiStreamingSession(len(ds), chunk_bytes=MULTI_CHUNK, collect_paths=spec,
                                  emit_capacity=ecap, device=dev)
    ms.feed(ds)
    ms.finalize()
    ref_results, ref_closed = ms.results(), ms.n_sweeps_closed_all()
    for pid in range(2):
        got = dict(np.load(work / f"out_{pid}.npz"))
        rows = slice(2 * pid, 2 * pid + 2)
        for f in batch.SessionSummaryOut._fields:
            if not same_results(got["batch_" + f], getattr(want_b, f)[rows].cpu().numpy()):
                fail(f"multihost: run_batched_multihost process {pid} {f} differs")
        for k in range(2):
            for f in want_e[0]._fields:
                if not same_results(got["est_" + f][k], np.asarray(getattr(want_e[2 * pid + k], f))):
                    fail(f"multihost: estimate_sessions_multihost session {2 * pid + k} {f} "
                         "differs")
        local = lines["sessions"][pid]["local_streams"]
        for k, i in enumerate(local):
            for j in range(6):
                if not same_results(got[f"stream_results_{j}"][k], ref_results[j][i]):
                    fail(f"multihost: stream {i} result {j} differs")
            paths, valid = ms.stream_paths(i)
            tracks, times, _ = ms.stream_tracks(i)
            checks = [(got["stream_closed"][k], ref_closed[i]),
                      (got[f"stream_filtered_{k}"], ms.stream_filtered(i)),
                      (got[f"stream_valid_{k}"], valid), (got[f"stream_times_{k}"], times)]
            checks += [(got[f"stream_paths_{k}_{f}"], np.asarray(getattr(paths, f)))
                       for f in paths._fields]
            checks += [(got[f"stream_tracks_{k}_{f}"], np.asarray(getattr(tracks, f)))
                       for f in ("pos_aoa", "pos_aod", "power", "observed", "created")]
            if not all(same_results(a, b) for a, b in checks):
                fail(f"multihost: MultihostMultiStream stream {i} differs from one process")

    # The watch against one process's replay of the three captures.
    ref = sd.MultiStreamingSession(3, collect_paths=sd.make_paths_spec(angles),
                                   emit_capacity=1 << 18, device=dev)
    ref.feed([tokenize_hex(p.read_bytes()) for p in logs])
    ref.finalize()
    names = ["p0_capture", "p0_capture_1", "p1_capture"]
    ref_dir = work / "watch_ref"
    ref_dir.mkdir()
    args = cli.build_parser().parse_args(watch_argv(0, "127.0.0.1:1"))
    args.outdir = ref_dir
    args.events = work / "events_ref.jsonl"
    for i, name in enumerate(names):
        write_filtered_table(ref_dir / f"{name}_filtered.xlsx", ref.stream_filtered(i))
        cli._export_tracks(*ref.stream_tracks(i), name, args)
        for table in ("filtered", "stream_tracks", "stream_changes"):
            if not xlsx_same(work / "watch_out" / f"{name}_{table}.xlsx",
                             ref_dir / f"{name}_{table}.xlsx"):
                fail(f"multihost: watch {name}'s {table} differs from one process")
    cli._make_multi_event_emitter(args, ref, names)()
    want_ev = [json.loads(x) for x in args.events.read_text().splitlines()]
    got_ev = [json.loads(x) for k in range(2)
              for x in (work / f"events_{k}.jsonl").read_text().splitlines()]
    for name in names:
        if [e for e in got_ev if e["session"] == name] != [e for e in want_ev
                                                             if e["session"] == name]:
            fail(f"multihost: watch {name}'s events differ from one process")
    summaries = [x for ln in lines["watch"] for x in ln["lines"]]
    frames = ref.results()[0]
    for x in summaries[:2] + summaries[3:4]:
        if x["frames"] != int(frames[names.index(x["session"])]):
            fail(f"multihost: watch summary {x} differs from one process")
    return {"processes": 6, "main_process_reserved_bytes": reserved,
            "clusters": list(clusters), "wall_s": wall_s,
            "launches": launches, "events": len(got_ev),
            "watch_summaries": summaries,
            "launches_by_process": {name: [ln["launches"] for ln in v]
                                    for name, v in lines.items()}}

if __name__ == "__main__":
    main()
