"""The port's command-line interface, the counterpart of
``slam_process_tpu/pipeline/cli.py``:

    python -m slam_process_tpu_torch.pipeline.cli decode  IN.txt [OUT.xlsx] [--format v1|v2|v3]
    python -m slam_process_tpu_torch.pipeline.cli correct --input IN.xlsx|IN.txt [--output OUT]
                                                            [--in-place] [--run-tests]
    python -m slam_process_tpu_torch.pipeline.cli heatmap --input IN --mapping beam_angle.xlsx
                                                            [--variant v1|v2|v3] ...
    python -m slam_process_tpu_torch.pipeline.cli session --log IN.txt --mapping ... --outdir DIR
    python -m slam_process_tpu_torch.pipeline.cli estimate --input IN.txt|IN.xlsx --mapping ...
                                                 [--model nn_omp|nn_omp_v1|nn_omp_v13|...|geometric]
                                                 [--engine device|host]
                                                 [--per-sweep | --tracks [--changes]]
    python -m slam_process_tpu_torch.pipeline.cli replay --logs A.txt [B.txt ...] --mapping ...
                                                 --outdir DIR [--engine device|host]
                                                 [--chunk-bytes N] [--paths [--changes]]
                                                 [--profile DIR]
    python -m slam_process_tpu_torch.pipeline.cli watch --log LIVE.txt | --logs A.txt B.txt ...
                                                 --mapping ... --outdir DIR
                                                 [--engine device|host] [--paths [--changes]]
                                                 [--events E.jsonl] [--checkpoint C.npz
                                                 [--checkpoint-every S]] [--idle-timeout S]
                                                 [--coordinator HOST:PORT --num-processes N
                                                 --process-id K [--local-devices L]]
    python -m slam_process_tpu_torch.pipeline.cli run-config NAME --data-dir DIR --mapping ...
                                                 [--outdir DIR]

Every command runs its stages on the card (decode K1, corrector K2, raster
K3, per-sweep sums K4, compaction K5, tracker K6, the estimators in
PyTorch); ``--device cpu`` runs the plain PyTorch versions instead, the one
option the JAX CLI lacks.  ``estimate``, ``replay`` and ``watch`` take
``--engine device`` by default, where the JAX CLI's default is ``host``
(for ``estimate`` the float64 numpy oracle, for the streams the numpy
session on the CPU); ``--engine host`` streams on the CPU and never touches
the card.  ``replay --decoder`` is accepted, and either value runs K1.
``watch --logs`` with one file is ``--log``; several files run one
multi-stream session (``MultiWatch``); with ``--coordinator`` each
process of a watch cluster tails its own ``--logs`` (``MultihostWatch``,
ended by SIGINT or each capture's idle timeout).  ``run-config`` needs its
``--data-dir`` and ``--mapping``.  The v1 / v2 wire formats decode with
numpy in both packages.  The PNGs (heatmap, estimation, tracks, a stream's
heatmap) need matplotlib; a colormap other than viridis needs it too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zipfile
from pathlib import Path

import numpy as np

from slam_process_tpu_torch.config import RenderConfig, SceneConfig
from slam_process_tpu_torch.models.registry import PORTED, run_estimator
from slam_process_tpu_torch.models.sweep_estimation import path_power
from slam_process_tpu_torch.pipeline.session import Session
from slam_process_tpu_torch.utils.logging import StageCounters, get_logger
from slam_process_tpu_torch.utils.timestamps import extract_timestamp


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device of the stages (default cuda; cpu runs the plain "
                        "PyTorch versions)")


def _add_decode(sub):
    p = sub.add_parser("decode", help="hex serial log -> Parsed xlsx")
    p.add_argument("input", type=Path)
    p.add_argument("output", type=Path, nargs="?")
    p.add_argument("--format", choices=["v1", "v2", "v3"], default="v3",
                   help="wire format generation (v3 = 11-byte, current)")
    _add_device(p)
    p.set_defaults(fn=_run_decode)


def _run_decode(args):
    out = args.output or args.input.with_suffix(".xlsx")
    if args.format != "v3":
        _run_decode_legacy(args, out)
        return
    s = Session.from_log(args.input, device=args.device, count_discards=True)
    out = s.export_parsed(out)
    c = StageCounters("decode", {"valid": len(s.frames), "discarded": s.n_discarded})
    print(f"有效组数={c.counts['valid']} 丢弃组数={c.counts['discarded']} 输出={out}")


def _run_decode_legacy(args, out):
    from slam_process_tpu_torch.io import read_hex_log
    from slam_process_tpu_torch.io.xlsx import write_xlsx_mixed
    from slam_process_tpu_torch.ops.decode_legacy import (
        V1_COLUMNS, V2_COLUMNS, decode_frames_v1_np, decode_frames_v2_np, to_hex)

    raw = read_hex_log(args.input)
    if args.format == "v1":
        res = decode_frames_v1_np(raw)
        w, f = res.windows, res.frames
        cols = [[to_hex(v) for v in w[:, 0]], f[:, 0], [to_hex(v) for v in w[:, 1]], f[:, 1],
                *([to_hex(v) for v in w[:, k]] for k in (2, 3, 4)), f[:, 2]]
        out = write_xlsx_mixed(out, V1_COLUMNS, cols, sheet_name="Parsed")
    else:
        res = decode_frames_v2_np(raw)
        w, f = res.windows, res.frames
        cols = [f[:, 0], f[:, 1], f[:, 2], f[:, 3],
                *([to_hex(v) for v in w[:, k]] for k in (1, 2, 3, 4, 5))]
        out = write_xlsx_mixed(out, V2_COLUMNS, cols, sheet_name="Parsed")
    print(f"有效组数={res.valid} 丢弃组数={res.discarded} 输出={out}")


def _add_correct(sub):
    p = sub.add_parser("correct", help="Parsed xlsx -> _filtered xlsx")
    p.add_argument("--input", type=Path, default=None)
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--in-place", action="store_true",
                   help="rewrite the input with a Corrected_BS_Beam column instead of "
                        "filtering")
    p.add_argument("--run-tests", action="store_true",
                   help="run the corrector's self-tests and exit")
    _add_device(p)
    p.set_defaults(fn=_run_correct)


def _run_correct(args):
    if args.run_tests:
        from slam_process_tpu_torch.ops.correct import self_test

        raise SystemExit(0 if self_test(device=args.device) else 1)
    if args.input is None:
        raise SystemExit("correct: --input is required (or --run-tests)")
    if args.input.suffix == ".txt":
        s = Session.from_log(args.input, device=args.device)
    else:
        s = Session.from_parsed_xlsx(args.input)
    s.correct(device=args.device)
    if args.in_place:
        out = s.export_corrected(args.output or args.input)
        print(f"已写回修正文件: {out}")
        return
    out = s.export_filtered(args.output
                            or args.input.with_name(args.input.stem + "_filtered.xlsx"))
    print(f"已生成过滤后的修正文件: {out} 行数={len(s.filtered)}")


def _add_heatmap(sub):
    p = sub.add_parser("heatmap", help="render the AoA x AoD mean-RSSI heatmap")
    p.add_argument("--input", type=Path, required=True,
                   help="Parsed / filtered xlsx or raw .txt log")
    p.add_argument("--mapping", type=Path, required=True)
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--variant", choices=["v1", "v2", "v3"], default="v3",
                   help="v1 = Parsed, v2 = Parsed FLAG == 1 only, v3 = filtered input")
    p.add_argument("--colormap", default="viridis")
    p.add_argument("--no-logscale", action="store_true")
    p.add_argument("--vmin", type=float, default=None)
    p.add_argument("--vmax", type=float, default=None)
    p.add_argument("--blur-sigma", type=float, default=1.0)
    p.add_argument("--dpi", type=int, default=150)
    _add_device(p)
    p.set_defaults(fn=_run_heatmap)


def heatmap_configs(args):
    """(SceneConfig, RenderConfig) of ``heatmap``'s arguments."""
    scene_cfg = SceneConfig(keep_nan=True, fill_with_min=False,
                            flag_filter=1 if args.variant == "v2" else None)
    render_cfg = RenderConfig(colormap=args.colormap, use_log=not args.no_logscale,
                              blur_sigma=args.blur_sigma, vmin=args.vmin, vmax=args.vmax,
                              dpi=args.dpi)
    return scene_cfg, render_cfg


def heatmap_session(args):
    """(Session, source) of ``heatmap``'s input and variant."""
    if args.input.suffix == ".txt":
        s = Session.from_log(args.input, device=args.device)
        return s, "filtered" if args.variant == "v3" else "parsed"
    if args.variant == "v3":
        return Session.from_filtered_xlsx(args.input), "filtered"
    return Session.from_parsed_xlsx(args.input), "parsed"


def _run_heatmap(args):
    scene_cfg, render_cfg = heatmap_configs(args)
    s, source = heatmap_session(args)
    out = args.output
    if out is None:
        out = args.input.parent / "heatmap_outputs" / f"{args.input.stem}_heatmap.png"
    s.render_heatmap(args.mapping, out, scene_cfg, render_cfg, source=source,
                     title=f"BS-UE 波束对平均RSSI热力图 ({args.input.name})", device=args.device)
    print(f"输出PNG: {out}")


def _add_session(sub):
    p = sub.add_parser("session", help="full end-to-end: log -> artifacts dir")
    p.add_argument("--log", type=Path, required=True)
    p.add_argument("--mapping", type=Path, required=True)
    p.add_argument("--outdir", type=Path, required=True)
    p.add_argument("--engine", choices=["host", "device"], default="device",
                   help="device = decode and correct on --device; host = the numpy "
                        "decode and corrector (the heatmap runs on --device either way)")
    _add_profile(p)
    _add_device(p)
    p.set_defaults(fn=_run_session)


def _add_profile(p):
    p.add_argument("--profile", type=Path, default=None,
                   help="write a torch.profiler trace (trace.json, with the port's slam.* "
                        "spans) into this directory")


def _run_session(args):
    from slam_process_tpu_torch.utils.profiling import trace

    with trace(args.profile):
        _run_session_inner(args)


def _run_session_inner(args):
    s = Session.from_log(args.log, engine=args.engine, device=args.device)
    s.correct(engine=args.engine, device=args.device)
    args.outdir.mkdir(parents=True, exist_ok=True)
    s.export_parsed(args.outdir / f"{s.name}.xlsx")
    s.export_filtered(args.outdir / f"{s.name}_filtered.xlsx")
    s.render_heatmap(args.mapping, args.outdir / f"{s.name}_heatmap.png", device=args.device)
    s.save_npz(args.outdir / f"{s.name}.npz")
    print(json.dumps({"session": s.name, "timings_s": s.timings,
                      "counters": {c.name: c.counts for c in s.counters}}))


def _add_estimate(sub):
    p = sub.add_parser("estimate", help="multipath estimation + classified plot (stage 3b)")
    p.add_argument("--input", type=Path, required=True, help="filtered xlsx or raw .txt")
    p.add_argument("--mapping", type=Path, required=True)
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--model", default="nn_omp", choices=PORTED)
    p.add_argument("--max-paths", type=int, default=None)
    p.add_argument("--grid-res", type=float, default=None)
    p.add_argument("--beam-width", type=float, default=None)
    p.add_argument("--engine", choices=["host", "device"], default="device",
                   help="device = the estimator on --device; host = the float64 numpy "
                        "oracle")
    p.add_argument("--per-sweep", action="store_true",
                   help="time-resolved estimation over every sweep of the session "
                        "(nn_omp; writes a table of per-sweep paths instead of a figure)")
    p.add_argument("--tracks", action="store_true",
                   help="associate per-sweep paths into CLK-anchored tracks with "
                        "angular-velocity fits (implies --per-sweep; writes a track table + "
                        "trajectory figure)")
    p.add_argument("--gate-deg", type=float, default=10.0,
                   help="track association gate (Euclidean angle distance)")
    _add_change_args(p, gate="--tracks")
    _add_device(p)
    p.set_defaults(fn=_run_estimate)


def estimate_inputs(args):
    """(Session, overrides) of ``estimate``'s input and options: a raw log
    decoded and corrected on ``--device``, or a filtered xlsx."""
    if args.input.suffix == ".txt":
        s = Session.from_log(args.input, device=args.device)
        s.correct(device=args.device)
    else:
        s = Session.from_filtered_xlsx(args.input)
    overrides = {"device": args.device}
    for key in ("max_paths", "grid_res", "beam_width"):
        if getattr(args, key) is not None:
            overrides[key] = getattr(args, key)
    if args.engine != "device":
        overrides["engine"] = args.engine
    return s, overrides


def _run_estimate(args):
    s, overrides = estimate_inputs(args)
    if args.tracks:
        _run_estimate_tracks(args, s, overrides)
        return
    if args.changes:
        print("warning: --changes requires --tracks; no change events will be written",
              file=sys.stderr)
    if args.per_sweep:
        _run_estimate_per_sweep(args, s, overrides)
        return
    out = args.output or (args.input.parent / f"{s.name}_{args.model}.png")
    paths = run_estimator(args.model, s, args.mapping, out, **overrides)
    print(paths.to_string(index=False))
    print(f"输出PNG: {out}")


def _add_change_args(p, gate: str) -> None:
    """Scene-change-detection flags (the JAX CLI shares them with replay /
    watch)."""
    p.add_argument("--changes", action="store_true",
                   help=f"with {gate}: detect scene change events (path births/deaths, "
                        "angular jumps, LoS handovers) and write a CLK-stamped event table")
    p.add_argument("--min-persist", type=int, default=3,
                   help="observations before a track counts as a path birth")
    p.add_argument("--min-gone", type=int, default=3,
                   help="consecutive missed sweeps before a confirmed track counts as a "
                        "path death")
    p.add_argument("--jump-deg", type=float, default=5.0,
                   help="angular displacement between consecutive observations that "
                        "counts as a jump event")


def _coerce_sweep_estimator(args, overrides, what: str) -> str:
    """The per-sweep estimator of --model, warning instead of silently
    coercing (only nn_omp / sm_sic estimate per sweep, always on
    --device)."""
    if args.model in ("nn_omp", "sm_sic"):
        estimator = args.model
    else:
        estimator = "nn_omp"
        print(f"warning: --model {args.model} is not a sweep estimator (nn_omp/sm_sic); "
              f"using nn_omp for {what}", file=sys.stderr)
    if overrides.pop("engine", None) is not None:
        print(f"warning: --engine is ignored with {what} (per-sweep estimation always runs "
              "on --device)", file=sys.stderr)
    return estimator


def tracks_table(tracks, times, vel):
    """[rows, 8] float64 of the track xlsx: (track, sweep, CLK, AoA, AoD,
    power, the track's two angular velocities) per observation."""
    import numpy as np

    rows = []
    for t in range(int(tracks.n_tracks)):
        for sweep in np.nonzero(tracks.observed[t])[0]:
            rows.append([t, sweep, times[sweep], tracks.pos_aoa[t][sweep],
                         tracks.pos_aod[t][sweep], tracks.power[t][sweep], vel[0][t],
                         vel[1][t]])
    return np.asarray(rows, dtype=np.float64).reshape(-1, 8)


TRACK_COLUMNS = ["Track", "Sweep", "CLK", "AoA", "AoD", "Power", "Vel_AoA_deg_per_tick",
                 "Vel_AoD_deg_per_tick"]
CHANGE_COLUMNS = ["Sweep", "CLK", "Kind", "Track", "AoA", "AoD", "Power"]


def change_events(tracks, times, args):
    """[N, 7] float64 scene-change events of ``tracks`` under the change
    flags (``detect_scene_changes_np`` + ``scene_change_events``)."""
    from slam_process_tpu_torch.models.change_detection import (
        detect_scene_changes_np, scene_change_events)

    changes = detect_scene_changes_np(tracks, min_persist=args.min_persist,
                                      min_gone=args.min_gone, jump_deg=args.jump_deg)
    return scene_change_events(changes, tracks, times)


def write_changes(out, tracks, times, args):
    """Detect the scene changes of ``tracks``, write their xlsx beside
    ``out`` and return (its path, the printed line)."""
    import numpy as np

    from slam_process_tpu_torch.io.xlsx import write_xlsx_table
    from slam_process_tpu_torch.models.change_detection import EVENT_KINDS

    events = change_events(tracks, times, args)
    ev_path = write_xlsx_table(Path(out).with_name(Path(out).stem + "_changes.xlsx"),
                               CHANGE_COLUMNS, events)
    counts = {EVENT_KINDS[k]: int(np.sum(events[:, 2] == k)) for k in range(len(EVENT_KINDS))}
    return ev_path, f"changes={len(events)} {counts} 输出={ev_path}"


def _run_estimate_tracks(args, s, overrides):
    """CLK-anchored track association over per-sweep paths (the ToA axis)."""
    import numpy as np

    from slam_process_tpu_torch.io.xlsx import write_xlsx_table
    from slam_process_tpu_torch.render.tracks import save_track_figure

    estimator = _coerce_sweep_estimator(args, overrides, "--tracks")
    tracks, times, vel = s.path_tracks(args.mapping, estimator=estimator,
                                       gate_deg=args.gate_deg, **overrides)
    table = tracks_table(tracks, times, vel)
    base = args.output or (args.input.parent / f"{s.name}_tracks.xlsx")
    out = write_xlsx_table(base, TRACK_COLUMNS, table)
    fig_path = Path(out).with_suffix(".png")
    save_track_figure(tracks, times, fig_path, velocities=vel, title=f"Path tracks ({s.name})")
    n_fit = int(np.sum(vel[2][: int(tracks.n_tracks)]))
    print(f"tracks={int(tracks.n_tracks)} fitted={n_fit} rows={len(table)} 输出={out} "
          f"图={fig_path}")
    if args.changes:
        print(write_changes(out, tracks, times, args)[1])


def _run_estimate_per_sweep(args, s, overrides):
    import numpy as np

    from slam_process_tpu_torch.io.xlsx import write_xlsx_table

    estimator = _coerce_sweep_estimator(args, overrides, "--per-sweep")
    paths, sweep_valid = s.sweep_paths(args.mapping, estimator=estimator, **overrides)
    times = s.sweep_times(len(sweep_valid), device=args.device)
    power = path_power(paths)
    rows = []
    for sweep in np.nonzero(sweep_valid)[0]:
        for k in np.nonzero(paths.valid[sweep])[0]:
            rows.append([sweep, times[sweep], k, paths.aoa[sweep][k], paths.aod[sweep][k],
                         power[sweep][k]])
    table = np.asarray(rows, dtype=np.float64).reshape(-1, 6)
    out = args.output or (args.input.parent / f"{s.name}_sweep_paths.xlsx")
    # write_xlsx_table may retry to <stem>_out.xlsx on PermissionError;
    # report the path it actually wrote.
    out = write_xlsx_table(out, ["Sweep", "CLK", "Path", "AoA", "AoD", "Power"], table)
    print(f"sweeps={int(sweep_valid.sum())}/{len(sweep_valid)} paths={len(rows)} 输出={out}")


# -- streaming: replay and watch -----------------------------------------------


def _add_replay(sub):
    p = sub.add_parser("replay", help="streaming replay: chunked decode -> correct -> render")
    p.add_argument("--logs", type=Path, nargs="+", required=True)
    p.add_argument("--mapping", type=Path, required=True)
    p.add_argument("--outdir", type=Path, required=True)
    p.add_argument("--chunk-bytes", type=int, default=1 << 16)
    p.add_argument("--render-every", type=int, default=0,
                   help="re-render the live heatmap every N chunks (host engine)")
    p.add_argument("--engine", choices=["host", "device"], default="device",
                   help="device = the streaming state machine on --device; host = the numpy "
                        "decode and corrector on the CPU")
    p.add_argument("--decoder", choices=["xla", "pallas"], default="xla",
                   help="accepted for the JAX CLI's sake: both run kernel K1, the port's "
                        "only decoder")
    p.add_argument("--emit-capacity", type=int, default=None,
                   help="device emit-ring rows for --engine device (default: sized to the "
                        "log, so a file replay cannot overflow the ring)")
    p.add_argument("--paths", action="store_true",
                   help="online per-sweep estimation + CLK tracks as sweeps close; writes "
                        "<name>_stream_tracks.xlsx per log")
    _add_change_args(p, gate="--paths")
    _add_profile(p)
    _add_device(p)
    p.set_defaults(fn=_run_replay)


def replay_stream(args, log):
    """(name, session, seconds) of one log streamed by ``--engine``: the
    device session on ``--device`` (finished on the device), or the host
    session on the CPU."""
    import time

    from slam_process_tpu_torch.io import read_hex_log
    from slam_process_tpu_torch.parallel.streaming_device import make_paths_spec

    name = extract_timestamp(str(log)) or log.stem
    raw = read_hex_log(log)
    cp = make_paths_spec(args.mapping) if args.paths else None
    t0 = time.perf_counter()
    if args.engine == "device":
        from slam_process_tpu_torch.parallel.streaming_device import replay_log_device

        # Kept rows cannot exceed one frame per 11 bytes, so a ring sized to
        # the log never overflows.
        s = replay_log_device(raw, chunk_bytes=args.chunk_bytes, collect_filtered=True,
                              emit_capacity=args.emit_capacity or (len(raw) // 11 + 1),
                              collect_paths=cp, device=args.device)
        s.block_until_ready()
    else:
        from slam_process_tpu_torch.io.angles import load_angle_lut
        from slam_process_tpu_torch.parallel.streaming import replay_log

        s = replay_log(raw, chunk_bytes=args.chunk_bytes, render_every=args.render_every,
                       angle_lut=load_angle_lut(args.mapping), collect_paths=cp)
    return name, s, time.perf_counter() - t0


def replay_exports(args, s, name: str, seconds: float) -> dict:
    """Write a replayed log's filtered table (and with --paths its tracks
    and changes); returns its stats line."""
    from slam_process_tpu_torch.io.schemas import write_filtered_table

    write_filtered_table(args.outdir / f"{name}_filtered.xlsx", s.filtered)
    if args.paths:
        _export_stream_tracks(s, name, args)
    return replay_stats(s, name, seconds)


def replay_stats(s, name: str, seconds: float) -> dict:
    """A replayed log's stats line."""
    return {"session": name, "frames": s.n_frames, "kept": s.n_kept, "sweeps": s.n_groups,
            "frames_per_sec": round(s.n_frames / seconds, 1)}


def _save_stream_png(rendered, out, title: str):
    from slam_process_tpu_torch.render.figures import save_heatmap_figure

    return save_heatmap_figure(rendered.blurred, rendered.aod_angles, rendered.aoa_angles, out,
                               title=title)


def _run_replay(args):
    from slam_process_tpu_torch.utils.profiling import trace

    with trace(args.profile):
        _run_replay_inner(args)


def _run_replay_inner(args):
    from slam_process_tpu_torch.io.angles import load_angle_lut

    lut = load_angle_lut(args.mapping)
    args.outdir.mkdir(parents=True, exist_ok=True)
    if args.changes and not args.paths:
        print("warning: --changes requires --paths; no change events will be written",
              file=sys.stderr)
    stats = []
    for log in args.logs:
        name, s, seconds = replay_stream(args, log)
        _save_stream_png(s.render(lut), args.outdir / f"{name}_replay.png",
                         f"streaming replay ({name})")
        stats.append(replay_exports(args, s, name, seconds))
        print(json.dumps(stats[-1]))
    print(json.dumps({"sessions": len(stats), "total_frames": sum(x["frames"] for x in stats)}))


def _seed_event_keys(events_path, with_session: bool = False) -> set:
    """Dedup keys (sweep, kind, track) of an existing JSONL feed, for a
    checkpoint resume; with ``with_session`` (the multi-log feed) each key
    starts with the row's session.  Malformed lines (the torn tail of a
    crash mid-write among them) are skipped; a torn tail, with no newline at
    its end, is closed with one, so the first append after the resume starts
    a line of its own."""
    from slam_process_tpu_torch.models.change_detection import EVENT_KINDS

    seen: set = set()
    try:
        with open(events_path, "rb+") as f:
            data = f.read()
            if data and not data.endswith(b"\n"):
                f.write(b"\n")
    except OSError:
        return seen
    for line in data.decode("utf-8", "replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            e = json.loads(line)
            key = (int(e["sweep"]), EVENT_KINDS.index(e["kind"]), int(e["track"]))
            seen.add(((e.get("session"),) + key) if with_session else key)
        except (ValueError, KeyError, TypeError):
            continue
    return seen


def _event_json_line(row, session=None) -> str:
    """One event row (the detector's [7] float64 row) as a JSONL line; the
    multi-log feed's rows start with their ``session``."""
    from slam_process_tpu_torch.models.change_detection import EVENT_KINDS

    d = {} if session is None else {"session": session}
    d.update({"sweep": int(row[0]), "clk": int(row[1]), "kind": EVENT_KINDS[int(row[2])],
              "track": int(row[3]), "aoa": round(float(row[4]), 4),
              "aod": round(float(row[5]), 4), "power": float(row[6])})
    return json.dumps(d)


def _make_event_emitter(args, session, seeded: bool = False):
    """The live scene-change feed of ``watch --events``: returns ``poll()``,
    which runs the incremental change detector over the track columns of
    the sweeps closed since the last poll and appends their events to the
    JSONL file; it returns the count written.

    The incremental detector fed one column at a time gives the batch
    table row for row, at O(sweeps closed since the last poll) per poll.
    ``seeded`` (checkpoint resume): the first poll replays the restored
    history through the detector, and the dedup set, seeded from the file,
    keeps the rows written before the crash from being appended twice."""
    from slam_process_tpu_torch.models.change_detection import IncrementalChangeDetector
    from slam_process_tpu_torch.utils.timestamps import ClkUnwrapper

    det = IncrementalChangeDetector(session._paths_spec.max_tracks,
                                    min_persist=args.min_persist, min_gone=args.min_gone,
                                    jump_deg=args.jump_deg)
    unwrap = ClkUnwrapper()
    seen = _seed_event_keys(args.events) if seeded else set()
    state = {"n": 0}

    def poll() -> int:
        n = session.n_sweeps_closed
        lo = state["n"]
        if n <= lo:
            return 0
        aoa, aod, power, obs, raw_times = session.track_columns(lo, n)
        state["n"] = n
        wrote = 0
        with open(args.events, "a") as f:
            for i in range(n - lo):
                t_u = unwrap.push(raw_times[i])
                for row in det.step(aoa[i], aod[i], power[i], obs[i], float(t_u)):
                    key = (int(row[0]), int(row[2]), int(row[3]))
                    if key in seen:
                        continue
                    seen.add(key)
                    f.write(_event_json_line(row) + "\n")
                    wrote += 1
        return wrote

    return poll


def _make_multi_event_emitter(args, session, names, seeded: bool = False):
    """The multi-log watch's one live feed: ``poll()`` reads the streams'
    closed-sweep counts (one small read), runs each advanced stream's own
    incremental detector over the track columns of its new sweeps only
    (``stream_track_columns``) and appends their events, each with a
    ``session`` field naming the stream, to the one JSONL file; it returns
    the count written.  ``seeded`` (checkpoint resume): the dedup set comes
    from the existing file, so replayed history is not appended again."""
    from slam_process_tpu_torch.models.change_detection import IncrementalChangeDetector
    from slam_process_tpu_torch.utils.timestamps import ClkUnwrapper

    spec = session._paths_spec
    s_n = len(names)
    dets = [IncrementalChangeDetector(spec.max_tracks, min_persist=args.min_persist,
                                      min_gone=args.min_gone, jump_deg=args.jump_deg)
            for _ in range(s_n)]
    unwraps = [ClkUnwrapper() for _ in range(s_n)]
    seen = _seed_event_keys(args.events, with_session=True) if seeded else set()
    lows = [0] * s_n

    def poll() -> int:
        ns = session.n_sweeps_closed_all()
        todo = [i for i in range(s_n) if int(ns[i]) > lows[i]]
        if not todo:
            return 0
        wrote = 0
        with open(args.events, "a") as f:
            for i in todo:
                hi = int(ns[i])
                aoa, aod, power, obs, raw = session.stream_track_columns(i, lows[i], hi)
                for j in range(hi - lows[i]):
                    t_u = unwraps[i].push(raw[j])
                    for row in dets[i].step(aoa[j], aod[j], power[j], obs[j], float(t_u)):
                        key = (names[i], int(row[0]), int(row[2]), int(row[3]))
                        if key in seen:
                            continue
                        seen.add(key)
                        f.write(_event_json_line(row, session=names[i]) + "\n")
                        wrote += 1
                lows[i] = hi
        return wrote

    return poll


def _dedup_export_names(paths, prefix: str = "") -> list:
    """Export names from the captures' timestamps or stems, made unique (two
    captures named live.txt in different directories must not overwrite
    each other's outputs): the naming of a multi-log watch.  ``prefix``
    (``p<id>_`` in a multi-host watch) keeps the processes' exports apart
    in a shared --outdir."""
    names = [prefix + (extract_timestamp(str(p)) or Path(p).stem) for p in paths]
    seen: dict = {}
    for i, nm in enumerate(names):
        if nm in seen:
            seen[nm] += 1
            names[i] = f"{nm}_{seen[nm]}"
        else:
            seen[nm] = 0
    return names


def _split_text_carry(buf: bytes):
    """Split a growing capture's buffer at its last whitespace:
    (tokenizable prefix or None, carry).  The capture may have written half
    a token ("1A 2" of "1A 2B "), which waits for more bytes."""
    cut = max(buf.rfind(b" "), buf.rfind(b"\n"), buf.rfind(b"\r"), buf.rfind(b"\t"))
    if cut < 0:
        return None, buf
    return bytes(buf[:cut + 1]), buf[cut + 1:]


def _reconcile_paths_flag(args, s) -> bool:
    """--paths as a restored checkpoint has it: the state decides (online
    estimation cannot be switched mid-stream), the flag only selects
    exports; a warning or a note says when they differ."""
    has = getattr(s, "_paths_spec", None) is not None
    if args.paths and not has:
        print("warning: --paths ignored — the restored checkpoint was created without "
              "online estimation", file=sys.stderr)
    elif has and not args.paths:
        print("note: the restored checkpoint carries online-estimation state; its tracks "
              "will be exported (pass --paths to silence this note)", file=sys.stderr)
    return has


def _export_stream_tracks(s, name: str, args) -> None:
    """Track and (with --changes) change exports of a streaming session with
    online paths, shared by replay and watch; its tracks equal the offline
    ones, so the offline detector applies unchanged."""
    _export_tracks(*s.path_tracks(), name, args)


def _export_tracks(tracks, times, vel, name: str, args) -> None:
    from slam_process_tpu_torch.io.xlsx import write_xlsx_table

    write_xlsx_table(args.outdir / f"{name}_stream_tracks.xlsx", TRACK_COLUMNS,
                     tracks_table(tracks, times, vel))
    if args.changes:
        events = change_events(tracks, times, args)
        out = write_xlsx_table(args.outdir / f"{name}_stream_changes.xlsx", CHANGE_COLUMNS,
                               events)
        print(f"changes={len(events)} 输出={out}")


def _add_watch(sub):
    p = sub.add_parser(
        "watch", help="live-tail a growing serial log: new bytes are tokenized and fed to "
                      "the streaming session as the capture writes them")
    p.add_argument("--log", type=Path, default=None, help="one growing capture file")
    p.add_argument("--logs", type=Path, nargs="+", default=None,
                   help="several growing capture files, tailed as one multi-stream session "
                        "on --device (each file is finalized alone on its own idle timeout; "
                        "--engine device only); one file is --log; with --coordinator this "
                        "process's captures")
    p.add_argument("--mapping", type=Path, required=True)
    p.add_argument("--outdir", type=Path, required=True)
    p.add_argument("--engine", choices=["host", "device"], default="device",
                   help="device = the streaming state machine on --device; host = the numpy "
                        "decode and corrector on the CPU")
    p.add_argument("--emit-capacity", type=int, default=None,
                   help="filtered-row ring capacity per stream (default: grows as bytes "
                        "arrive for --log; 262144 rows for several --logs, which cannot grow)")
    p.add_argument("--poll-interval", type=float, default=0.5,
                   help="seconds between file-growth polls")
    p.add_argument("--idle-timeout", type=float, default=10.0,
                   help="stop after this many seconds without growth (0 = watch until "
                        "interrupted)")
    p.add_argument("--render-every", type=float, default=0.0,
                   help="re-render the live heatmap every N seconds (0 = only at exit)")
    p.add_argument("--paths", action="store_true",
                   help="online per-sweep estimation + CLK tracks as sweeps close")
    p.add_argument("--checkpoint", type=Path, default=None,
                   help="crash-recovery state file: restored at startup when it exists; "
                        "rewritten atomically every --checkpoint-every seconds and at exit")
    p.add_argument("--checkpoint-every", type=float, default=0.0,
                   help="seconds between periodic checkpoints (0 = only at exit; requires "
                        "--checkpoint)")
    p.add_argument("--events", type=Path, default=None,
                   help="with --paths: append scene-change events (birth / death / jump / "
                        "LoS handover) to this JSONL file as the capture's sweeps close")
    mh = p.add_argument_group(
        "multi-host", "one process of a watch cluster: every process tails its own --logs and "
        "all captures advance in lockstep rounds (gloo process group); SIGINT to every "
        "process drains and finalizes its captures")
    mh.add_argument("--coordinator", type=str, default=None,
                    help="host:port of process 0's rendezvous")
    mh.add_argument("--num-processes", type=int, default=None)
    mh.add_argument("--process-id", type=int, default=None)
    mh.add_argument("--local-devices", type=int, default=None,
                    help="mesh positions of this process (default 1)")
    _add_change_args(p, gate="--paths")
    _add_device(p)
    p.set_defaults(fn=_run_watch)


def check_watch_flags(args) -> bool:
    """The JAX CLI's flag checks, in its order.  True for a multi-stream
    watch (several --logs, or a multi-host watch: --coordinator), False for
    one capture (``args.log`` set)."""
    if (args.log is None) == (args.logs is None):
        raise SystemExit("watch needs exactly one of --log / --logs")
    if args.checkpoint_every and not args.checkpoint:
        raise SystemExit("--checkpoint-every requires --checkpoint (no state file to write to)")
    if args.emit_capacity is not None and args.emit_capacity <= 0:
        raise SystemExit("--emit-capacity must be a positive row count")
    if args.coordinator is not None:
        if args.logs is None:
            raise SystemExit("--coordinator requires --logs (each process tails its own "
                             "capture set)")
        if args.num_processes is None or args.process_id is None:
            raise SystemExit("--coordinator requires --num-processes and --process-id")
        if args.engine != "device":
            raise SystemExit("multi-host watch requires --engine device")
        if args.checkpoint:
            raise SystemExit("--checkpoint is not supported in multi-host watch mode (run "
                             "per-host watches without --coordinator for it)")
        if args.events is not None and not args.paths:
            raise SystemExit("--events requires --paths (the events derive from the online "
                             "tracks)")
        return True
    if args.num_processes is not None or args.process_id is not None:
        raise SystemExit("--num-processes/--process-id require --coordinator (multi-host "
                         "watch mode)")
    multi = args.logs is not None and len(args.logs) > 1
    if multi and args.engine != "device":
        raise SystemExit("watch with multiple --logs requires --engine device (one vmapped "
                         "session)")
    if args.logs is not None and not multi:
        args.log = args.logs[0]
    if args.events is not None and not args.paths and not (
            args.checkpoint and args.checkpoint.exists()):
        # With a checkpoint to restore, its state decides whether there are
        # online paths (_reconcile_paths_flag).
        raise SystemExit("--events requires --paths (the events derive from the online "
                         "tracks)")
    return multi


class Watch:
    """``watch --log``'s state and steps: open (or restore) the session,
    ``run`` the poll loop to its end (finalized, checkpointed, the last
    events written), ``session.render``, then ``export``; ``_run_watch``
    adds the PNG and the summary line."""

    def __init__(self, args):
        from slam_process_tpu_torch.parallel.streaming_device import make_paths_spec

        self.args = args
        args.outdir.mkdir(parents=True, exist_ok=True)
        self.name = extract_timestamp(str(args.log)) or args.log.stem
        if args.changes and not args.paths:
            print("warning: --changes requires --paths; no change events will be written",
                  file=sys.stderr)
        self.pos, self.text_carry = 0, b""
        self.fed_tokens = self.events_written = 0
        self.completed = restored = False
        if args.engine == "device":
            from slam_process_tpu_torch.parallel.streaming_device import (
                DeviceStreamingSession as Sess)
        else:
            from slam_process_tpu_torch.parallel.streaming import StreamingSession as Sess
        if args.checkpoint and args.checkpoint.exists():
            # The checkpoint holds the session and this loop's cursor (file
            # offset and the tokenizer's text carry).  A checkpoint of the
            # other engine raises the restore's kind-mismatch error.
            s = (Sess.restore(args.checkpoint, device=args.device) if args.engine == "device"
                 else Sess.restore(args.checkpoint))
            restored = True
            self.completed = s._finalized
            if self.completed:
                # A crash after the finalize (while exporting) must not
                # strand the capture's state: re-export from the checkpoint.
                print(f"{args.checkpoint} is from a COMPLETED watch; re-exporting its "
                      "results", file=sys.stderr)
            args.paths = _reconcile_paths_flag(args, s)
            if args.engine == "device" and not s.collect_filtered:
                raise SystemExit(f"{args.checkpoint} was created without collect_filtered; "
                                 "watch needs the emit ring to export the filtered table")
            if (args.emit_capacity is not None and args.engine == "device"
                    and s._ecap != args.emit_capacity):
                print(f"warning: --emit-capacity {args.emit_capacity} ignored — the "
                      f"checkpoint's ring capacity ({s._ecap}) wins on resume", file=sys.stderr)
            cursor = s.checkpoint_extra or {}
            self.pos = int(cursor.get("pos", 0))
            self.text_carry = bytes(cursor.get("text_carry", b""))
            print(f"resumed from {args.checkpoint} at byte {self.pos}", file=sys.stderr)
        else:
            cp = make_paths_spec(args.mapping) if args.paths else None
            # Unknown final size: the device ring grows as bytes arrive
            # unless --emit-capacity pins it.
            s = (Sess(collect_filtered=True, collect_paths=cp,
                      emit_capacity=args.emit_capacity, device=args.device)
                 if args.engine == "device" else Sess(collect_paths=cp))
        self.session = s
        self.emitter = None
        if args.events is not None and args.paths:
            args.events.parent.mkdir(parents=True, exist_ok=True)
            self.emitter = _make_event_emitter(args, s, seeded=restored)
        elif args.events is not None:
            # Only when a restored checkpoint had no online paths.
            print("warning: --events ignored — the restored checkpoint was created without "
                  "online estimation", file=sys.stderr)

    def save_checkpoint(self) -> None:
        if self.args.checkpoint:
            self.session.save_checkpoint(self.args.checkpoint, extra={
                "pos": self.pos, "text_carry": self.text_carry})

    def _feed(self, tokens) -> None:
        if len(tokens):
            self.session.feed(tokens)
            self.fed_tokens += len(tokens)
            if self.emitter:
                self.events_written += self.emitter()

    def _read_growth(self):
        """The bytes the capture wrote since the last poll; None when it did
        not grow (or was rotated away between the size poll and the read)."""
        try:
            size = os.path.getsize(self.args.log)
        except OSError:
            return None
        if size <= self.pos:
            return None
        try:
            with open(self.args.log, "rb") as f:
                f.seek(self.pos)
                data = f.read(size - self.pos)
        except OSError:
            return None
        self.pos = size
        return data

    def poll(self) -> bool:
        """One poll: tokenize what the capture wrote since the last one (a
        token cut at the end waits in the text carry) and feed it, with the
        events of the sweeps it closed; False when the file did not grow."""
        from slam_process_tpu_torch.io.hexlog import tokenize_hex

        data = self._read_growth()
        if data is None:
            return False
        prefix, self.text_carry = _split_text_carry(self.text_carry + data)
        if prefix is not None:
            self._feed(tokenize_hex(prefix))
        return True

    def run(self) -> None:
        """Poll until the idle timeout (or an interrupt), then feed the
        tokenizer's tail, finalize, checkpoint and write the last events."""
        import time

        from slam_process_tpu_torch.io.hexlog import tokenize_hex

        args = self.args
        last_growth = last_render = last_ckpt = time.monotonic()
        try:
            while not self.completed:
                now = time.monotonic()
                if self.poll():
                    last_growth = now
                elif args.idle_timeout and now - last_growth > args.idle_timeout:
                    break
                if args.render_every and now - last_render >= args.render_every:
                    self.write_png()
                    last_render = now
                if args.checkpoint_every and now - last_ckpt >= args.checkpoint_every:
                    self.save_checkpoint()
                    last_ckpt = now
                time.sleep(args.poll_interval)
        except KeyboardInterrupt:
            pass
        if not self.completed:
            tokens = tokenize_hex(bytes(self.text_carry))
            if len(tokens):
                self._feed(tokens)
                self.text_carry = b""
            self.session.finalize()
            self.save_checkpoint()
        if self.emitter:
            self.events_written += self.emitter()   # the sweep the flush closed

    def png_path(self) -> Path:
        return self.args.outdir / f"{self.name}_watch.png"

    def write_png(self, rendered=None) -> Path:
        from slam_process_tpu_torch.io.angles import load_angle_lut

        if rendered is None:
            rendered = self.session.render(load_angle_lut(self.args.mapping))
        return _save_stream_png(rendered, self.png_path(), f"live watch ({self.name})")

    def export(self) -> dict:
        """Write the filtered table (and with --paths the tracks and
        changes); returns the summary line."""
        from slam_process_tpu_torch.io.schemas import write_filtered_table

        s = self.session
        write_filtered_table(self.args.outdir / f"{self.name}_filtered.xlsx", s.filtered)
        if self.args.paths:
            _export_stream_tracks(s, self.name, self.args)
        summary = {"session": self.name, "bytes_seen": self.pos, "tokens": self.fed_tokens,
                   "frames": int(s.n_frames), "kept": int(s.n_kept),
                   "sweeps": int(s.n_groups), "png": str(self.png_path())}
        if self.emitter:
            summary["events"] = self.events_written
        return summary


class MultiWatch:
    """``watch --logs A B ...``'s state and steps: S growing captures tailed
    as one ``MultiStreamingSession``.  Each capture keeps its own cursor,
    text carry and idle timeout; one that stops growing is fed its
    tokenizer's tail and finalized alone while the others go on.  ``run``
    polls to the end (every stream finalized, the checkpoint written, the
    last events appended), then ``write_pngs`` and ``export`` (per-stream
    filtered tables, and with --paths tracks and changes);
    ``--checkpoint`` covers every stream and cursor."""

    def __init__(self, args):
        from slam_process_tpu_torch.parallel.streaming_device import (
            MultiStreamingSession, make_paths_spec)

        self.args = args
        if args.changes and not args.paths:
            print("warning: --changes requires --paths; no change events will be written",
                  file=sys.stderr)
        self.logs = list(args.logs)
        n = len(self.logs)
        self.names = _dedup_export_names(self.logs)
        args.outdir.mkdir(parents=True, exist_ok=True)
        self.pos, self.carry = [0] * n, [b""] * n
        restored = False
        if args.checkpoint and args.checkpoint.exists():
            s = MultiStreamingSession.restore(args.checkpoint, device=args.device)
            restored = True
            if s.n_streams != n:
                raise SystemExit(f"{args.checkpoint} holds {s.n_streams} streams, --logs "
                                 f"names {n}")
            args.paths = _reconcile_paths_flag(args, s)
            if args.emit_capacity is not None and s._ecap != args.emit_capacity:
                print(f"warning: --emit-capacity {args.emit_capacity} ignored — the "
                      f"checkpoint's ring capacity ({s._ecap}) wins on resume", file=sys.stderr)
            cursor = s.checkpoint_extra or {}
            self.pos = [int(x) for x in cursor.get("pos", self.pos)]
            self.carry = [bytes(x) for x in cursor.get("text_carry", self.carry)]
            print(f"resumed from {args.checkpoint}: cursors {self.pos}, "
                  f"{int(np.sum(s._stream_finalized))} stream(s) already finalized",
                  file=sys.stderr)
        else:
            cp = make_paths_spec(args.mapping) if args.paths else None
            s = MultiStreamingSession(n, collect_paths=cp, emit_capacity=args.emit_capacity
                                      or (1 << 18), device=args.device)
        self.session = s
        self.emitter = None
        self.events_written = 0
        if args.events is not None and args.paths:
            args.events.parent.mkdir(parents=True, exist_ok=True)
            self.emitter = _make_multi_event_emitter(args, s, self.names, seeded=restored)
        elif args.events is not None:
            print("warning: --events ignored — the restored checkpoint was created without "
                  "online estimation", file=sys.stderr)

    def save_checkpoint(self) -> None:
        if self.args.checkpoint:
            self.session.save_checkpoint(self.args.checkpoint, extra={
                "pos": list(self.pos), "text_carry": list(self.carry)})

    def _read_growth(self, i: int):
        """What capture ``i`` wrote since the last poll; None when it did
        not grow, or could not be read."""
        log = self.logs[i]
        try:
            size = os.path.getsize(log)
        except OSError:
            return None
        if size <= self.pos[i]:
            return None
        try:
            with open(log, "rb") as f:
                f.seek(self.pos[i])
                data = f.read(size - self.pos[i])
        except OSError:
            return None
        self.pos[i] = size
        return data

    def run(self) -> None:
        """Poll every live capture until each has been idle for the idle
        timeout (or an interrupt), then finalize what is still open,
        checkpoint and write the last events."""
        import time

        from slam_process_tpu_torch.io.hexlog import tokenize_hex

        args, s = self.args, self.session
        n = len(self.logs)
        done = np.asarray(s._stream_finalized).copy()
        now0 = time.monotonic()
        last_growth, last_render, last_ckpt = [now0] * n, now0, now0
        try:
            while not done.all():
                now = time.monotonic()
                chunks, to_finalize = [b""] * n, []
                for i in np.nonzero(~done)[0]:
                    data = self._read_growth(i)
                    if data is not None:
                        prefix, self.carry[i] = _split_text_carry(self.carry[i] + data)
                        if prefix is not None:
                            chunks[i] = tokenize_hex(prefix)
                        last_growth[i] = now
                    elif args.idle_timeout and now - last_growth[i] > args.idle_timeout:
                        # This capture stopped: its tokenizer tail goes in this
                        # round, then it is closed alone.
                        chunks[i] = tokenize_hex(bytes(self.carry[i]))
                        self.carry[i] = b""
                        to_finalize.append(int(i))
                fed = False
                if any(len(c) for c in chunks):
                    s.feed(chunks)
                    fed = True
                if to_finalize:
                    s.finalize_streams(to_finalize)
                    done[to_finalize] = True
                    fed = True
                    print(f"stream(s) {to_finalize} finalized ({(~done).sum()} still live)",
                          file=sys.stderr)
                if self.emitter and fed:
                    self.events_written += self.emitter()
                if args.render_every and now - last_render >= args.render_every:
                    self.write_pngs()
                    last_render = now
                if args.checkpoint_every and now - last_ckpt >= args.checkpoint_every:
                    self.save_checkpoint()
                    last_ckpt = now
                time.sleep(args.poll_interval)
        except KeyboardInterrupt:
            pass
        if not done.all():
            tails = [b"" if done[i] else tokenize_hex(bytes(self.carry[i])) for i in range(n)]
            self.carry = [b""] * n
            if any(len(t) for t in tails):
                s.feed(tails)
            s.finalize()
        self.save_checkpoint()
        if self.emitter:
            self.events_written += self.emitter()   # the sweeps the flushes closed

    def render(self, i: int):
        """Stream ``i``'s heatmap from its running sums, rasterized on the
        session's device (K3 on CUDA)."""
        from slam_process_tpu_torch.io.angles import load_angle_lut
        from slam_process_tpu_torch.ops.scene import grid_from_sums_np
        from slam_process_tpu_torch.parallel.streaming_device import render_grid

        _, _, _, sums, counts, _ = self.session.results()
        grid = grid_from_sums_np(sums[i].astype(np.float64), counts[i].astype(np.int64))
        return render_grid(grid, load_angle_lut(self.args.mapping), self.session.device)

    def png_path(self, i: int) -> Path:
        return self.args.outdir / f"{self.names[i]}_watch.png"

    def write_pngs(self) -> list:
        return [_save_stream_png(self.render(i), self.png_path(i),
                                 f"live watch ({self.names[i]})")
                for i in range(len(self.logs))]

    def export(self) -> list:
        """Write each stream's filtered table (and with --paths its tracks
        and changes); returns the per-stream summary lines and the totals
        line."""
        from slam_process_tpu_torch.io.schemas import write_filtered_table

        s = self.session
        nf, nk, ng, _, _, _ = s.results()
        stats = []
        for i, name in enumerate(self.names):
            write_filtered_table(self.args.outdir / f"{name}_filtered.xlsx",
                                 s.stream_filtered(i))
            if self.args.paths:
                _export_tracks(*s.stream_tracks(i), name, self.args)
            stats.append({"session": name, "bytes_seen": self.pos[i], "frames": int(nf[i]),
                          "kept": int(nk[i]), "sweeps": int(ng[i]),
                          "png": str(self.png_path(i))})
        totals = {"streams": len(stats), "total_frames": sum(x["frames"] for x in stats)}
        if self.emitter:
            totals["events"] = self.events_written
        return stats + [totals]


# What a multi-host watch writes to stderr once it has fed everything its
# captures held, followed by the bytes read from each.
WATCH_CAUGHT_UP = "multi-host watch: caught up, bytes read"


class MultihostWatch(MultiWatch):
    """``watch --coordinator``'s state and steps in one process of a watch
    cluster: this process's --logs as its local streams of one
    ``parallel/multihost.MultihostMultiStream``, exports named ``p<id>_...``.

    ``run``'s tick is the same collective sequence in every process: read
    and tokenize each live capture's growth; one all-gather of (wants a
    finalize, all done); ``feed`` (its window rounds agreed inside); one
    collective masked flush when any process wants one; stop when every
    process is done.  A capture ends on its idle timeout, or on SIGINT:
    the handler only sets a flag, and the next tick reads nothing more and
    finalizes every live capture with its text carry (as the JAX package
    does), while the process keeps taking part until every process is done.
    Each time a tick finds no live capture grown, after one that did, the
    process writes ``WATCH_CAUGHT_UP`` to stderr: everything read so far
    has been fed.  No checkpoints (the flag checks refuse them)."""

    def __init__(self, args):
        import signal

        from slam_process_tpu_torch.parallel.multihost import (
            MultihostMultiStream, global_data_mesh, initialize_multihost)
        from slam_process_tpu_torch.parallel.streaming_device import make_paths_spec

        self.args = args
        self.interrupted = False
        self._old_sigint = signal.signal(signal.SIGINT, self._on_sigint)
        if args.changes and not args.paths:
            print("warning: --changes requires --paths; no change events will be written",
                  file=sys.stderr)
        initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                             args.local_devices, device=args.device)
        self.logs = list(args.logs)
        n = len(self.logs)
        self.names = _dedup_export_names(self.logs, prefix=f"p{args.process_id}_")
        args.outdir.mkdir(parents=True, exist_ok=True)
        self.pos, self.carry = [0] * n, [b""] * n
        mesh = global_data_mesh(model=1)
        cp = make_paths_spec(args.mapping) if args.paths else None
        self.session = s = MultihostMultiStream(mesh, n, collect_paths=cp,
                                                emit_capacity=args.emit_capacity or (1 << 18))
        self.emitter = None
        self.events_written = 0
        if args.events is not None and args.paths:
            args.events.parent.mkdir(parents=True, exist_ok=True)
            self.emitter = _make_multi_event_emitter(args, s, self.names)
        print(f"multi-host watch: process {args.process_id}/{args.num_processes}, {n} local "
              f"stream(s), {s.n_streams_real} global ({s.n_streams} padded) over a "
              f"{tuple(mesh.shape.values())} mesh", file=sys.stderr, flush=True)

    def _on_sigint(self, signum, frame) -> None:
        self.interrupted = True

    def close(self) -> None:
        """Leave the process group after a last barrier (so no peer is left
        in a collective) and restore the SIGINT handler."""
        import signal

        from slam_process_tpu_torch.parallel.multihost import shutdown_multihost

        try:
            shutdown_multihost()
        finally:
            signal.signal(signal.SIGINT, self._old_sigint)

    def run(self) -> None:
        import time

        from slam_process_tpu_torch.io.hexlog import tokenize_hex
        from slam_process_tpu_torch.parallel.multihost import allgather_host

        args, s = self.args, self.session
        n = len(self.logs)
        done = np.zeros(n, bool)
        now0 = time.monotonic()
        last_growth, last_render = [now0] * n, now0
        grew = True
        while True:
            now = time.monotonic()
            chunks, to_finalize = [b""] * n, []
            force = self.interrupted
            live = np.nonzero(~done)[0]
            reads = {i: None if force else self._read_growth(i) for i in live}
            for i, data in reads.items():
                if data is not None:
                    last_growth[i] = now
                    prefix, self.carry[i] = _split_text_carry(self.carry[i] + data)
                    if prefix is not None:
                        chunks[i] = tokenize_hex(prefix)
                elif force or (args.idle_timeout and now - last_growth[i] > args.idle_timeout):
                    chunks[i] = tokenize_hex(bytes(self.carry[i]))
                    self.carry[i] = b""
                    to_finalize.append(int(i))
            if grew and not force and all(d is None for d in reads.values()):
                print(f"{WATCH_CAUGHT_UP} {self.pos}", file=sys.stderr, flush=True)
            grew = any(d is not None for d in reads.values())
            all_done = int(done.sum()) + len(to_finalize) == n
            sync = allgather_host([int(bool(to_finalize)), int(all_done)])
            s.feed(chunks)
            if sync[:, 0].any():
                s.finalize_streams(to_finalize)
                if to_finalize:
                    done[to_finalize] = True
                    print(f"stream(s) {to_finalize} finalized ({(~done).sum()} still live)",
                          file=sys.stderr)
            if self.emitter:
                self.events_written += self.emitter()
            if sync[:, 1].all():
                break
            if args.render_every and now - last_render >= args.render_every:
                self.write_pngs()
                last_render = now
            time.sleep(args.poll_interval)
        s.finalize()   # a no-op flush: every stream is closed; keeps the processes aligned
        if self.emitter:
            self.events_written += self.emitter()

    def render(self, i: int):
        """Local stream ``i``'s heatmap, rasterized on this process's device."""
        from slam_process_tpu_torch.io.angles import load_angle_lut
        from slam_process_tpu_torch.ops.scene import grid_from_sums_np
        from slam_process_tpu_torch.parallel.streaming_device import render_grid

        _, _, _, sums, counts, _ = self.session.local_results()
        grid = grid_from_sums_np(sums[i].astype(np.float64), counts[i].astype(np.int64))
        return render_grid(grid, load_angle_lut(self.args.mapping), self.session._ms.device)

    def export(self) -> list:
        """Write each local stream's filtered table (and with --paths its
        tracks and changes); returns the per-stream summary lines and the
        process's totals line."""
        from slam_process_tpu_torch.io.schemas import write_filtered_table

        s, args = self.session, self.args
        nf, nk, ng, _, _, _ = s.local_results()
        stats = []
        for i, name in enumerate(self.names):
            write_filtered_table(args.outdir / f"{name}_filtered.xlsx",
                                 s.local_stream_filtered(i))
            if args.paths:
                _export_tracks(*s.local_stream_tracks(i), name, args)
            stats.append({"session": name, "process": args.process_id,
                          "bytes_seen": self.pos[i], "frames": int(nf[i]), "kept": int(nk[i]),
                          "sweeps": int(ng[i]), "png": str(self.png_path(i))})
        totals = {"process": args.process_id, "local_streams": len(stats),
                  "global_streams": s.n_streams_real,
                  "total_frames": sum(x["frames"] for x in stats)}
        if self.emitter:
            totals["events"] = self.events_written
        return stats + [totals]


def _run_watch(args):
    multi = check_watch_flags(args)
    if args.coordinator is not None:
        w = MultihostWatch(args)
        try:
            w.run()
            w.write_pngs()
            for line in w.export():
                print(json.dumps(line))
        finally:
            w.close()
        return
    if multi:
        w = MultiWatch(args)
        w.run()
        w.write_pngs()
        for line in w.export():
            print(json.dumps(line))
        return
    w = Watch(args)
    w.run()
    w.write_png()
    print(json.dumps(w.export()))


# -- run-config ---------------------------------------------------------------


def _add_run_config(sub):
    from slam_process_tpu_torch.pipeline.configs import NAMED_CONFIGS

    p = sub.add_parser("run-config", help="run one of the five named benchmark configs")
    p.add_argument("name", choices=list(NAMED_CONFIGS))
    p.add_argument("--data-dir", type=Path, default=None)
    p.add_argument("--mapping", type=Path, default=None)
    p.add_argument("--outdir", type=Path, default=None)
    _add_device(p)
    p.set_defaults(fn=_run_named_config)


def _run_named_config(args):
    from slam_process_tpu_torch.pipeline.configs import run_named_config

    result = run_named_config(args.name, args.data_dir, args.mapping, args.outdir,
                              device=args.device)
    print(json.dumps(result, default=str))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="slam_process_tpu_torch",
                                     description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    for add in (_add_decode, _add_correct, _add_heatmap, _add_session, _add_estimate,
                _add_replay, _add_watch, _add_run_config):
        add(sub)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logger = get_logger()
    try:
        args.fn(args)
    except (OSError, ValueError, KeyError, IndexError, zipfile.BadZipFile) as e:
        logger.error("处理失败: %s", e)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
