"""The main path's command-line interface, the port of
``slam_process_tpu/pipeline/cli.py``'s ``decode``, ``correct``, ``heatmap``
and ``session`` commands:

    python -m slam_process_tpu_torch.pipeline.cli decode  IN.txt [OUT.xlsx] [--format v1|v2|v3]
    python -m slam_process_tpu_torch.pipeline.cli correct --input IN.xlsx|IN.txt [--output OUT]
                                                            [--in-place] [--run-tests]
    python -m slam_process_tpu_torch.pipeline.cli heatmap --input IN --mapping beam_angle.xlsx
                                                            [--variant v1|v2|v3] ...
    python -m slam_process_tpu_torch.pipeline.cli session --log IN.txt --mapping ... --outdir DIR
    python -m slam_process_tpu_torch.pipeline.cli estimate --input IN.txt|IN.xlsx --mapping ...
                                                 [--model nn_omp|nn_omp_v1|nn_omp_v14|nn_omp_v15|
                                                  nn_omp_v16] [--engine device|host]
                                                 [--per-sweep | --tracks [--changes]]

Every command runs its stages on the card (decode K1, corrector K2, raster
K3, per-sweep sums K4, tracker K6, the estimators in PyTorch); ``--device
cpu`` runs the plain PyTorch versions instead, the one option the JAX CLI
lacks.  ``estimate --engine`` defaults to ``device`` (the JAX CLI's
default is ``host``, the float64 numpy oracle).  The v1 / v2 wire formats
decode with numpy in both packages.  The heatmap PNG, the estimation
figure and the track figure need matplotlib; a colormap other than viridis
needs it too.
"""

from __future__ import annotations

import argparse
import json
import sys
import zipfile
from pathlib import Path

from slam_process_tpu_torch.config import RenderConfig, SceneConfig
from slam_process_tpu_torch.models.registry import FLAVORS, NOT_PORTED, run_estimator
from slam_process_tpu_torch.pipeline.session import Session
from slam_process_tpu_torch.utils.logging import StageCounters, get_logger


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
    p.add_argument("--profile", type=Path, default=None,
                   help="write a torch.profiler trace into this directory")
    _add_device(p)
    p.set_defaults(fn=_run_session)


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
    p.add_argument("--model", default="nn_omp", choices=FLAVORS + NOT_PORTED,
                   help="the NN-OMP flavors are ported; the other names raise "
                        "NotImplementedError")
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
    coercing (only nn_omp / sm_sic estimate per sweep, always on --device;
    sm_sic raises as the per-sweep estimator's setup does)."""
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


def write_changes(out, tracks, times, args):
    """Detect the scene changes of ``tracks``, write their xlsx beside
    ``out`` and return (its path, the printed line)."""
    import numpy as np

    from slam_process_tpu_torch.io.xlsx import write_xlsx_table
    from slam_process_tpu_torch.models.change_detection import (
        EVENT_KINDS, detect_scene_changes_np, scene_change_events)

    changes = detect_scene_changes_np(tracks, min_persist=args.min_persist,
                                      min_gone=args.min_gone, jump_deg=args.jump_deg)
    events = scene_change_events(changes, tracks, times)
    ev_path = Path(out).with_name(Path(out).stem + "_changes.xlsx")
    write_xlsx_table(ev_path, CHANGE_COLUMNS, events)
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
    rows = []
    for sweep in np.nonzero(sweep_valid)[0]:
        for k in np.nonzero(paths.valid[sweep])[0]:
            rows.append([sweep, times[sweep], k, paths.aoa[sweep][k], paths.aod[sweep][k],
                         paths.power[sweep][k]])
    table = np.asarray(rows, dtype=np.float64).reshape(-1, 6)
    out = args.output or (args.input.parent / f"{s.name}_sweep_paths.xlsx")
    # write_xlsx_table may retry to <stem>_out.xlsx on PermissionError;
    # report the path it actually wrote.
    out = write_xlsx_table(out, ["Sweep", "CLK", "Path", "AoA", "AoD", "Power"], table)
    print(f"sweeps={int(sweep_valid.sum())}/{len(sweep_valid)} paths={len(rows)} 输出={out}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="slam_process_tpu_torch",
                                     description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    for add in (_add_decode, _add_correct, _add_heatmap, _add_session, _add_estimate):
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
