"""The main path's command-line interface, the port of
``slam_process_tpu/pipeline/cli.py``'s ``decode``, ``correct``, ``heatmap``
and ``session`` commands:

    python -m slam_process_tpu_torch.pipeline.cli decode  IN.txt [OUT.xlsx] [--format v1|v2|v3]
    python -m slam_process_tpu_torch.pipeline.cli correct --input IN.xlsx|IN.txt [--output OUT]
                                                            [--in-place] [--run-tests]
    python -m slam_process_tpu_torch.pipeline.cli heatmap --input IN --mapping beam_angle.xlsx
                                                            [--variant v1|v2|v3] ...
    python -m slam_process_tpu_torch.pipeline.cli session --log IN.txt --mapping ... --outdir DIR

Every command runs its stages on the card (decode K1, corrector K2, raster
K3); ``--device cpu`` runs the plain PyTorch versions instead, the one
option the JAX CLI lacks.  The v1 / v2 wire formats decode with numpy in
both packages.  The heatmap PNG needs matplotlib; a colormap other than
viridis needs it too.
"""

from __future__ import annotations

import argparse
import json
import sys
import zipfile
from pathlib import Path

from slam_process_tpu_torch.config import RenderConfig, SceneConfig
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="slam_process_tpu_torch",
                                     description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    for add in (_add_decode, _add_correct, _add_heatmap, _add_session):
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
