"""The controls: the reference put in the program's place, one step below
the precision the configuration states, judged as a run is judged.

    python3 -m portbench.control --workload <cell> --seeds 11 12 13 [--dtype bfloat16]

For each seed the cell's traffic is made as a run makes it, and the
outputs a run would read from the program are computed by the plain
reference instead, with every float step in ``--dtype`` (bfloat16 below
the configuration's float32): the offline cell's cell means, blur, norm
and colours; a paths cell's NN-OMP (its own picks, refits and powers) and
the tracks of those paths.  The same comparison then judges these
outputs; a control must come out not correct.  ``--dtype float64`` puts
the reference itself in the program's place, which must come out correct.
One line of JSON per seed: the numbers compared with their limits.
Benchmark runs never run this; it serves the limits in ``PERF.md``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch


def _offline(cfg, wl, seed, dtype, dev):
    from portbench.reference import judge
    from portbench.reference.pipeline import log_reference
    from portbench.traffic.campaign import log_shapes, make_campaign

    p = wl["traffic"]
    shapes = log_shapes(cfg, seed)
    refs = [[log_reference(raw, cfg, dev) for raw in make_campaign(cfg, shapes, seed, c)]
            for c in range(p["campaigns"])]
    outs = []
    for c, rs in enumerate(refs):
        means, rgba, norm_t = judge.raster_refs(rs, cfg["pipeline"]["blur_sigma"], dtype)
        outs.append((c, [SimpleNamespace(n_frames=r.n_frames, correct_overflow=r.overflow,
                                         n_kept=r.n_kept, counts=r.counts, mean_grid=means[i],
                                         rgba=rgba[i].astype(np.float32), norm_t=norm_t[i])
                         for i, r in enumerate(rs)]))
    return judge.offline(cfg, wl["limits"], refs, outs)


def _live(cfg, wl, seed, dtype, dev):
    from portbench.reference import judge
    from portbench.reference import paths as P
    from portbench.reference.pipeline import log_reference
    from portbench.traffic.campaign import log_shapes, make_campaign

    p = wl["traffic"]
    if not p["paths"]:
        raise ValueError("a replay without the paths has integer outputs alone: it has no "
                         "lower precision to run in, and needs a control of its own")
    logs = make_campaign(cfg, log_shapes(cfg, seed), seed, 0)
    refs = [log_reference(raw, cfg, dev) for raw in logs]
    pc = cfg["paths"]
    d = P.dictionary(np.linspace(*cfg["angles_deg"]), pc["grid_res"], pc["beam_width"],
                     device=dev)
    records = []
    for log, r in enumerate(refs):
        sw = P.sweeps_of(r)
        own = P.nn_omp(d, P.filled_scenes(sw.sums, sw.counts, dtype, dev), pc["max_paths"], dtype)
        t = P.track(own.aoa, own.aod, own.power, own.valid, pc["max_tracks"], pc["gate_deg"])
        rec = dict(log=log, n_frames=r.n_frames, n_kept=r.n_kept, n_groups=r.corr.n_groups,
                   overflow=r.overflow, sums=r.sums, counts=r.counts, aoa=own.aoa, aod=own.aod,
                   power=own.power, valid=own.valid, n_iters=own.n_iters, aoa_idx=own.aoa_idx,
                   aod_idx=own.aod_idx, sweep_valid=np.ones(len(sw.times), bool),
                   trk_aoa=t.aoa, trk_aod=t.aod, trk_pow=t.power, trk_obs=t.observed,
                   trk_created=t.created, trk_count=t.count, times=P.unwrap_clk(sw.times))
        records.append(rec)
    checks, _ = judge.live(cfg, wl["limits"], refs, records, dev)
    return checks


def control(name: str, seed: int, dtype, root: Path, device=None) -> dict:
    from portbench.harness import cell_files

    _, wl, cfg = cell_files(name, root)
    dev = device or ("cuda" if torch.cuda.is_available() else "cpu")
    checks = (_offline if wl["driver"] == "offline" else _live)(cfg, wl, seed, dtype, dev)
    return {"workload": name, "seed": seed, "dtype": str(dtype).replace("torch.", ""),
            "correct": all(v <= lim for _, v, lim in checks),
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    dtype = getattr(torch, args.dtype)
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed, dtype, root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
