"""One process of the port's two-process gloo checks (tests/test_torch_multihost.py).

Usage: python tests/_torch_multihost_worker.py <mode> <pid> <nproc> <host:port> <out.npz>
       <angles.xlsx>

Modes, each on the CPU with two local mesh positions per process:

  * ``batched``: ``run_batched_multihost`` over this process's two of the
    four ``BATCH`` sessions on a (2, 2) global mesh (model = 2);
  * ``estimate``: ``estimate_sessions_multihost`` (v1-7, grid 0.5) over
    this process's two of the four ``ESTIMATE`` sessions, model = 2;
  * ``stream``: ``MultihostMultiStream`` over the three ``STREAMS`` split
    2 / 1, with ``collect_paths`` and an emit ring; process 0 finalizes its
    stream 1 alone after two rounds (the others finalize nothing then);
  * ``lonely``: joins a group of ``nproc`` that no peer joins, with a 3 s
    timeout (it must raise).

Writes this process's results to ``out.npz``.  Imports no JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes  # noqa: E402

BATCH = [dict(n_groups=g, frames_per_beam=2, baselines_per_group=5, seed=s, junk_frac=0.05)
         for g, s in zip((2, 4, 3, 5), range(60, 64))]
BOUNDS = dict(max_groups=16, max_baselines_per_group=32)
ESTIMATE = [dict(n_groups=3, frames_per_beam=2, baselines_per_group=5, seed=s, n_paths=3)
            for s in range(70, 74)]
STREAMS = [dict(n_groups=g, frames_per_beam=3, baselines_per_group=5, junk_frac=0.05, seed=s,
                n_paths=3) for g, s in zip((5, 3, 4), range(80, 83))]
STREAM_SPLIT = ([0, 1], [2])
CHUNK, STEP, ECAP = 1 << 12, 6000, 1 << 13
SPEC = dict(s_step=8, grid_res=2.0)


def stream_rounds(raws):
    """[(chunks of every stream, streams finalized after this round)]: the
    schedule both the two processes and the single-process reference run."""
    end = max(len(r) for r in raws)
    rounds = []
    for k, off in enumerate(range(0, end, STEP)):
        chunks = [b"" if (i == 1 and k >= 2) else bytes(r[off:off + STEP])
                  for i, r in enumerate(raws)]
        rounds.append((chunks, [1] if k == 1 else []))
    return rounds


def session_from_bytes(raw, path: Path):
    from slam_process_tpu_torch.pipeline.session import Session
    from slam_process_tpu_torch.utils.synthetic import to_hex_text

    path.write_bytes(to_hex_text(raw))
    return Session.from_log(path, device="cpu")


def main() -> None:
    mode, pid, nproc, coord, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4], Path(sys.argv[5])
    angles = sys.argv[6]
    from slam_process_tpu_torch.parallel import multihost as mh

    if mode == "lonely":
        mh.initialize_multihost(coord, nproc, pid, 2, device="cpu", timeout_s=3)
        return
    mh.initialize_multihost(coord, nproc, pid, 2, device="cpu")
    res = {}
    if mode == "batched":
        raws = [synthetic_session_bytes(**c) for c in BATCH][2 * pid:2 * pid + 2]
        got = mh.run_batched_multihost(mh.global_data_mesh(model=2), raws, **BOUNDS)
        res = {f: mh.local_shard(getattr(got, f)) for f in got._fields}
    elif mode == "estimate":
        sessions = [session_from_bytes(synthetic_session_bytes(**c), out.parent / f"e{pid}_{k}.txt")
                    for k, c in enumerate(ESTIMATE[2 * pid:2 * pid + 2])]
        got = mh.estimate_sessions_multihost(sessions, angles, mh.global_data_mesh(model=2),
                                             grid_res=0.5)
        res = {f: mh.local_shard(getattr(got, f)) for f in got._fields}
    elif mode == "stream":
        from slam_process_tpu_torch.parallel.streaming_device import make_paths_spec

        raws = [synthetic_session_bytes(**c) for c in STREAMS]
        mine = STREAM_SPLIT[pid]
        s = mh.MultihostMultiStream(mh.global_data_mesh(model=1), len(mine), chunk_bytes=CHUNK,
                                    collect_paths=make_paths_spec(angles, **SPEC),
                                    emit_capacity=ECAP)
        for chunks, ended in stream_rounds(raws):
            s.feed([chunks[i] for i in mine])
            s.finalize_streams([mine.index(i) for i in ended if i in mine])
        s.finalize()
        for k, name in enumerate(("n_frames", "n_kept", "n_groups", "sums", "counts",
                                  "overflow")):
            res[name] = s.local_results()[k]
        res["n_closed"] = s.n_sweeps_closed_all()
        for i in range(len(mine)):
            res[f"filtered_{i}"] = s.local_stream_filtered(i)
            paths, valid = s.local_stream_paths(i)
            for f in paths._fields:
                res[f"paths_{i}_{f}"] = np.asarray(getattr(paths, f))
            res[f"valid_{i}"] = valid
            tracks, times, vel = s.local_stream_tracks(i)
            res[f"times_{i}"] = times
            for f in ("pos_aoa", "pos_aod", "power", "observed", "created", "n_tracks"):
                res[f"tracks_{i}_{f}"] = np.asarray(getattr(tracks, f))
            for j, v in enumerate(vel):
                res[f"vel_{i}_{j}"] = np.asarray(v)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    mh.shutdown_multihost()
    np.savez(out, **res)


if __name__ == "__main__":
    main()
