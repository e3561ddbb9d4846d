"""Replay traffic: a campaign's logs through the device stream engine.

``streams`` lanes of one ``parallel.streaming_device.MultiStreamingSession``
replay the seed's logs in a closed loop, as ``watch --logs`` does over a
campaign's recorded captures: lane i starts at log i and takes the next
log of the pool when its log ends.  A round feeds every lane one window:
a log's first feed is ``chunk_bytes`` bytes, each later one
``chunk_bytes`` less the frame's 10 carried bytes, so each feed is one
window round.  In a round where lanes' logs end, those lanes are flushed
together (``finalize_streams``), their counts, grids, paths and tracks
read (``results``, ``stream_paths``, ``stream_tracks``) and they are reset
(``reset_streams``).  A log's latency runs from the start of the round
that fed its first bytes to its results on the host.

Set-up makes the logs, builds the paths' dictionary from an angle table
written to ``TMPDIR`` and runs ``warmup_rounds`` rounds, which capture the
round's graphs.  After the window the logs in flight are finished (their
lanes fed alone) and judged, and count for no rate.

The check: every log replay completed in or after the window, its
distinct outputs each once, against the plain reference
(``reference/judge.live``).
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

from portbench.harness import quantile
from portbench.reference import judge
from portbench.reference.paths import sweeps_of
from portbench.reference.pipeline import log_reference
from portbench.trace import Spans
from portbench.traffic.campaign import log_shapes, make_campaign


def write_angle_table(cfg: dict, directory: str) -> str:
    """The (BeamID, Angle) xlsx table of the configuration's angles, in
    ``directory`` (the program reads its beam angles from such a file)."""
    from slam_process_tpu_torch.io.xlsx import write_xlsx_table

    angles = np.linspace(*cfg["angles_deg"])
    fd, path = tempfile.mkstemp(suffix=".xlsx", prefix="portbench-angles-", dir=directory)
    os.close(fd)
    write_xlsx_table(path, ["BeamID", "Angle"], np.stack([np.arange(len(angles)), angles], 1))
    return path


class Cell:
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.p = wl["traffic"]
        self.attempted = self.failed = 0

    def setup(self) -> None:
        from slam_process_tpu_torch.parallel import streaming_device as sd

        p, cfg = self.p, self.cfg
        self.shapes = log_shapes(cfg, self.seed)
        self.logs = make_campaign(cfg, self.shapes, self.seed, 0)
        self.carry = cfg["frame_bytes"] - 1
        spec = None
        if p["paths"]:
            pc = cfg["paths"]
            path = write_angle_table(cfg, tempfile.gettempdir())
            try:
                spec = sd.make_paths_spec(
                    path, estimator=pc["estimator"], s_step=pc["s_step"],
                    capacity=pc["capacity"], max_tracks=pc["max_tracks"],
                    gate_deg=pc["gate_deg"], max_paths=pc["max_paths"],
                    grid_res=pc["grid_res"], beam_width=pc["beam_width"])
            finally:
                os.unlink(path)
        b = cfg["bounds"]
        self.s = p["streams"]
        self.c = p["chunk_bytes"]
        self.ms = sd.MultiStreamingSession(
            self.s, chunk_bytes=self.c, group_capacity=b["group_capacity"],
            max_groups=b["max_groups"], max_baselines_per_group=b["max_baselines_per_group"],
            collect_paths=spec, device=self.device)
        self.paths = spec is not None
        self.cur = [i % len(self.logs) for i in range(self.s)]
        self.off = [0] * self.s
        self.t_first = [0.0] * self.s
        self.active = [True] * self.s
        self.records, self.fed = [], []
        self.lat, self.frames_done = [], 0
        self.rounds = self.round_id = self._res_round = 0
        quiet = Spans(False)
        for _ in range(p["warmup_rounds"]):
            self._round(quiet, keep=False, deadline=None)
        self.fed.clear()

    def _round(self, spans, keep: bool, deadline) -> None:
        self.round_id += 1
        chunks = []
        t_round = time.perf_counter()
        for i in range(self.s):
            if not self.active[i]:
                chunks.append(b"")
                continue
            raw, o = self.logs[self.cur[i]], self.off[i]
            piece = raw[o:o + (self.c if o == 0 else self.c - self.carry)]
            if o == 0:
                self.t_first[i] = t_round
            self.off[i] = o + len(piece)
            chunks.append(piece)
            if keep:
                self.fed.append((self.cur[i], o, o + len(piece)))
        with spans("pb.feed"):
            self.ms.feed(chunks)
        self.rounds += keep
        ended = [i for i in range(self.s)
                 if self.active[i] and self.off[i] >= len(self.logs[self.cur[i]])]
        if not ended:
            return
        with spans("pb.flush"):
            self.ms.finalize_streams(ended)
            with spans("pb.read"):
                recs = [self._read(i) for i in ended]
            self.ms.reset_streams(ended)
        t_done = time.perf_counter()
        for i, rec in zip(ended, recs):
            if keep:
                self.records.append(rec)
                self.attempted += 1
                self.failed += bool(rec["overflow"])
                if deadline is None or t_done <= deadline:
                    self.lat.append(t_done - self.t_first[i])
                    self.frames_done += self.shapes[self.cur[i]].frames
            self.cur[i] = (self.cur[i] + 1) % len(self.logs)
            self.off[i] = 0

    def _read(self, i: int) -> dict:
        if self._res_round != self.round_id:
            self._res = self.ms.results()
            self._res_round = self.round_id
        n_frames, n_kept, n_groups, sums, counts, overflow = self._res
        rec = dict(log=self.cur[i], n_frames=int(n_frames[i]), n_kept=int(n_kept[i]),
                   n_groups=int(n_groups[i]), overflow=bool(overflow[i]),
                   sums=np.array(sums[i]), counts=np.array(counts[i]))
        if self.paths:
            est, sv = self.ms.stream_paths(i)
            tr, t, _ = self.ms.stream_tracks(i)
            rec.update(aoa=np.array(est.aoa), aod=np.array(est.aod), power=np.array(est.power),
                       valid=np.array(est.valid), n_iters=np.array(est.n_iters),
                       aoa_idx=np.array(est.aoa_idx), aod_idx=np.array(est.aod_idx),
                       sweep_valid=np.array(sv), trk_aoa=np.array(tr.pos_aoa),
                       trk_aod=np.array(tr.pos_aod), trk_pow=np.array(tr.power),
                       trk_obs=np.array(tr.observed), trk_created=np.array(tr.created),
                       trk_count=int(tr.n_tracks), times=np.asarray(t, np.int64))
        return rec

    def window(self, seconds: float, spans) -> dict:
        """Rounds until the deadline; a run may call it more than once (a
        traced run's untraced window, then its traced one), and each call's
        measures are its own."""
        fed0, rounds0, lat0, frames0 = len(self.fed), self.rounds, len(self.lat), self.frames_done
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            self._round(spans, keep=True, deadline=deadline)
        self.window_rounds = self.rounds - rounds0
        self.window_fed = (fed0, len(self.fed))
        lat = self.lat[lat0:]
        return {"attempted": self.attempted, "failed": self.failed,
                "frames_per_s": (self.frames_done - frames0) / seconds,
                "log_result_ms_p95": quantile(lat, 0.95) * 1e3,
                "logs": len(lat), "rounds": self.window_rounds}

    def tail(self) -> None:
        """Finish the logs in flight at the window's close: their lanes
        alone are fed until each ends; no lane starts another log."""
        quiet = Spans(False)
        started = [self.off[i] > 0 for i in range(self.s)]
        self.active = started
        while any(self.active):
            before = list(self.cur)
            self._round(quiet, keep=True, deadline=0.0)
            for i in range(self.s):
                if self.cur[i] != before[i]:
                    self.active[i] = False
        self.attempted = len(self.records)

    def release(self) -> None:
        self.ms = None

    def judge(self) -> list:
        dev = self.device if self.device.type == "cuda" else "cpu"
        self.refs = [log_reference(raw, self.cfg, dev) for raw in self.logs]
        checks, self.nnls_work = judge.live(self.cfg, self.wl["limits"], self.refs,
                                             self.records, dev)
        return checks

    def traffic_stats(self) -> dict:
        """What the last window's rounds fed, per the reference: each
        lane's byte range of its log, and the frames, flag bytes, kept rows,
        corrector work and closed sweeps that start in it."""
        per_log = {}
        for log, r in enumerate(self.refs):
            starts = r.frames.starts
            kept_at = starts[r.corr.keep]
            flags = np.nonzero((self.logs[log] == 0xCC) | (self.logs[log] == 0x33))[0]
            cand = np.concatenate([[0], np.cumsum(r.corr.candidates)])
            steps = np.concatenate([[0], np.cumsum(judge.search_steps(r.corr.group_baselines))])
            sw = sweeps_of(r) if self.paths else None
            per_log[log] = (starts, kept_at, flags, cand, steps, sw)
        tot = dict(bytes=0, flags=0, frames=0, kept=0, k2_candidates=0, k2_steps=0,
                   sweeps=0, nnls_outer=0, nnls_solves=0)
        for log, lo, hi in self.fed[slice(*self.window_fed)]:
            starts, kept_at, flags, cand, steps, sw = per_log[log]
            a, b = np.searchsorted(starts, [lo, hi])
            tot["bytes"] += hi - lo
            tot["frames"] += int(b - a)
            tot["kept"] += int(np.searchsorted(kept_at, hi) - np.searchsorted(kept_at, lo))
            tot["flags"] += int(np.searchsorted(flags, hi) - np.searchsorted(flags, lo))
            tot["k2_candidates"] += int(cand[b] - cand[a])
            tot["k2_steps"] += int(steps[b] - steps[a])
            if sw is not None:
                closed = int(np.searchsorted(sw.last_start, hi) - np.searchsorted(sw.last_start, lo))
                tot["sweeps"] += closed
                outer, solves = self.nnls_work.get(log, (0, 0))
                n = max(len(sw.times), 1)
                tot["nnls_outer"] += outer * closed / n
                tot["nnls_solves"] += solves * closed / n
        tot["rounds"] = self.window_rounds
        tot["streams"] = self.s
        tot["carry_paths"] = int(self.paths)
        tot["max_paths"] = self.cfg["paths"]["max_paths"]
        tot["max_tracks"] = self.cfg["paths"]["max_tracks"]
        return tot
