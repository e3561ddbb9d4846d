"""Offline traffic: whole campaigns through ``parallel.batch.run_dataset``.

A closed loop of jobs back to back; job k runs campaign k mod C of the
seed's C campaigns (the same logs' sizes and byte lengths, other frames),
each job all of its logs at once, as a lab reprocessing a campaign calls
``run_dataset(None, logs)``.  A job's latency runs from its submission to
its per-log summaries on the host as numpy arrays.  Set-up makes the
campaigns and runs each once, so every bucket's program is captured
before the window.

The check: a sample of the window's jobs, drawn from the seed (each job
with probability ``sample_share``, and the last), is compared log by log
with the plain reference (``portbench/reference``): frames, kept rows and
the overflow flag exactly, the cell counts exactly, the cell means, the
normalised raster and the colours within the workload's limits.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness import quantile
from portbench.reference import judge
from portbench.reference.pipeline import log_reference
from portbench.traffic.campaign import log_shapes, make_campaign


class Cell:
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.p = wl["traffic"]
        self.attempted = self.failed = 0

    def setup(self) -> None:
        from slam_process_tpu_torch.parallel.batch import run_dataset

        p, cfg = self.p, self.cfg
        self.shapes = log_shapes(cfg, self.seed)
        self.campaigns = [make_campaign(cfg, self.shapes, self.seed, c)
                          for c in range(p["campaigns"])]
        self.frames_per_job = sum(s.frames for s in self.shapes)
        pipe = cfg["pipeline"]
        self.kw = dict(blur_sigma=pipe["blur_sigma"], use_log=pipe["use_log"],
                       max_groups=cfg["bounds"]["max_groups"],
                       max_baselines_per_group=cfg["bounds"]["max_baselines_per_group"])
        self.run_dataset = run_dataset
        for c in self.campaigns:
            run_dataset(None, c, device=self.device, **self.kw)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed & ((1 << 64) - 1), 0x5A]))
        self.sample = rng.random(1 << 16) < p["sample_share"]
        self.k, self.kept = 0, {}

    def _job(self, k: int):
        out = self.run_dataset(None, self.campaigns[k % len(self.campaigns)],
                               device=self.device, **self.kw)
        self.attempted += 1
        if any(bool(r.correct_overflow) for r in out):
            self.failed += 1
        return out

    def window(self, seconds: float, spans) -> dict:
        """Jobs until the deadline; a run may call it more than once, and
        each call's measures are its own (the sample to judge spans all)."""
        lat = []
        k0 = k = self.k
        t0 = time.perf_counter()
        deadline = t0 + seconds
        frames = 0
        while time.perf_counter() < deadline:
            t_sub = time.perf_counter()
            with spans("pb.job"):
                out = self._job(k)
            t_done = time.perf_counter()
            if t_done <= deadline:
                lat.append(t_done - t_sub)
                frames += self.frames_per_job
            if self.sample[k % len(self.sample)]:
                self.kept[k] = out
            last = (k, out)
            k += 1
        self.kept[last[0]] = last[1]
        self.k = k
        self.window_jobs = (k0, k)
        return {"attempted": self.attempted, "failed": self.failed,
                "frames_per_s": frames / seconds,
                "dataset_job_ms_p95": quantile(lat, 0.95) * 1e3, "jobs": k - k0,
                "frames_in_window": (k - k0) * self.frames_per_job}

    def tail(self) -> None:
        pass

    def release(self) -> None:
        self.run_dataset = None
        from slam_process_tpu_torch.parallel.batch import batched_session_pipeline

        batched_session_pipeline.cache_clear()

    def references(self):
        if not hasattr(self, "_refs"):
            dev = self.device if self.device.type == "cuda" else "cpu"
            self._refs = [[log_reference(raw, self.cfg, dev) for raw in c]
                          for c in self.campaigns]
        return self._refs

    def judge(self) -> list:
        refs = self.references()
        outs = [(self.campaign_of(k), out) for k, out in sorted(self.kept.items())]
        return judge.offline(self.cfg, self.wl["limits"], refs, outs)

    def campaign_of(self, k: int) -> int:
        return k % len(self.campaigns)

    def traffic_stats(self) -> dict:
        """What the last window's jobs fed, per the reference: every job
        runs all logs of its campaign."""
        refs = self.references()
        per_campaign = [judge.log_work(refs[c]) for c in range(len(refs))]
        total: dict = {}
        jobs = range(*self.window_jobs)
        for k in jobs:
            for key, v in per_campaign[self.campaign_of(k)].items():
                total[key] = total.get(key, 0) + v
        total["rasters"] = len(jobs) * len(self.shapes)
        total["units"] = len(jobs)
        return total

