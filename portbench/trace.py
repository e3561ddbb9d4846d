"""The traced run's reduction: device activities and the benchmark's spans.

A ``--trace 1`` run wraps its measured window in one ``torch.profiler``
window (CPU and CUDA activities).  The benchmark's own spans are
``record_function`` ranges named ``pb.<what>`` around its calls into the
program (a job, a round's feed, a flush, its reads).  After the window the
profiler's events are read once, straight from its results (no Chrome
trace is written): the device activities (kernels, copies and sets, not
the profiler's own buffer rows nor annotation mirrors) and the spans,
both on the trace's clock.

``Trace`` holds them in seconds from the window's start and answers what
the metric readers ask: busy time (the union of the activities), time by
activity name, idle time inside spans of one name, and the idle gaps
labelled by the innermost span the host was in.

The rules are those of the program's ``utils/device_timing``: the union
of the activities, and a sentinel of one-element adds before the window,
since the profiler on the card has been seen to drop a late window's
first activities; where the trace lost every sentinel activity it may
have lost some of the window's too, and the run reads no per-layer
metric from it (``device_timing`` raises ``TraceLostError`` there).  Its
reader is not reused: it writes the window's Chrome trace to disk and
parses the JSON back, which for a busy 10 s window takes minutes of a
run's 360 s; this module reads the same events from the profiler's
results in memory.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

SENTINEL = "pb.sentinel"
WINDOW = "pb.window"
SENTINEL_LAUNCHES = 256


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(a, b) for a, b in out]


class Spans:
    """The benchmark's spans: host-clock durations by name, always; and,
    in a traced run, ``record_function`` ranges the trace holds."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        import time

        rf = None
        if self.traced:
            from torch.profiler import record_function

            rf = record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name].append(time.perf_counter() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)


class Activity(NamedTuple):
    name: str
    start: float
    end: float


class Trace:
    """A traced window's activities and spans, in seconds from its start."""

    def __init__(self, activities: List[Activity], spans: List[Activity], window_s: float,
                 sentinel_lost: Optional[int]):
        self.activities = activities
        self.spans = spans
        self.window_s = window_s
        self.sentinel_lost = sentinel_lost
        self._busy = merged((a.start, a.end) for a in activities)
        self._busy_starts = [lo for lo, _ in self._busy]

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self._busy)

    def seconds_of(self, patterns: Iterable[str]) -> Tuple[float, int]:
        """(device seconds, activities) of the activities whose name holds
        any of ``patterns``."""
        pats = tuple(patterns)
        acts = [a for a in self.activities if any(p in a.name for p in pats)]
        return sum(a.end - a.start for a in acts), len(acts)

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for a in self.activities:
            out[a.name] += a.end - a.start
        return dict(out)

    def busy_in(self, lo: float, hi: float) -> float:
        """Device-busy seconds inside [lo, hi]."""
        i = max(bisect.bisect_right(self._busy_starts, lo) - 1, 0)
        total = 0.0
        while i < len(self._busy) and self._busy[i][0] < hi:
            a, b = self._busy[i]
            total += max(min(b, hi) - max(a, lo), 0.0)
            i += 1
        return total

    def span_idle(self, name: str) -> Tuple[float, int]:
        """(idle device seconds inside the spans called ``name``, spans)."""
        occ = [s for s in self.spans if s.name == name]
        return sum((s.end - s.start) - self.busy_in(s.start, s.end) for s in occ), len(occ)

    def idle_gaps(self) -> Dict[str, float]:
        """Idle device seconds of the window, by the innermost span the host
        was in at each gap's middle ("host.outside_spans" where none)."""
        edges = [(0.0, 0.0)] + self._busy + [(self.window_s, self.window_s)]
        spans = sorted(self.spans, key=lambda s: s.start)
        starts = [s.start for s in spans]
        out: Dict[str, float] = defaultdict(float)
        for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            label, best = "host.outside_spans", None
            for s in spans[:bisect.bisect_right(starts, mid)]:
                if s.end >= mid and (best is None or s.end - s.start < best):
                    label, best = s.name, s.end - s.start
            out[label] += b - a
        return dict(out)


@contextlib.contextmanager
def profiled(device):
    """Profile the body; yields a holder whose ``trace`` is set on exit.
    A sentinel of one-element adds runs first: the profiler on the card has
    been seen to drop a late window's first activities, and
    ``sentinel_lost`` says how many of these it dropped.  The window is
    the ``pb.window`` range around the body, which ends in a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("TraceHolder", (), {"trace": None})()
    x = torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SENTINEL):
            for _ in range(SENTINEL_LAUNCHES):
                x.add_(1.0)
        torch.cuda.synchronize(device)
        with record_function(WINDOW):
            yield holder
            torch.cuda.synchronize(device)
    holder.trace = reduce_events(prof.profiler.kineto_results.events())


def _kind(e) -> str:
    try:
        return str(e.activity_type())
    except (AttributeError, RuntimeError):
        return ""


def reduce_events(events) -> Trace:
    """The window's device activities and ``pb.*`` spans from the
    profiler's events, in seconds from the start of the ``pb.window``
    range; the activities that start before it are the sentinel's."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    acts, spans, window = [], [], None
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == cuda:
            kind = _kind(e).lower()
            if kind and not any(k in kind for k in ("kernel", "memcpy", "memset")):
                continue
            if e.is_user_annotation() or name.startswith("Activity Buffer"):
                continue
            acts.append((name, start, end))
        elif name == WINDOW:
            window = (start, end)
        elif name.startswith("pb.") and name != SENTINEL:
            spans.append((name, start, end))
    if window is None:
        raise RuntimeError("the trace holds no pb.window range")
    lo, hi = window
    seen = sum(1 for _, s, _ in acts if s < lo)
    win = [(n, s, t) for n, s, t in acts if s >= lo]
    hi = max([hi] + [t for _, _, t in win])

    def sec(ns):
        return (ns - lo) / 1e9

    return Trace([Activity(n, sec(s), sec(t)) for n, s, t in win],
                 [Activity(n, sec(s), sec(t)) for n, s, t in spans if s >= lo],
                 sec(hi), SENTINEL_LAUNCHES - min(seen, SENTINEL_LAUNCHES))
