"""The port's spans (``utils/profiling.annotate``) in a CPU profiler trace.

  * ``run_dataset`` over a campaign of 3 or more byte buckets: per bucket
    ``slam.batch.stack``, ``upload`` and ``replay``, then per bucket
    ``readback`` and ``split``, once each, in that order, inside the caller's
    range;
  * with no profiler running ``annotate`` is the shared no-op context and
    enters no ``record_function``; under a profiler it opens the range alone
    (no NVTX range);
  * a ``MultiStreamingSession`` with ``collect_paths``: one
    ``slam.stream.round`` a round, one ``slam.stream.count_read`` a count
    read (``HOST_SYNCS``), each inside a round or a flush, one
    ``slam.stream.stage`` a feed and a round, and ``flush``, ``read`` and
    ``reset`` once a call;
  * ``cli replay --profile DIR`` writes a Chrome trace holding the single
    stream's ``slam.stream.round`` ranges.
"""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from slam_process_tpu_torch.parallel import batch
from slam_process_tpu_torch.parallel import streaming_device as sd
from slam_process_tpu_torch.pipeline import cli
from slam_process_tpu_torch.utils import profiling
from slam_process_tpu_torch.utils.profiling import annotate
from slam_process_tpu_torch.utils.synthetic import (
    synthetic_session_bytes, to_hex_text, write_angle_table)

BOUNDS = dict(max_groups=16, max_baselines_per_group=32)
QUANTUM = 1 << 12
CALLER = "caller"


def ranges(prof, prefix="slam."):
    """(start, end, name) of the trace's ranges named ``prefix...`` or
    ``CALLER``, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.name.startswith(prefix) or e.name == CALLER)


def test_batch_spans_once_per_bucket_in_order():
    sessions = [synthetic_session_bytes(n_groups=g, frames_per_beam=2, baselines_per_group=4,
                                        seed=s) for s, g in enumerate((1, 3, 6, 3, 10))]
    n_buckets = len({batch.bucket_size(len(r), QUANTUM) for r in sessions})
    assert n_buckets >= 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            got = batch.run_dataset(None, sessions, quantum=QUANTUM, device="cpu", **BOUNDS)
    spans = ranges(prof)
    assert spans[0][2] == CALLER
    lo, hi = spans[0][:2]
    assert all(lo <= a and b <= hi for a, b, _ in spans[1:])
    steps = [n for _, _, n in spans[1:]]
    assert steps == (["slam.batch.stack", "slam.batch.upload", "slam.batch.replay"] * n_buckets
                     + ["slam.batch.readback", "slam.batch.split"] * n_buckets)
    want = batch.run_dataset(None, sessions, quantum=QUANTUM, device="cpu", **BOUNDS)
    for g, w in zip(got, want):
        for f in batch.SessionSummaryOut._fields:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)


def _refuse(*args, **kwargs):
    raise AssertionError("a range was opened")


def test_annotate_without_a_profiler_is_the_shared_no_op(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    assert not torch.autograd._profiler_enabled()
    span = annotate("slam.test.step")
    assert span is profiling.NO_SPAN and annotate("slam.test.other") is span
    with span:
        with annotate("slam.test.inner"):
            pass


def test_annotate_under_a_profiler_opens_no_nvtx_range(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda.nvtx, "range", _refuse)
        monkeypatch.setattr(torch.cuda.nvtx, "range_push", _refuse)
        with annotate("slam.test.outer"):
            with annotate("slam.test.inner"):
                torch.ones(4).add_(1)
        monkeypatch.undo()
    (a0, a1, outer), (b0, b1, inner) = ranges(prof)
    assert (outer, inner) == ("slam.test.outer", "slam.test.inner")
    assert a0 <= b0 and b1 <= a1


@pytest.fixture(scope="module")
def paths_spec(tmp_path_factory):
    angles = write_angle_table(tmp_path_factory.mktemp("spans") / "beam_angle.xlsx")
    return sd.make_paths_spec(angles, s_step=8, grid_res=2.0)


def test_stream_spans_follow_the_rounds_and_counters(paths_spec, monkeypatch):
    raws = [synthetic_session_bytes(n_groups=g, frames_per_beam=4, baselines_per_group=5,
                                    junk_frac=0.05, seed=30 + g, n_paths=3) for g in (3, 4, 2)]
    rounds = []
    window = sd.MultiStreamingSession._window
    monkeypatch.setattr(sd.MultiStreamingSession, "_window",
                        lambda self, *a: rounds.append(1) or window(self, *a))
    ms = sd.MultiStreamingSession(len(raws), chunk_bytes=1 << 12, collect_paths=paths_spec,
                                  emit_capacity=1 << 12, device="cpu")
    step = 6000
    feeds = range(0, max(map(len, raws)), step)
    syncs = sd.HOST_SYNCS
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for off in feeds:
            ms.feed([r[off:off + step] for r in raws])
        ms.finalize_streams([0])
        ms.results()
        ms.stream_paths(0)
        ms.stream_tracks(0)          # the host memo of stream_paths' copy: no read
        ms.reset_streams([0])
        ms.finalize()
    spans = ranges(prof, "slam.stream.")
    count = Counter(n for _, _, n in spans)
    assert len(rounds) >= 3 and count["slam.stream.round"] == len(rounds)
    assert count["slam.stream.count_read"] == sd.HOST_SYNCS - syncs == len(rounds) + 2
    assert count["slam.stream.stage"] == len(feeds) + len(rounds)
    assert (count["slam.stream.flush"], count["slam.stream.read"],
            count["slam.stream.reset"]) == (2, 2, 1)
    outer = [(a, b) for a, b, n in spans if n in ("slam.stream.round", "slam.stream.flush")]
    for a, b, n in spans:
        if n == "slam.stream.count_read":
            assert any(lo <= a and b <= hi for lo, hi in outer)


def test_replay_profile_writes_the_stream_spans(tmp_path, capsys):
    raw = synthetic_session_bytes(n_groups=3, frames_per_beam=4, baselines_per_group=5,
                                  junk_frac=0.05, seed=7, n_paths=3)
    log = tmp_path / "live.txt"
    log.write_bytes(to_hex_text(raw))
    angles = write_angle_table(tmp_path / "beam_angle.xlsx")
    rc = cli.main(["replay", "--logs", str(log), "--mapping", str(angles), "--outdir",
                   str(tmp_path / "out"), "--chunk-bytes", "4096", "--profile",
                   str(tmp_path / "trace"), "--device", "cpu"])
    assert rc == 0
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    rounds = [e for e in events if e.get("name") == "slam.stream.round"]
    assert len(rounds) >= 2 and all(e.get("cat") == "user_annotation" for e in rounds)
