"""The check on the CPU at a size a test can hold (``tiny.tiny_root``): a
whole run of each cell, the program's plain CPU path against the plain
reference, comes out correct; the control (the reference one step below
the stated precision, or breaking the stated guarantee) and the reference
itself in the program's place come out as they must; and a run whose
timed path is broken underneath comes out not correct, once for each
fault a one-chip cell can have (a step that leaves its state unchanged,
half the batch left out with the mean of the rest in its place, an
answer altered where it is produced; no cell has an exchange between
chips)."""

import io
import json

import numpy as np
import pytest
import torch

from portbench.control import control
from portbench.harness import run
from portbench.tests.tiny import tiny_root

CELLS = ["offline.campaign19", "live.s19.w64k.paths", "live.s19.w1m.paths"]
SEED = 2_600_000_017


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("portbench"))


def _run(root, cell, trace=False) -> dict:
    out, err = io.StringIO(), io.StringIO()
    rc = run(cell, SEED, 0.4, trace, device="cpu", root=root, out=out, err=err)
    assert rc == 0, err.getvalue()[-3000:]
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")
    return line


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference(root, cell):
    line = _run(root, cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"frames_per_s", "setup_s"} <= set(line["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    assert not control(cell, SEED, torch.bfloat16, root, "cpu")["correct"]


@pytest.mark.parametrize("cell", ["offline.campaign19", "live.s19.w64k.paths"])
def test_reference_in_the_programs_place_is_correct(root, cell):
    assert control(cell, SEED, torch.float64, root, "cpu")["correct"]


def _offline_fault(kind):
    from slam_process_tpu_torch.parallel import batch

    real = batch.run_dataset

    def broken(mesh, raws, **kw):
        if kind == "half":
            h = len(raws) // 2
            out = real(mesh, list(raws[:h]), **kw)
            mean = type(out[0])(*(np.mean([np.asarray(o[f]) for o in out], axis=0).astype(
                np.asarray(out[0][f]).dtype) for f in range(len(out[0]))))
            return out + [mean] * (len(raws) - h)
        out = real(mesh, raws, **kw)
        if kind == "unchanged":
            return [type(o)(*(np.zeros_like(np.asarray(x)) for x in o)) for o in out]
        out[0].counts[3, 5] += 1
        return out

    return batch, "run_dataset", broken


def _live_fault(kind):
    from slam_process_tpu_torch.parallel import streaming_device as sd

    cls = sd.MultiStreamingSession
    if kind == "unchanged":
        return cls, "_window", lambda self, *a, **k: None
    if kind == "half":
        real_feed = cls.feed

        def feed(self, chunks):
            return real_feed(self, [c if i % 2 == 0 else b"" for i, c in enumerate(chunks)])
        return cls, "feed", feed
    real_results = cls.results

    def results(self):
        out = real_results(self)
        out[3][0, 3, 5] += 1
        return out
    return cls, "results", results


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ["offline.campaign19", "live.s19.w64k.paths"])
def test_broken_timed_path_is_not_correct(root, cell, kind, monkeypatch):
    target, attr, fn = (_offline_fault if cell.startswith("offline") else _live_fault)(kind)
    monkeypatch.setattr(target, attr, fn)
    assert not _run(root, cell)["correct"]


def test_paths_answer_altered_is_not_correct(root, monkeypatch):
    from slam_process_tpu_torch.parallel import streaming_device as sd

    real = sd.MultiStreamingSession.stream_paths

    def stream_paths(self, i):
        est, sv = real(self, i)
        power = np.array(est.power)
        power[0, 0] *= 1.01
        return est._replace(power=power), sv

    monkeypatch.setattr(sd.MultiStreamingSession, "stream_paths", stream_paths)
    line = _run(root, "live.s19.w64k.paths")
    assert not line["correct"]
    assert line["checks"]["power_gap"]["value"] > line["checks"]["power_gap"]["limit"]


def test_traced_run_reads_host_clock_metrics_from_an_untraced_window(root, monkeypatch):
    from portbench import harness

    seen = []

    class Ctx(harness.Context):
        def __init__(self, *a):
            super().__init__(*a)
            seen.append(self)

    monkeypatch.setattr(harness, "Context", Ctx)
    line = _run(root, "live.s19.w64k.paths", trace=True)
    assert line["correct"]
    (ctx,) = seen
    assert ctx.host_spans is not ctx.spans and not ctx.host_spans.traced
    flush = ctx.host_spans.seconds["pb.flush"]
    assert line["metrics"]["stream.flush_ms_per_call"]["value"] == pytest.approx(
        1e3 * sum(flush) / len(flush))
    assert ctx.spans.seconds["pb.feed"]       # the traced window ran after it


def test_trace_that_lost_the_sentinel_gives_no_result(root, monkeypatch):
    import portbench.trace as T

    class Lost(T.Trace):
        def __init__(self, activities, spans, window_s, lost):
            super().__init__(activities, spans, window_s, T.SENTINEL_LAUNCHES)

    monkeypatch.setattr(T, "Trace", Lost)
    out, err = io.StringIO(), io.StringIO()
    rc = run("offline.campaign19", SEED, 0.4, True, device="cpu", root=root, out=out, err=err)
    assert rc != 0 and not out.getvalue().strip()
    assert "sentinel" in err.getvalue()
