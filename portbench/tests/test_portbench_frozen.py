"""The benchmark's frozen copies give what their sources give: the traffic
generator (``slam_process_tpu_torch/utils/synthetic.py``) and the count
arithmetic (``chip_smoke.py``), on two seeds at a small size.  Each test
skips where its source is absent."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from portbench.counts.correct import k2_ops
from portbench.counts.nnls import k7_ops
from portbench.counts.tracker import k6_bytes
from portbench.traffic import synthetic

REPO = Path(__file__).resolve().parents[2]


def _source(rel: str):
    path = REPO / rel
    if not path.exists():
        pytest.skip(f"{rel} is not in this checkout")
    spec = importlib.util.spec_from_file_location(f"frozen_source_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [3, 2_500_000_001])
@pytest.mark.parametrize("n_paths", [0, 3])
def test_generator_bytes_equal_source(seed, n_paths):
    src = _source("slam_process_tpu_torch/utils/synthetic.py")
    kw = dict(n_groups=3, frames_per_beam=4, baselines_per_group=6, junk_frac=0.3,
              big_group=300, seed=seed, n_paths=n_paths)
    assert np.array_equal(synthetic.synthetic_session_bytes(**kw),
                          src.synthetic_session_bytes(**kw))
    assert np.array_equal(synthetic.ANGLES, src.ANGLES)
    assert synthetic.CYCLE == src.CYCLE


@pytest.mark.parametrize("seed", [5, 6])
def test_counts_equal_chip_smoke(seed):
    src = _source("chip_smoke.py")
    rng = np.random.default_rng(seed)
    for _ in range(20):
        c, s, r = (int(x) for x in rng.integers(0, 1 << 30, 3))
        assert k2_ops(c, s, r) == src.k2_ops(c, s, r)
        k = int(rng.integers(1, 24))
        solver = ("auto", "lu")[int(rng.integers(0, 2))]
        outer, solves = (int(x) for x in rng.integers(0, 1 << 20, 2))
        assert k7_ops(k, solver, outer, solves) == src.k7_ops(k, solver, outer, solves)
        s1, kn, tn = (int(x) for x in rng.integers(1, 70, 3))
        live = int(rng.integers(0, s1 + 5))
        args = (np.zeros((s1, kn)), None, None, None, live, np.zeros((tn, 2)))
        assert k6_bytes(min(live, s1), s1, kn, tn) == src.k6_bytes(args)
    assert src.PEAK_BYTES_PER_S == 3.35e12
