"""The port's geometric estimator == the JAX package's (host only in both).

* ``identify_paths`` (vectorised) prints and records as JAX's loop, with
  and without a geometric LoS angle, and with no peak (a table with no
  columns).
* ``run_estimator("geometric")`` against JAX's: equal text and records,
  with node positions (``bs_xy`` / ``ue_xy``), with an angle table with
  unmapped beams, and on rows that repeat an (AoA, AoD) pair with other
  RSS (each pair's first row counts, in row order).
* ``engine="device"`` warns with JAX's ``RuntimeWarning`` word for word
  and returns the host table; ``engine="host"`` does not warn.
"""

import warnings

import numpy as np
import pytest

import slam_process_tpu.models  # noqa: F401  (the JAX package loads its registry first)
from slam_process_tpu.models import geometric as jax_geo
from slam_process_tpu.models import registry as jax_registry
from slam_process_tpu_torch.models import geometric, registry
from slam_process_tpu_torch.utils.synthetic import write_angle_table

WARNING = ("geometric estimator has no device engine (microsecond-scale scipy find_peaks "
           "work); running on host")


def grid_case(seed):
    rng = np.random.default_rng(seed)
    aoa_grid, aod_grid = np.arange(-30.0, 30.0, 0.1), np.arange(-20.0, 25.0, 0.1)
    AOA, AOD = np.meshgrid(aoa_grid, aod_grid, indexing="ij")
    grid = 10 * np.log10(sum(rng.uniform(0.2, 1.0) * np.exp(
        -((AOA - rng.uniform(-25, 25)) ** 2 + (AOD - rng.uniform(-15, 20)) ** 2) / 20.0)
        for _ in range(3)) + 1e-3)
    grid -= grid.max()
    return grid, AOA, AOD


@pytest.mark.parametrize("los", ["none", "near_max", "far"])
def test_identify_paths_matches_jax(los):
    grid, AOA, AOD = grid_case(3)
    i, j = np.unravel_index(np.argmax(grid), grid.shape)
    seed = {"none": (None, None), "near_max": (AOA[i, 0] + 3.0, AOD[0, j] - 4.0),
            "far": (-60.0, -60.0)}[los]
    got = geometric.identify_paths(grid, AOA, AOD, *seed)
    want = jax_geo.identify_paths(grid, AOA, AOD, *seed)
    assert len(got) > 10
    assert got.to_string(index=False) == want.to_string(index=False)
    assert got.to_dict("records") == want.to_dict("records")
    assert ("LoS" in got["Type"]) == (los != "far")
    empty = geometric.identify_paths(grid - 100.0, AOA, AOD, None, None)
    assert len(empty) == 0 and empty.to_string(index=False) == jax_geo.identify_paths(
        grid - 100.0, AOA, AOD, None, None).to_string(index=False)
    assert geometric.geometric_los_angle((1.0, 2.0), (4.0, -3.0)) == \
        jax_geo.geometric_los_angle((1.0, 2.0), (4.0, -3.0))


def sessions(tmp_path, repeat=False):
    from test_torch_estimate import session_pair

    s, js = session_pair(tmp_path, "geo", n_groups=2, frames_per_beam=3, seed=12)
    if repeat:   # each row again with other RSS, after the originals
        f = s.filtered.copy()
        f[:, 2] = f[:, 2] // 2 + 7
        s.filtered = np.concatenate([s.filtered, f])
        js.filtered = s.filtered.copy()
    return s, js


@pytest.mark.parametrize("case", ["plain", "positions", "unmapped", "repeated_pairs"])
def test_run_geometric_matches_jax(tmp_path, case):
    s, js = sessions(tmp_path, repeat=case == "repeated_pairs")
    angles = write_angle_table(tmp_path / "a.xlsx",
                               unmapped=(5, 33, 60) if case == "unmapped" else ())
    kw = dict(bs_xy=(0.0, 0.0), ue_xy=(3.0, 0.2)) if case == "positions" else {}
    got = registry.run_estimator("geometric", s, angles, engine="host", device="cpu", **kw)
    want = jax_registry.run_estimator("geometric", js, angles, engine="host", **kw)
    assert len(got) > 100
    assert got.to_string(index=False) == want.to_string(index=False)
    assert got.to_dict("records") == want.to_dict("records")


def test_device_engine_warns_as_jax_and_runs_the_host_body(tmp_path):
    s, js = sessions(tmp_path)
    angles = write_angle_table(tmp_path / "a.xlsx")
    with pytest.warns(RuntimeWarning) as caught:
        got = registry.run_estimator("geometric", s, angles, engine="device", device="cpu")
    with pytest.warns(RuntimeWarning) as caught_jax:
        jax_registry.run_estimator("geometric", js, angles, engine="device")
    assert [str(w.message) for w in caught] == [str(w.message) for w in caught_jax] == [WARNING]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        host = registry.run_estimator("geometric", s, angles, engine="host", device="cpu")
    assert got.to_string(index=False) == host.to_string(index=False)
