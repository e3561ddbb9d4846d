"""``sweep_paths_dataset`` and ``Session._sweep_estimation_inputs(pad_to=)``
on the CPU.

Three small sessions of different sizes, one of them missing beams (so the
beam and grid axes are padded): the dataset results equal each session's
own ``sweep_paths`` exactly (every field and dtype), for NN-OMP and
SM-SIC; they match JAX's ``sweep_paths_dataset`` under
``tests/test_sweep_paths.py``'s contract (indices and valid equal, power
within rtol 2e-4); inputs padded to a larger common shape (sweeps, beams
and atoms) give the unpadded paths on the real sweeps, exactly; the
results cross to the host in one read; a mesh and a device at once are
refused (the mesh forms: ``tests/test_torch_mesh.py``).
"""

import numpy as np
import pytest
import torch

from slam_process_tpu_torch.parallel.mesh import make_mesh, read_once
from slam_process_tpu_torch.pipeline.session import Session, sweep_paths_dataset
from slam_process_tpu_torch.utils.synthetic import (
    synthetic_session_bytes, to_hex_text, write_angle_table)

SESSIONS = [dict(n_groups=3, frames_per_beam=3, baselines_per_group=9, seed=31, n_paths=3),
            dict(n_groups=6, frames_per_beam=1, baselines_per_group=4, seed=32, n_paths=2),
            dict(n_groups=2, frames_per_beam=4, baselines_per_group=9, seed=33, n_paths=3)]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dataset")
    logs = []
    for i, kw in enumerate(SESSIONS):
        path = tmp / f"Serial Debug 2026-10-17 1{i}0000.txt"
        path.write_bytes(to_hex_text(synthetic_session_bytes(**kw), "shipped"))
        logs.append(path)
    return logs, write_angle_table(tmp / "beam_angle.xlsx")


def sessions_of(logs, engine="port"):
    """The port's or JAX's sessions; the third misses UE beams 0-6 and BS
    beams 60-63, so its submatrix and grids are smaller than the others'."""
    if engine == "port":
        out = [Session.from_log(p, device="cpu") for p in logs]
    else:
        from slam_process_tpu.pipeline.session import Session as JaxSession

        out = [JaxSession.from_log(p, engine="host") for p in logs]
        for s in out:
            s.correct()
    f = out[2].filtered
    out[2].filtered = f[(f[:, 0] >= 7) & (f[:, 1] < 60)]
    return out


@pytest.fixture(scope="module")
def sessions(files):
    return sessions_of(files[0])


def assert_same(a, b):
    (pa, va), (pb, vb) = a, b
    np.testing.assert_array_equal(va, vb)
    assert type(pa) is type(pb)
    for field in pa._fields:
        x, y = getattr(pa, field), getattr(pb, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.mark.parametrize("estimator", ["nn_omp", "sm_sic"])
def test_dataset_equals_per_session(sessions, files, estimator):
    _, angles = files
    shapes = [s._sweep_host_prep(angles, estimator, device=CPU) for s in sessions]
    assert len({len(p[2]) for p in shapes}) > 1, "the beam axes must need padding"
    assert len({len(p[4].aoa_grid) for p in shapes}) > 1, "the grid axes must need padding"
    got = sweep_paths_dataset(sessions, angles, estimator=estimator, device="cpu")
    assert len(got) == len(sessions)
    for s, res in zip(sessions, got):
        assert_same(res, s.sweep_paths(angles, estimator=estimator, device="cpu"))


def test_dataset_matches_jax(sessions, files):
    from slam_process_tpu.pipeline.session import sweep_paths_dataset as jax_dataset

    logs, angles = files
    want = jax_dataset(sessions_of(logs, "jax"), angles)
    got = sweep_paths_dataset(sessions, angles, device="cpu")
    for (p, v), (q, w) in zip(got, want):
        np.testing.assert_array_equal(v, w)
        for field in ("aoa_idx", "aod_idx", "valid", "n_iters"):
            np.testing.assert_array_equal(getattr(p, field), np.asarray(getattr(q, field)),
                                          err_msg=field)
        ok = p.valid
        np.testing.assert_allclose(p.power[ok], np.asarray(q.power)[ok], rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("estimator", ["nn_omp", "sm_sic"])
def test_padded_inputs_give_unpadded_paths(sessions, files, estimator):
    _, angles = files
    s = sessions[2]
    gid, n, ue_ids, bs_ids, d, _ = s._sweep_host_prep(angles, estimator, device=CPU)
    pad_to = (n + 3, len(ue_ids) + 5, len(bs_ids) + 2, len(d.aoa_grid) + 17,
              len(d.aod_grid) + 9)
    sub, dp, _, n_p = s._sweep_estimation_inputs(angles, estimator, None, CPU, pad_to=pad_to)
    assert n_p == n and tuple(sub.shape) == pad_to[:3]
    assert tuple(dp.phi_rx.shape) == (pad_to[1], pad_to[3])
    assert torch.isnan(sub[n:]).all() and torch.isnan(sub[:, len(ue_ids):]).all()
    assert not dp.phi_rx[len(ue_ids):].any() and not dp.phi_tx[:, len(d.aod_grid):].any()
    assert (dp.aoa_grid[len(d.aoa_grid):] == dp.aoa_grid[len(d.aoa_grid) - 1]).all()
    [(padded, valid)], _ = s._sweep_estimate_shards(angles, estimator, None, [(CPU,)],
                                                    pad_to=pad_to)
    assert not valid[n:].any()
    got = (type(padded)(*(x[:n].numpy() for x in padded)), valid[:n].numpy())
    assert_same(got, s.sweep_paths(angles, estimator=estimator, device="cpu"))


def test_results_cross_to_the_host_once(sessions, files, monkeypatch):
    _, angles = files
    sweep_paths_dataset(sessions, angles, device="cpu")     # the memos are warm now
    reads = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: reads.append(1) or
                        real(self, *a, **k))
    got = sweep_paths_dataset(sessions, angles, device="cpu")
    assert len(reads) == 1 and len(got) == 3
    host = read_once([type(got[0][0])(*(torch.from_numpy(x) for x in got[0][0]))])
    for a, b in zip(host[0], got[0][0]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_mesh_refused_and_no_sessions(sessions, files):
    _, angles = files
    with pytest.raises(ValueError, match="pass mesh= or device=, not both"):
        sweep_paths_dataset(sessions, angles, mesh=make_mesh((1, 1), devices=["cpu"]),
                            device="cpu")
    assert sweep_paths_dataset([], angles, device="cpu") == []
