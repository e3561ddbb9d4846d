"""Port per-sweep estimation (``Session.sweep_paths``) == the JAX package's.

One synthetic session (4 sweeps of 64 x 43 frames, RSS from three planted
Gaussian-beam paths plus noise) and a 64-beam angle table (-43.6 ... +45.0
deg) written as xlsx; both packages read the same files, so the dictionary
grids are 886 x 886 at 0.1 deg.  ``Session.sweep_paths(device="cpu")``
against JAX's ``Session.sweep_paths``: sweep_valid, aoa_idx, aod_idx,
n_iters and valid equal, power within rtol 2e-4 / atol 1e-6 (the JAX
suite's tolerance between two engines); ``sweep_intensity`` and
``sweep_times`` exactly; every sweep against the float64 per-sweep host
oracle (pivot, compact submatrix, min fill, ``nn_omp_np``) at one grid
step (0.11 deg) and rtol 5e-2 on power.  Every sweep of this session
clears the near-tie margin of ``tests/test_torch_nn_omp.py`` (asserted),
so all are compared exactly.  Also the memo invalidation of
``tests/test_sweep_paths.py`` in port form, the estimator body on NaN
grids, and the copied xlsx, angle and timestamp helpers.
"""

import logging

import numpy as np
import pytest
import torch

from slam_process_tpu_torch.pipeline.session import Session
from slam_process_tpu_torch.utils.synthetic import (
    synthetic_session_bytes, to_hex_text, write_angle_table)
from tests.test_torch_nn_omp import NEAR_TIE, selection_margin

SESSION = dict(n_groups=4, frames_per_beam=43, baselines_per_group=9, junk_frac=0.02, seed=3,
               n_paths=3)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sweep_paths")
    log = tmp / "Serial Debug 2026-10-16 120000.txt"
    log.write_bytes(to_hex_text(synthetic_session_bytes(**SESSION)))
    return log, write_angle_table(tmp / "beam_angle.xlsx")


@pytest.fixture(scope="module")
def both(files):
    from slam_process_tpu.pipeline.session import Session as JaxSession

    log, angles = files
    port = Session.from_log(log, device="cpu")
    jax_s = JaxSession.from_log(log, engine="device")
    return port, jax_s, port.sweep_paths(angles, device="cpu"), jax_s.sweep_paths(angles)


def host_oracle(filtered, angle_file):
    from slam_process_tpu.config import DictionaryConfig, OmpConfig, SceneConfig
    from slam_process_tpu.io.angles import load_angle_lut
    from slam_process_tpu.models.dictionary import make_dictionary
    from slam_process_tpu.models.nn_omp import nn_omp_np
    from slam_process_tpu.ops.correct import detect_groups_np
    from slam_process_tpu.ops.scene import intensity_grid_np

    lut = load_angle_lut(angle_file)
    gid = detect_groups_np(filtered[:, 0])
    grid = intensity_grid_np(filtered[:, 0], filtered[:, 1], filtered[:, 2], cfg=SceneConfig())
    ue_ids = np.nonzero(grid.row_mask & np.isfinite(lut))[0]
    bs_ids = np.nonzero(grid.col_mask & np.isfinite(lut))[0]
    d = make_dictionary(lut[ue_ids], lut[bs_ids], DictionaryConfig(grid_res=0.1, beam_width=1.4))
    out = []
    for s in range(int(gid.max()) + 1):
        rows = filtered[gid == s]
        g = intensity_grid_np(rows[:, 0], rows[:, 1], rows[:, 2], cfg=SceneConfig())
        sub = np.asarray(g.mean)[np.ix_(ue_ids, bs_ids)]
        finite = np.isfinite(sub)
        sub = np.where(finite, sub, sub[finite].min())
        out.append((d, sub, nn_omp_np(d, sub, OmpConfig(max_paths=3), keep_rule="positive",
                                      stop_nonpositive=False)))
    return out


def test_sweep_paths_matches_jax_and_host_oracle(both, files):
    port, jax_s, (paths, valid), (want, want_valid) = both
    assert port.name == jax_s.name == "2026-10-16 120000"
    np.testing.assert_array_equal(port.filtered, jax_s.filtered)
    assert valid.dtype == bool and len(valid) == 4 and valid.all()
    np.testing.assert_array_equal(valid, np.asarray(want_valid))
    for field in paths._fields:
        got, w = getattr(paths, field), np.asarray(getattr(want, field))
        assert got.dtype == w.dtype and got.shape == w.shape, field
        if field == "power":
            np.testing.assert_allclose(got, w, rtol=2e-4, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, w, err_msg=field)
    assert paths.aoa_idx.max() < 886 and paths.valid.any()

    for s, (d, sub, ref) in enumerate(host_oracle(port.filtered, files[1])):
        assert d.phi_rx.shape[1] == d.phi_tx.shape[1] == 886
        assert selection_margin(d, sub, ref) >= NEAR_TIE, f"sweep {s} is a near tie"
        kept = ref.valid
        np.testing.assert_array_equal(paths.valid[s], kept)
        np.testing.assert_allclose(paths.aoa[s][kept], ref.aoa[kept], atol=0.11)
        np.testing.assert_allclose(paths.aod[s][kept], ref.aod[kept], atol=0.11)
        np.testing.assert_allclose(paths.power[s][kept], ref.power[kept], rtol=5e-2)


def test_sweep_intensity_and_times_match_jax(both):
    port, jax_s, _, _ = both
    mean, counts = port.sweep_intensity(device="cpu")
    want_mean, want_counts = jax_s.sweep_intensity()
    assert mean.dtype == np.float32 and counts.dtype == np.int32
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(mean, want_mean)          # NaN == NaN here
    np.testing.assert_array_equal(port.sweep_times(), jax_s.sweep_times())
    np.testing.assert_array_equal(port.sweep_times(max_sweeps=6), jax_s.sweep_times(6))


def test_sweep_memo_invalidated_on_recorrect(files):
    """Re-running correct() drops the sweep memo: results after the data
    change reflect the new filtered table and equal a fresh session's."""
    from slam_process_tpu_torch.io import read_hex_log
    from slam_process_tpu_torch.ops.decode import decode_frames_np

    log, angles = files
    s = Session("memo_check")
    s.frames = decode_frames_np(read_hex_log(log)).frames
    s.correct(device="cpu")
    _, valid_full = s.sweep_paths(angles, device="cpu")

    s.frames = s.frames[: len(s.frames) // 2]
    s.correct(device="cpu")
    paths_half, valid_half = s.sweep_paths(angles, device="cpu")
    assert len(valid_half) < len(valid_full)

    fresh = Session("memo_fresh")
    fresh.frames = s.frames
    fresh.correct(device="cpu")
    paths_ref, valid_ref = fresh.sweep_paths(angles, device="cpu")
    np.testing.assert_array_equal(valid_half, valid_ref)
    np.testing.assert_array_equal(paths_half.aoa_idx, paths_ref.aoa_idx)
    np.testing.assert_array_equal(paths_half.aod_idx, paths_ref.aod_idx)


@pytest.mark.parametrize("overrides", [{}, dict(max_paths=2, grid_res=0.5, beam_width=2.0)])
def test_sweep_estimator_body_fill_matches_jax(overrides):
    """The per-sweep fill (each sweep's finite minimum, 0 for an all-NaN
    sweep, which reports sweep_valid False) and the estimator body against
    JAX's on NaN-holed grids, with the default settings and with the
    keyword overrides that ``sweep_paths`` passes on."""
    import jax

    from slam_process_tpu.models import sweep_estimation as jax_est
    from slam_process_tpu.utils.precision import jit_highest
    from slam_process_tpu_torch.models import sweep_estimation

    rng = np.random.default_rng(6)
    ue_ang = np.linspace(-20.0, 20.0, 12).astype(np.float32)
    bs_ang = np.linspace(-15.0, 25.0, 10).astype(np.float32)
    mats = (rng.random((4, 12, 10)) * 1000).astype(np.float32)
    mats[rng.random(mats.shape) < 0.3] = np.nan
    mats[2] = np.nan
    d_j, key_j = jax_est.sweep_estimator_setup("nn_omp", ue_ang, bs_ang, **overrides)
    d, key = sweep_estimation.sweep_estimator_setup("nn_omp", ue_ang, bs_ang, **overrides)
    assert key[0] == "nn_omp" and key[2:] == ("positive", False)
    assert key[1].max_paths == overrides.get("max_paths", 3) == key_j[1].max_paths
    for a, b in zip(d, d_j):
        np.testing.assert_array_equal(a, b)
    args = [np.asarray(x, np.float32) for x in (mats, d.phi_rx, d.phi_tx, d.aoa_grid,
                                                d.aod_grid)]
    want, want_valid = jax.device_get(jit_highest(jax_est.sweep_estimator_body(key_j))(*args))
    got, valid = sweep_estimation.sweep_estimator_body(key)(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(valid.numpy(), [True, True, False, True])
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    for field in ("aoa_idx", "aod_idx", "n_iters", "valid"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_allclose(got.power.numpy(), np.asarray(want.power), rtol=2e-4, atol=1e-6)
    # sm_sic is ported: its setup gives JAX's key and dictionary.
    d_s, key_s = sweep_estimation.sweep_estimator_setup("sm_sic", ue_ang, bs_ang, **overrides)
    d_sj, key_sj = jax_est.sweep_estimator_setup("sm_sic", ue_ang, bs_ang, **overrides)
    assert key_s[0] == "sm_sic" and key_s[2:] == key_sj[2:] == (None, None)
    assert vars(key_s[1]) == vars(key_sj[1])
    for a, b in zip(d_s, d_sj):
        np.testing.assert_array_equal(a, b)


def test_xlsx_angles_and_timestamps_match_jax(tmp_path, caplog):
    from slam_process_tpu.io import angles as jax_angles
    from slam_process_tpu.io import xlsx as jax_xlsx
    from slam_process_tpu.utils import timestamps as jax_ts
    from slam_process_tpu_torch.io import angles, xlsx
    from slam_process_tpu_torch.utils import timestamps

    data = np.array([[0, -43.6, 1.5], [1, 2.0, np.nan], [63, 45.0, 7.25]])
    ours = xlsx.write_xlsx_table(tmp_path / "ours.xlsx", ["BeamID", "Angle", "x"], data)
    theirs = jax_xlsx.write_xlsx_table(tmp_path / "theirs.xlsx", ["BeamID", "Angle", "x"], data)
    for path in (ours, theirs):
        names, got = xlsx.read_xlsx_table(path)
        want_names, want = jax_xlsx.read_xlsx_table(path)
        assert names == want_names == ["BeamID", "Angle", "x"]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(angles.load_angle_lut(path),
                                      jax_angles.load_angle_lut(path))
        assert angles.load_angle_map(path) == jax_angles.load_angle_map(path)

    for name in ("Serial Debug 2026-01-26 164520_filtered.xlsx", "x_2026-02-06_091211.txt",
                 "no timestamp.txt"):
        assert timestamps.extract_timestamp(name) == jax_ts.extract_timestamp(name)
    anchors = np.array([5, (1 << 30) - 10, 20, -1, 15, 1 << 29], dtype=np.int64)
    with caplog.at_level(logging.WARNING):
        np.testing.assert_array_equal(timestamps.unwrap_clk_anchors(anchors, logging.getLogger()),
                                      jax_ts.unwrap_clk_anchors(anchors))
    assert "non-wrap" in caplog.text
