"""SM-SIC on the port (``models/sm_sic.py``) against the JAX package, on
the CPU.

  * ``sm_sic_np`` (the port's copy) equals JAX's float64 oracle exactly.
  * ``sm_sic`` on one scene and on [S] sweeps against the oracle
    (float64 grids: the same masks; peaks equal, metric within rtol 1e-6
    of the float64 surface).  Every scene's peaks clear a near-tie margin
    of ``NEAR_TIE`` (asserted), so a difference would be a fault, not
    rounding.  Against JAX's ``sm_sic_jax`` on the same float32 operands
    the peaks are equal up to the first step whose mask JAX's float32
    geometry draws differently from the oracle's (``float32_masks_agree``:
    its float32 grid points leave the masks' radii); the port follows the
    oracle there.  Exact ties (a zero scene; a negative scene's masked
    cells) take the first flat index in every implementation.
  * ``run_estimator("sm_sic")``: the host engine's table is pandas' text
    of the JAX entry's DataFrame byte for byte; the device engine equals
    the host engine (metric within rtol 1e-6); ``cli estimate --model
    sm_sic --engine host`` prints the JAX CLI's lines, and so do
    ``--per-sweep`` and ``--tracks`` (their tables within rtol 2e-4).
  * Per sweep: ``Session.sweep_paths(estimator="sm_sic")`` against the
    per-sweep oracle and against JAX's (as above); ``path_tracks`` (power := metric)
    with the device tracker against the host one and JAX's; the online
    paths of an SM-SIC device stream against the offline ones exactly
    (``tests/test_streaming_paths.py``'s SM-SIC case), the same stream
    resumed from a checkpoint too, and the host engine's stream.
"""

import numpy as np
import pytest
import torch

from slam_process_tpu_torch.config import DictionaryConfig, SmSicConfig
from slam_process_tpu_torch.models import registry
from slam_process_tpu_torch.models.dictionary import make_dictionary
from slam_process_tpu_torch.models.sm_sic import SmSicPaths, run_sm_sic, sm_sic, sm_sic_np
from slam_process_tpu_torch.pipeline.session import Session
from slam_process_tpu_torch.utils.synthetic import (
    ANGLES, synthetic_session_bytes, to_hex_text, write_angle_table)

CFG = SmSicConfig()
NEAR_TIE = 1e-5


def dictionary(ue_ang=ANGLES, bs_ang=ANGLES, cfg=CFG):
    return make_dictionary(ue_ang, bs_ang, DictionaryConfig(
        grid_res=cfg.grid_res, beam_width=cfg.beam_width, grid_kind="arange_inclusive"))


def planted_scene(seed, n_paths=3, shape=(64, 64)):
    """A [U, B] scene of a few Gaussian-beam paths plus noise."""
    rng = np.random.default_rng(seed)
    ue, bs = ANGLES[:shape[0]], ANGLES[:shape[1]]
    m = rng.random(shape) * 40.0
    for _ in range(n_paths):
        a, d = rng.uniform(-40, 40, 2)
        p = rng.uniform(500, 4000)
        m += p * np.exp(-((ue[:, None] - a) ** 2 + (bs[None, :] - d) ** 2) / (2 * 3.0 ** 2))
    return m


def margins(d, mat, cfg=CFG):
    """Per valid step of the float64 oracle: the gap between the masked
    surface's two largest values and between the peak and the stop
    threshold, relative to the peak."""
    corr = d.phi_rx.T @ mat.astype(np.float64) @ d.phi_tx
    ref = sm_sic_np(d, mat, cfg)
    A, D = np.meshgrid(d.aoa_grid, d.aod_grid, indexing="ij")
    mask = np.ones_like(corr)
    out = []
    for k in range(cfg.max_paths + 1):
        masked = (corr * mask).ravel()
        top2 = np.sort(masked)[-2:]
        peak = top2[1]
        gap = (top2[1] - top2[0]) / abs(peak)
        if k > 0:
            gap = min(gap, abs(peak - cfg.stop_ratio * ref.metric[0]) / abs(peak))
        out.append(gap)
        if k >= cfg.max_paths or not ref.valid[k]:
            break
        a, dd = ref.aoa[k], ref.aod[k]
        if k == 0:
            mask *= ((A - a) ** 2 + (D - dd) ** 2 > cfg.proximity_mask_radius ** 2)
            mask *= np.abs(D - dd) > cfg.cross_mask_width / 2
            mask *= np.abs(A - a) > cfg.cross_mask_width / 2
        else:
            mask *= (A - a) ** 2 + (D - dd) ** 2 > cfg.nlos_mask_radius ** 2
    return min(out)


def assert_peaks_equal(got, want, metric_rtol=1e-6, slots=None):
    """``got`` has ``want``'s peaks: valid, is_los, angles equal and the
    metric within ``metric_rtol``, on the valid slots (or the first
    ``slots`` of them, valid or not)."""
    valid = np.asarray(want.valid)
    keep = valid if slots is None else np.arange(valid.shape[-1]) < slots
    for field in ("valid", "is_los", "aoa", "aod"):
        a, b = np.asarray(getattr(got, field)), np.asarray(getattr(want, field))
        if np.float32 in (a.dtype, b.dtype):       # the angles of float32 grids
            a, b = a.astype(np.float32), b.astype(np.float32)
        np.testing.assert_array_equal(a[keep], b[keep], err_msg=field)
    np.testing.assert_allclose(np.asarray(got.metric)[keep], np.asarray(want.metric)[keep],
                               rtol=metric_rtol)


def float32_masks_agree(d, paths, cfg=CFG) -> int:
    """How many leading slots of SM-SIC ``paths`` (one scene, [K]) see the
    same masks under ``sm_sic_jax``'s float32 geometry (float32 grid
    points, float32 arithmetic) as under the oracle's float64 one.  Past
    the first step whose mask differs, JAX's later peaks may differ from
    the oracle's: its float32 grid points move off the masks' radii (0.5
    deg steps against radii of 1, 2 and 2.5 deg)."""
    masks = []
    for dtype in (np.float64, np.float32):
        ga, gd = (np.asarray(g, dtype) for g in (d.aoa_grid, d.aod_grid))
        A, D = np.meshgrid(ga, gd, indexing="ij")
        steps = []
        for k in range(cfg.max_paths):
            a = ga[np.argmin(np.abs(d.aoa_grid - paths.aoa[k]))]
            dd = gd[np.argmin(np.abs(d.aod_grid - paths.aod[k]))]
            dist = (A - a) * (A - a) + (D - dd) * (D - dd)
            if k == 0:
                m = ((dist > dtype(cfg.proximity_mask_radius ** 2))
                     & (np.abs(D - dd) > dtype(cfg.cross_mask_width / 2))
                     & (np.abs(A - a) > dtype(cfg.cross_mask_width / 2)))
            else:
                m = dist > dtype(cfg.nlos_mask_radius ** 2)
            steps.append(m)
        masks.append(steps)
    n = 1
    while n < cfg.max_paths and (masks[0][n - 1] == masks[1][n - 1]).all():
        n += 1
    return n


def test_oracle_copy_equals_jax():
    from slam_process_tpu.config import SmSicConfig as JaxCfg
    from slam_process_tpu.models.sm_sic import sm_sic_np as jax_np

    d = dictionary()
    for seed in range(3):
        mat = planted_scene(seed)
        for cfg in (CFG, SmSicConfig(max_paths=5, stop_ratio=0.5, nlos_mask_radius=3.0)):
            got = sm_sic_np(d, mat, cfg)
            want = jax_np(d, mat, JaxCfg(**vars(cfg)))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(6))
def test_one_scene_matches_oracle(seed):
    d = dictionary()
    mat = planted_scene(seed, n_paths=1 + seed % 4)
    assert margins(d, mat) > NEAR_TIE
    want = sm_sic_np(d, mat, CFG)
    got = run_sm_sic(d, mat, CFG, device="cpu")
    assert got.aoa.dtype == np.float64 and got.metric.dtype == np.float32
    assert_peaks_equal(got, want)
    host = run_sm_sic(d, mat, CFG, engine="host")
    for a, b in zip(host, want):
        np.testing.assert_array_equal(a, b)


def test_batch_of_sweeps_matches_per_scene_and_jax():
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.config import SmSicConfig as JaxCfg
    from slam_process_tpu.models.sm_sic import sm_sic_jax

    d = dictionary(ANGLES[:48], ANGLES[8:])
    mats = np.stack([planted_scene(10 + s, n_paths=1 + s % 3, shape=(64, 64))[:48, 8:]
                     for s in range(6)])
    f32 = [torch.from_numpy(np.asarray(x, np.float32)) for x in (d.phi_rx, d.phi_tx)]
    g64 = [torch.from_numpy(np.asarray(g, np.float64)) for g in (d.aoa_grid, d.aod_grid)]
    got = sm_sic(*f32, *g64, torch.from_numpy(mats.astype(np.float32)), CFG)
    assert got.aoa.shape == (6, CFG.max_paths)
    for s in range(6):
        assert margins(d, mats[s]) > NEAR_TIE
        one = run_sm_sic(d, mats[s], CFG, device="cpu")
        for a, b in zip(got, one):
            np.testing.assert_array_equal(a[s].numpy(), b)
        assert_peaks_equal(SmSicPaths(*(x[s].numpy() for x in got)),
                           sm_sic_np(d, mats[s], CFG))
    # JAX's device program on the same float32 operands: equal up to the
    # first step whose float32 mask differs from the oracle's.
    fn = jax.jit(jax.vmap(lambda m, *a: sm_sic_jax(*a, m, cfg=JaxCfg()),
                          in_axes=(0, None, None, None, None)))
    with jax.default_matmul_precision("highest"):
        want = fn(jnp.asarray(mats, jnp.float32), *(jnp.asarray(np.asarray(x, np.float32))
                                                    for x in (d.phi_rx, d.phi_tx, d.aoa_grid,
                                                              d.aod_grid)))
    compared = 0
    for s in range(6):
        one = SmSicPaths(*(x[s].numpy() for x in got))
        n = float32_masks_agree(d, one)
        assert_peaks_equal(one, SmSicPaths(*(np.asarray(x[s]) for x in want)), slots=n)
        compared += n
    assert compared >= 12


@pytest.mark.parametrize("kind", ["zeros", "negative"])
def test_exact_ties_take_the_first_flat_index(kind):
    """A zero scene ties every cell; a negative scene's masked cells (0,
    above every negative correlation) tie after the first peak.  Each tie
    goes to the first flat index, in the port, the oracle and JAX."""
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.config import SmSicConfig as JaxCfg
    from slam_process_tpu.models.sm_sic import sm_sic_jax

    d = dictionary()
    mat = np.zeros((64, 64)) if kind == "zeros" else -planted_scene(3)
    want = sm_sic_np(d, mat, CFG)
    got = run_sm_sic(d, mat, CFG, device="cpu")
    assert_peaks_equal(got, want)
    assert want.valid.all()
    if kind == "zeros":
        assert (want.aoa == d.aoa_grid[0]).all() and (want.aod == d.aod_grid[0]).all()
    else:                                  # the first zeroed cell in flat order
        zeroed = np.nonzero(((d.aoa_grid[:, None] - want.aoa[0]) ** 2
                             + (d.aod_grid[None, :] - want.aod[0]) ** 2 <= 4.0)
                            | (np.abs(d.aod_grid[None, :] - want.aod[0]) <= 2.5)
                            | (np.abs(d.aoa_grid[:, None] - want.aoa[0]) <= 2.5))
        assert want.metric[1] == 0
        assert (want.aoa[1], want.aod[1]) == (d.aoa_grid[zeroed[0][0]],
                                              d.aod_grid[zeroed[1][0]])
    jax_out = jax.jit(lambda *a: sm_sic_jax(*a, cfg=JaxCfg()))(
        *(jnp.asarray(np.asarray(x, np.float32)) for x in (d.phi_rx, d.phi_tx, d.aoa_grid,
                                                           d.aod_grid, mat)))
    assert_peaks_equal(got, jax_out, slots=float32_masks_agree(d, got))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sm_sic")
    log = tmp / "Serial Debug 2026-10-17 090000.txt"
    log.write_bytes(to_hex_text(synthetic_session_bytes(
        n_groups=5, frames_per_beam=6, baselines_per_group=9, junk_frac=0.02, seed=17,
        n_paths=3), "shipped"))
    return log, write_angle_table(tmp / "beam_angle.xlsx")


def test_run_estimator_engines_and_jax_table(files):
    import pandas as pd

    from slam_process_tpu.models import run_estimator as jax_run
    from slam_process_tpu.pipeline.session import Session as JaxSession

    log, angles = files
    s = Session.from_log(log, device="cpu")
    host = registry.run_estimator("sm_sic", s, angles, engine="host", device="cpu")
    want = jax_run("sm_sic", JaxSession.from_log(log, engine="host"), angles, None)
    assert isinstance(want, pd.DataFrame) and len(want) >= 1
    assert host.to_string(index=False) == want.to_string(index=False)
    assert host.to_dict("records") == want.to_dict("records")
    dev = registry.run_estimator("sm_sic", s, angles, device="cpu")
    assert list(dev["type"]) == list(host["type"]) and list(dev["id"]) == list(host["id"])
    np.testing.assert_array_equal(dev["aoa"], host["aoa"])
    np.testing.assert_array_equal(dev["aod"], host["aod"])
    np.testing.assert_allclose(dev["metric"], host["metric"], rtol=1e-6)
    assert "sm_sic" in registry.PORTED and not hasattr(registry, "NOT_PORTED")


def test_table_prints_like_pandas():
    import pandas as pd

    cols = {"id": np.arange(1, 4), "type": ["LoS", "NLoS", "NLoS"],
            "aoa": np.array([1.5, -2.25, 10.0]), "aod": np.float32([3.5, 4, 5]),
            "metric": np.array([1234.5678, 22.1, 3e-9])}
    table = registry.Table(cols)
    df = pd.DataFrame(cols)
    assert table.to_string(index=False) == df.to_string(index=False)
    assert table.to_dict("records") == df.to_dict("records")
    empty = registry.Table({k: (v[:0] if not isinstance(v, list) else []) for k, v in
                            cols.items()})
    assert empty.to_string(index=False) == df.iloc[:0].to_string(index=False)


@pytest.fixture(scope="module")
def session_pair(files):
    from slam_process_tpu.pipeline.session import Session as JaxSession

    log, angles = files
    return Session.from_log(log, device="cpu"), JaxSession.from_log(log, engine="device")


def per_sweep_oracle(s, angles):
    """sm_sic_np per sweep on the session's compact per-sweep grids, each
    filled with its sweep's minimum."""
    sub, d, key, n = s._sweep_estimation_inputs(angles, "sm_sic", None, torch.device("cpu"))
    gid, n_sweeps, ue_ids, bs_ids, d64, _ = s._sweep_host_prep(angles, "sm_sic")
    out = []
    for m in sub.numpy():
        finite = np.isfinite(m)
        out.append((d64, np.where(finite, m, m[finite].min()).astype(np.float32)))
    return out


def test_sweep_paths_match_oracle_and_jax(session_pair, files):
    s, jax_s = session_pair
    _, angles = files
    paths, valid = s.sweep_paths(angles, estimator="sm_sic", device="cpu")
    assert isinstance(paths, SmSicPaths) and paths.aoa.dtype == np.float32 and valid.all()
    for k, (d64, m) in enumerate(per_sweep_oracle(s, angles)):
        assert margins(d64, m) > NEAR_TIE
        assert_peaks_equal(SmSicPaths(*(x[k] for x in paths)), sm_sic_np(d64, m, CFG))
    want, want_valid = jax_s.sweep_paths(angles, estimator="sm_sic")
    np.testing.assert_array_equal(valid, want_valid)
    d64 = s._sweep_host_prep(angles, "sm_sic")[4]
    for k in range(len(valid)):
        one = SmSicPaths(*(x[k] for x in paths))
        assert_peaks_equal(one, SmSicPaths(*(np.asarray(x)[k] for x in want)),
                           slots=float32_masks_agree(d64, one))


def test_path_tracks_match_host_and_jax(session_pair, files):
    s, jax_s = session_pair
    _, angles = files
    dev = s.path_tracks(angles, estimator="sm_sic", device="cpu")
    host = s.path_tracks(angles, estimator="sm_sic", engine="host", device="cpu")
    want = jax_s.path_tracks(angles, estimator="sm_sic")
    for got in (dev, host):
        tracks, times, vel = got
        assert int(tracks.n_tracks) == int(want[0].n_tracks) > 0
        for f in ("pos_aoa", "pos_aod", "observed", "created"):
            np.testing.assert_array_equal(getattr(tracks, f), getattr(want[0], f), err_msg=f)
        np.testing.assert_allclose(tracks.power, want[0].power, rtol=1e-6)
        np.testing.assert_array_equal(times, want[1])
    np.testing.assert_array_equal(dev[0].power, host[0].power)


def test_online_paths_match_offline(session_pair, files, tmp_path):
    from slam_process_tpu_torch.parallel.streaming_device import (
        DeviceStreamingSession, make_paths_spec, replay_log_device)
    from slam_process_tpu_torch.io.hexlog import read_hex_log

    s, _ = session_pair
    log, angles = files
    raw = read_hex_log(log)
    spec = make_paths_spec(angles, estimator="sm_sic", s_step=16)
    assert spec[1][2].dtype == np.float64 and spec[1][0].dtype == np.float32
    ids = (spec[0].ue_ids, spec[0].bs_ids)
    want = (s.sweep_paths(angles, estimator="sm_sic", beam_ids=ids, device="cpu"),
            s.path_tracks(angles, estimator="sm_sic", beam_ids=ids, device="cpu"))
    full = replay_log_device(raw, chunk_bytes=1 << 12, collect_paths=spec, device="cpu")
    part = DeviceStreamingSession(chunk_bytes=1 << 12, collect_paths=spec, device="cpu")
    part.feed(raw[:len(raw) // 2])
    part.save_checkpoint(tmp_path / "sm_sic.ckpt")
    resumed = DeviceStreamingSession.restore(tmp_path / "sm_sic.ckpt", device="cpu")
    resumed.feed(raw[len(raw) // 2:])
    resumed.finalize()
    from slam_process_tpu_torch.parallel.streaming import replay_log

    host = replay_log(raw, chunk_bytes=1 << 12, collect_paths=spec)
    for stream in (full, resumed, host):
        (paths, valid), (tracks, times, vel) = stream.sweep_paths(), stream.path_tracks()
        assert isinstance(paths, SmSicPaths)
        np.testing.assert_array_equal(valid, want[0][1])
        for a, b in zip(paths, want[0][0]):
            np.testing.assert_array_equal(a, b)
        for f in ("pos_aoa", "pos_aod", "power", "observed", "created"):
            np.testing.assert_array_equal(getattr(tracks, f), getattr(want[1][0], f))
        np.testing.assert_array_equal(times, want[1][1])


@pytest.mark.parametrize("mode", ["table", "per_sweep", "tracks"])
def test_cli_estimate_sm_sic_matches_jax(tmp_path, capsys, files, mode):
    from slam_process_tpu.pipeline import cli as jax_cli
    from slam_process_tpu_torch.pipeline import cli
    from test_torch_cli import assert_tables_close, own, run

    log, angles = files
    extra = {"table": ["--engine", "host"], "per_sweep": ["--per-sweep"],
             "tracks": ["--tracks"]}[mode]
    argv = ["estimate", "--input", str(log), "--mapping", str(angles), "--model", "sm_sic",
            *extra]
    suffix = ".png" if mode == "table" else ".xlsx"
    outs = {who: tmp_path / f"{who}{suffix}" for who in ("port", "jax")}
    rc, got = run(cli.main, argv + ["--output", str(outs["port"]), "--device", "cpu"], capsys)
    rc_j, want = run(jax_cli.main, argv + ["--output", str(outs["jax"])], capsys)
    assert rc == rc_j == 0
    got, want = own(got), own(want)
    if mode == "table":
        assert got[:-1] == want[:-1] and len(got) > 2
        return

    def printed(lines, who):
        return [ln.replace(str(outs[who].with_suffix("")), "OUT") for ln in lines]

    assert printed(got, "port") == printed(want, "jax")
    if mode == "per_sweep":
        assert_tables_close(outs["port"], outs["jax"], {"Sweep", "CLK", "Path"})
    else:
        assert_tables_close(outs["port"], outs["jax"], {"Track", "Sweep", "CLK"})
