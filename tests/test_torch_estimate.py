"""The port's session estimator (slam_process_tpu_torch) == the JAX package's.

* ``nn_omp_np``: the port's copy equals JAX's exactly, on both keep rules
  and both stop rules.
* ``nn_omp_scenes`` on the CPU against the JAX package's vmapped dataset
  program (jitted with HIGHEST matmuls, as it runs) on the same packed
  scenes, and against the float64 oracle ``nn_omp_np``: index sequences,
  ``n_iters`` and ``valid`` equal, power within rtol 2e-4.  A scene whose
  top two oracle correlations at some iteration sit within ``NEAR_TIE`` of
  the surface's scale (``tests/test_torch_nn_omp.py``) is excused from the
  index comparison; the test prints how many it excused.  Under v1's rule
  (no stop on a non-positive maximum) a padded atom may be selected
  (``models/batch_estimation.py``), so v1 compares the valid paths.
* The LU and Gauss-Jordan NNLS solves reach the same selections at K = 20.
* ``pack_scenes`` equals JAX's arrays exactly.
* ``estimate_sessions`` over three sessions of different shapes equals
  JAX's ``estimate_sessions`` and the port's per-session device runs.
* ``run_estimator`` for each of the five NN-OMP flavors against JAX's
  ``run_estimator`` with the same engine: ``engine="host"`` gives an equal
  table (values exact, ``to_string(index=False)`` byte-equal);
  ``engine="device"`` the same scene bit for bit, the same selections, power
  within rtol 2e-4, the port's classifier on JAX's own paths JAX's labels
  exactly, and end to end equal labels for every path whose power ratio to
  the LoS lies more than the power tolerance from a classifier threshold
  (the test prints how many lie inside).
* ``PathsTable`` prints pandas' text: the estimator's tables, an empty
  table, one row, a Power column in exponent notation.
* The port has the JAX registry's 13 names (the other seven families:
  ``tests/test_torch_estimators.py``); an unknown name raises ``KeyError``.
"""

import numpy as np
import pytest
import torch

from slam_process_tpu.config import DictionaryConfig as JaxDictionaryConfig
from slam_process_tpu.config import OmpConfig as JaxOmpConfig
from slam_process_tpu.models import batch_estimation as jax_batch
from slam_process_tpu.models import classifiers as jax_classifiers
from slam_process_tpu.models import dictionary as jax_dictionary
from slam_process_tpu.models import nn_omp as jax_nn_omp
from slam_process_tpu.models import registry as jax_registry
from slam_process_tpu.pipeline.session import Session as JaxSession
from slam_process_tpu_torch.config import OmpConfig
from slam_process_tpu_torch.convert import packed_scenes_from_reference
from slam_process_tpu_torch.models import batch_estimation, classifiers, registry
from slam_process_tpu_torch.models.dictionary import make_dictionary
from slam_process_tpu_torch.models.nn_omp import nn_omp_np, nn_omp_scenes, run_nn_omp
from slam_process_tpu_torch.pipeline.session import Session
from slam_process_tpu_torch.utils.synthetic import (
    synthetic_session_bytes, to_hex_text, write_angle_table)
from test_torch_nn_omp import NEAR_TIE, selection_margin

RTOL = 2e-4
# Two powers each within RTOL of their reference can move a ratio by this
# much (dB); a label decided closer than this to a threshold may differ.
MARGIN_DB = 2 * 10 * np.log10(1 + RTOL)
FLAVORS = ("nn_omp", "nn_omp_v1", "nn_omp_v14", "nn_omp_v15", "nn_omp_v16")
# Each flavor's classifier thresholds on 10 log10(p / p_LoS), in dB.
THRESHOLDS_DB = {"nn_omp": (-0.15, -0.01), "nn_omp_v1": (), "nn_omp_v14": (10 * np.log10(0.5),),
                 "nn_omp_v15": (-10.0,), "nn_omp_v16": (-0.15, -0.01)}
CLASSIFY = {"nn_omp": lambda m, p: m.classify_advanced(p.aoa, p.aod, p.power, p.valid),
            "nn_omp_v1": lambda m, p: m.classify_argmax(p.aoa, p.aod, p.power, p.valid),
            "nn_omp_v14": lambda m, p: m.classify_weak_far(p.aoa, p.aod, p.power, p.valid),
            "nn_omp_v15": lambda m, p: m.classify_cross_region(p.aoa, p.aod, p.power, p.valid),
            "nn_omp_v16": lambda m, p: m.classify_advanced(p.aoa, p.aod, p.power, p.valid)}
RULES = {"v1-7": (JaxOmpConfig(max_paths=20, min_power_ratio=0.0003), "ratio", True),
         "v1": (JaxOmpConfig(max_paths=3), "positive", False)}


def port_cfg(cfg):
    return OmpConfig(max_paths=cfg.max_paths, min_power_ratio=cfg.min_power_ratio,
                     nnls_max_iter=cfg.nnls_max_iter)


def synthetic_scenes(seed, shapes, grid_res=0.5, kind="linspace"):
    """Scenes of planted dictionary atoms plus noise (as
    tests/test_batch_estimation.py's), one dictionary each."""
    rng = np.random.default_rng(seed)
    mats, dicts = [], []
    for u, b, span in shapes:
        ue = np.sort(rng.uniform(-span, span, u))
        bs = np.sort(rng.uniform(-span, span, b))
        d = jax_dictionary.make_dictionary(ue, bs, JaxDictionaryConfig(
            grid_res=grid_res, beam_width=1.4, grid_kind=kind))
        m = rng.random((u, b)) * 0.1
        for _ in range(4):
            m += rng.uniform(0.5, 2.0) * np.outer(d.phi_rx[:, rng.integers(len(d.aoa_grid))],
                                                  d.phi_tx[:, rng.integers(len(d.aod_grid))])
        mats.append(m)
        dicts.append(d)
    return mats, dicts


SHAPES = [(6, 9, 20.0), (16, 4, 55.0), (10, 10, 8.0), (12, 14, 30.0)]


@pytest.mark.parametrize("keep_rule", ["ratio", "positive"])
@pytest.mark.parametrize("stop_nonpositive", [True, False])
def test_nn_omp_np_matches_jax_exactly(keep_rule, stop_nonpositive):
    mats, dicts = synthetic_scenes(1, SHAPES)
    # Negative cells make the stop rule matter.
    mats = [m - 0.4 for m in mats]
    cfg = JaxOmpConfig(max_paths=6, min_power_ratio=0.05)
    for m, d in zip(mats, dicts):
        want = jax_nn_omp.nn_omp_np(d, m, cfg, keep_rule, stop_nonpositive)
        got = nn_omp_np(d, m, port_cfg(cfg), keep_rule, stop_nonpositive)
        assert got.n_iters == want.n_iters
        for field in ("aoa", "aod", "power", "valid", "aoa_idx", "aod_idx"):
            g, w = getattr(got, field), getattr(want, field)
            assert g.dtype == w.dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)


def jax_vmapped(packed, cfg, keep_rule, stop_np):
    import jax
    import jax.numpy as jnp

    fn = jax_batch._batched_nn_omp_fn(cfg, keep_rule, stop_np)
    return jax.device_get(fn(*(jnp.asarray(x) for x in packed[:5])))


def lane(paths, i):
    return type(paths)(*(np.asarray(x)[i] for x in paths))


def assert_same_paths(got, want, what, valid_only=False):
    """Selections equal (all slots, or only the valid ones) and power
    within RTOL."""
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(np.asarray(got.valid), valid, err_msg=f"{what} valid")
    keep = valid if valid_only else slice(None)
    for field in ("aoa_idx", "aod_idx"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field))[keep],
                                      np.asarray(getattr(want, field))[keep],
                                      err_msg=f"{what} {field}")
    if not valid_only:
        assert int(got.n_iters) == int(want.n_iters), what
    n = int(want.n_iters)
    sel = valid if valid_only else slice(0, n)
    np.testing.assert_allclose(np.asarray(got.power)[sel], np.asarray(want.power)[sel],
                               rtol=RTOL, atol=1e-6, err_msg=f"{what} power")


@pytest.mark.parametrize("flavor", ["v1-7", "v1"])
def test_nn_omp_scenes_matches_jax_and_oracle(flavor, capsys):
    cfg, keep_rule, stop_np = RULES[flavor]
    mats, dicts = synthetic_scenes(2, SHAPES, kind="linspace" if flavor == "v1-7" else "arange")
    packed = jax_batch.pack_scenes(mats, dicts)
    want = jax_vmapped(packed, cfg, keep_rule, stop_np)
    p = packed_scenes_from_reference(packed, device="cpu")
    got = nn_omp_scenes(p.phi_rx, p.phi_tx, p.aoa_grid, p.aod_grid, p.matrices, port_cfg(cfg),
                        keep_rule, stop_np)
    assert got.power.dtype == torch.float32 and got.n_iters.dtype == torch.int32
    got = type(got)(*(x.numpy() for x in got))
    excused = 0
    for i, (m, d) in enumerate(zip(mats, dicts)):
        ref = jax_nn_omp.nn_omp_np(d, m, cfg, keep_rule, stop_np)
        if selection_margin(d, m, ref) < NEAR_TIE:
            excused += 1
            continue
        assert_same_paths(lane(got, i), lane(want, i), f"scene {i} vs JAX",
                          valid_only=not stop_np)
        assert_same_paths(lane(got, i), ref, f"scene {i} vs nn_omp_np", valid_only=not stop_np)
    with capsys.disabled():
        print(f"\nnn_omp_scenes {flavor}: {excused} of {len(mats)} scenes excused as near ties")
    assert excused <= 1


def test_lu_and_gauss_jordan_select_alike_at_k20():
    cfg, keep_rule, stop_np = RULES["v1-7"]
    mats, dicts = synthetic_scenes(3, SHAPES + [(20, 18, 40.0)])
    p = packed_scenes_from_reference(jax_batch.pack_scenes(mats, dicts), device="cpu")
    runs = {solver: nn_omp_scenes(p.phi_rx, p.phi_tx, p.aoa_grid, p.aod_grid, p.matrices,
                                  port_cfg(cfg), keep_rule, stop_np, nnls_solver=solver)
            for solver in ("lu", "auto")}
    lu, gj = runs["lu"], runs["auto"]
    for field in ("aoa_idx", "aod_idx", "n_iters", "valid"):
        assert torch.equal(getattr(lu, field), getattr(gj, field)), field
    assert int(lu.n_iters.max()) > 3   # K > 3: the Gauss-Jordan path ran
    torch.testing.assert_close(lu.power, gj.power, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("pad_to", [None, (20, 20, 300, 260)])
def test_pack_scenes_matches_jax(pad_to):
    mats, dicts = synthetic_scenes(4, SHAPES)
    want = jax_batch.pack_scenes(mats, dicts, pad_to=pad_to)
    got = batch_estimation.pack_scenes(mats, dicts, pad_to=pad_to)
    assert got._fields == want._fields
    for g, w, name in zip(got, want, want._fields):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    moved = packed_scenes_from_reference(want, device="cpu")
    for g, w in zip(moved, want):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="pad_to"):
        batch_estimation.pack_scenes(mats, dicts, pad_to=(1, 1, 1, 1))


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def angles(tmp_path_factory):
    return write_angle_table(tmp_path_factory.mktemp("angles") / "beam_angle.xlsx")


def session_pair(tmp_path, name, drop_ue=(), drop_bs=(), **kw):
    """(port Session, JAX Session) over the same filtered rows: a seeded
    multipath log decoded and corrected on the CPU, with the rows of the
    ``drop_*`` beams removed (so scenes differ in shape)."""
    args = dict(n_groups=3, frames_per_beam=2, baselines_per_group=5, seed=3, n_paths=3)
    args.update(kw)
    path = tmp_path / f"{name}.txt"
    path.write_bytes(to_hex_text(synthetic_session_bytes(**args)))
    s = Session.from_log(path, device="cpu")
    f = s.filtered
    s.filtered = f[~np.isin(f[:, 0], drop_ue) & ~np.isin(f[:, 1], drop_bs)]
    js = JaxSession(name=name)
    js.filtered = s.filtered.copy()
    return s, js


@pytest.mark.parametrize("flavor", ["v1-7", "v1"])
def test_estimate_sessions_matches_jax_and_per_session(tmp_path, angles, flavor, capsys):
    pairs = [session_pair(tmp_path, "a"),
             session_pair(tmp_path, "b", drop_ue=range(10), seed=4),
             session_pair(tmp_path, "c", drop_bs=range(40, 64), n_groups=2, seed=5)]
    kw = dict(grid_res=1.0)
    got = batch_estimation.estimate_sessions([s for s, _ in pairs], angles, flavor,
                                             device="cpu", **kw)
    want = jax_batch.estimate_sessions([js for _, js in pairs], angles, flavor, **kw)
    dict_cfg, cfg, log_t, keep_rule, stop_np = batch_estimation.flavor_config(flavor, **kw)
    jax_cfg = RULES[flavor][0]
    shapes, excused = set(), 0
    for (s, js), g, w in zip(pairs, got, want):
        matrix, ue, bs = registry.build_scene(s, angles, log_t, device="cpu")
        shapes.add(matrix.shape)
        d = make_dictionary(ue, bs, dict_cfg)
        single = run_nn_omp(d, matrix, cfg, keep_rule, stop_np, device="cpu")
        assert_same_paths(g, single, f"{s.name} vs its own run", valid_only=not stop_np)
        ref = jax_nn_omp.nn_omp_np(d, matrix, jax_cfg, keep_rule, stop_np)
        if selection_margin(d, matrix, ref) < NEAR_TIE:
            excused += 1
            continue
        assert_same_paths(g, w, f"{s.name} vs JAX", valid_only=not stop_np)
    assert len(shapes) == 3
    with capsys.disabled():
        print(f"\nestimate_sessions {flavor}: {excused} of 3 sessions excused as near ties")
    assert excused <= 1


def near_threshold(power, valid, thresholds_db):
    """(LoS near a tie, per-path bool: its ratio to the LoS lies within
    MARGIN_DB of a threshold)."""
    power = np.asarray(power, np.float64)
    valid = np.asarray(valid, bool)
    if not valid.any():
        return False, np.zeros(len(power), bool)
    los = int(np.argmax(np.where(valid, power, -np.inf)))
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = 10 * np.log10(power / power[los])
    others = valid.copy()
    others[los] = False
    los_tie = bool((others & (np.abs(ratio) < MARGIN_DB)).any())
    near = np.zeros(len(power), bool)
    for th in thresholds_db:
        near |= valid & (np.abs(ratio - th) < MARGIN_DB)
    return los_tie, near


@pytest.fixture(scope="module")
def estimator_sessions(tmp_path_factory):
    return session_pair(tmp_path_factory.mktemp("est"), "multipath", n_groups=4, seed=6)


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("name", FLAVORS)
def test_run_estimator_matches_jax(estimator_sessions, angles, name, engine, capsys):
    s, js = estimator_sessions
    kw = dict(grid_res=0.5)
    got = registry.run_estimator(name, s, angles, None, engine=engine, device="cpu", **kw)
    want = jax_registry.run_estimator(name, js, angles, None, engine=engine, **kw)
    assert isinstance(got, registry.PathsTable) and len(got) > 0
    if engine == "host":
        assert got.to_string(index=False) == want.to_string(index=False)
        for c in registry.COLUMNS:
            np.testing.assert_array_equal(np.asarray(got[c]), want[c].to_numpy(), err_msg=c)
        assert got.to_dict("records") == want.to_dict("records")
        return

    # The scene bit for bit, then the NN-OMP engines lane against lane.
    flag_log = name == "nn_omp"
    matrix, ue, bs = registry.build_scene(s, angles, flag_log)
    j_matrix, j_ue, j_bs = jax_registry.build_scene(js, angles, flag_log)
    for a, b in ((matrix, j_matrix), (ue, j_ue), (bs, j_bs)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    dict_cfg = JaxDictionaryConfig(grid_res=0.5, beam_width=1.4,
                                   grid_kind="arange" if name == "nn_omp_v1" else "linspace")
    cfg = {"nn_omp": RULES["v1-7"][0], "nn_omp_v1": RULES["v1"][0]}.get(
        name, JaxOmpConfig(max_paths=10, min_power_ratio=0.01))
    keep_rule, stop_np = ("positive", False) if name == "nn_omp_v1" else ("ratio", True)
    d = jax_dictionary.make_dictionary(j_ue, j_bs, dict_cfg)
    j_paths = jax_nn_omp.run_nn_omp(d, j_matrix, cfg, keep_rule, stop_np, engine="device")
    paths = run_nn_omp(d, matrix, port_cfg(cfg), keep_rule, stop_np, device="cpu")
    assert selection_margin(d, matrix, jax_nn_omp.nn_omp_np(
        d, matrix, cfg, keep_rule, stop_np)) >= NEAR_TIE
    assert_same_paths(paths, j_paths, f"{name} paths")
    np.testing.assert_array_equal(paths.aoa, j_paths.aoa)
    np.testing.assert_array_equal(paths.aod, j_paths.aod)

    # Labels: the port's classifier on JAX's own paths gives JAX's labels
    # exactly; end to end, equal outside the thresholds' margin.
    j_cls = CLASSIFY[name](jax_classifiers, j_paths)
    np.testing.assert_array_equal(CLASSIFY[name](classifiers, j_paths).label, j_cls.label)
    los_tie, near = near_threshold(j_paths.power, j_paths.valid, THRESHOLDS_DB[name])
    assert not los_tie
    got_label = CLASSIFY[name](classifiers, paths).label
    far = ~near
    np.testing.assert_array_equal(got_label[far], j_cls.label[far])
    with capsys.disabled():
        print(f"\nrun_estimator {name} device: {int(near.sum())} of "
              f"{int(np.asarray(j_paths.valid).sum())} paths within {MARGIN_DB:.5f} dB of a "
              "threshold")

    # The tables: the same rows, angles exact, power within RTOL, labels
    # outside the margin.
    want_angles = np.stack([want["AoA"].to_numpy(), want["AoD"].to_numpy()], axis=1)
    np.testing.assert_array_equal(np.stack([got["AoA"], got["AoD"]], axis=1), want_angles)
    np.testing.assert_allclose(got["Power"], want["Power"].to_numpy(), rtol=RTOL)
    far_rows = far[np.asarray(j_paths.valid)]
    assert [t for t, f in zip(got["PathType"], far_rows) if f] == [
        t for t, f in zip(want["PathType"], far_rows) if f]


@pytest.mark.parametrize("case", ["empty", "one_row", "exponent", "large", "float32"])
def test_paths_table_prints_pandas_text(case):
    import pandas as pd

    rng = np.random.default_rng(7)
    n = {"empty": 0, "one_row": 1}.get(case, 6)
    cols = {"AoA": rng.uniform(-43.6, 45.0, n), "AoD": rng.uniform(-43.6, 45.0, n),
            "Power": rng.uniform(0.5, 2.0, n), "PathType": list(
                rng.choice(["LoS", "NLoS", "Sidelobe", "Noise"], n))}
    if case == "exponent":
        cols["Power"] = cols["Power"] * np.logspace(-9, 3, n)
    if case == "large":
        cols["Power"] = cols["Power"] * 1e7
    if case == "float32":
        cols = {k: (v.astype(np.float32) if k != "PathType" else v) for k, v in cols.items()}
    table = registry.PathsTable(cols["AoA"], cols["AoD"], cols["Power"], cols["PathType"])
    df = pd.DataFrame(cols)
    assert table.to_string(index=False) == df.to_string(index=False)
    assert table.to_dict("records") == df.to_dict("records")


def test_unported_and_unknown_estimators_raise(estimator_sessions, angles):
    """No name of the JAX registry is left unported: the port has its 13
    names; an unknown name raises ``KeyError``."""
    s, _ = estimator_sessions
    assert not hasattr(registry, "NOT_PORTED")
    assert set(registry.PORTED) == set(jax_registry._REGISTRY) and len(registry.PORTED) == 13
    assert set(FLAVORS) | {"sm_sic"} < set(registry.PORTED)
    with pytest.raises(KeyError, match="unknown estimator"):
        registry.run_estimator("no_such_model", s, angles, device="cpu")
