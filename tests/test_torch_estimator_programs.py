"""The estimator programs (``utils/graphs.GraphProgram`` and the LASSO's
``LassoProgram``) on the CPU, against the JAX package's jitted programs.

On a CUDA device each program is a CUDA graph per shape; on the CPU it runs
its eager body, the code the graph captures.  So here:

  * every program factory is cached per key (a second call with the same key
    returns the same program, another key another), holds at most the JAX
    cache's size of graphs (``max_graphs``: 32 for NN-OMP's session program,
    16 for the batched and per-sweep programs, 8 for omp_dense, and 8 where
    JAX builds a fresh jitted function per call), and ``clear_programs``
    empties every factory; None, "cuda" and "cuda:0" key one program on
    card 0;
  * each program equals the JAX package's jitted counterpart on the same
    seeded numpy inputs, under the existing contracts: NN-OMP indices,
    ``n_iters`` and ``valid`` equal, power within rtol 2e-4 (a scene at a
    near tie of the float64 oracle excused, ``tests/test_torch_nn_omp.py``);
    SM-SIC peaks equal, metric within rtol 1e-6, up to the first step whose
    float32 mask JAX draws differently (``tests/test_torch_sm_sic.py``);
    tracks equal; omp_dense and fusion's NLoS stage within their family
    tests' bounds, the peak mask equal to JAX's host mask; the LASSO as
    ``tests/test_torch_lasso.py`` bounds it;
  * each body runs with host reads raising (``host_reads_raise``: every
    ``.item()``, ``.cpu()``, ``bool()`` ... of a tensor raises, except in the
    kernels' plain versions), the CPU-side proof that it can be captured;
  * svd stays eager on the card (``torch.linalg.svd`` reads its error info
    on the host, ``ROADMAP.md``): its body is pinned to the float64 oracle;
  * ``sweep_paths_dataset`` pads each session's sweeps to JAX's
    ``_sweep_bucket`` and each session's result stays exactly its own
    ``sweep_paths``;
  * the LASSO's one-sweep step run ``N_SWEEPS`` times on the set-up's terms
    is bit-equal to ``lasso_positive_torch``.
"""

import inspect

import numpy as np
import pytest
import torch

import slam_process_tpu.models  # noqa: F401  (the JAX package loads its registry first)
from slam_process_tpu.config import OmpConfig as JaxOmpConfig
from slam_process_tpu.models import batch_estimation as jax_batch
from slam_process_tpu.models import nn_omp as jax_nn_omp
from slam_process_tpu_torch.config import OmpConfig, SmSicConfig
from slam_process_tpu_torch.models import (
    batch_estimation, fusion, lasso_refine, nn_omp, omp_dense, peak_picking, sm_sic, svd_est,
    sweep_estimation, tracking)
from slam_process_tpu_torch.ops import lasso
from slam_process_tpu_torch.pipeline import session as session_mod
from slam_process_tpu_torch.utils.graphs import clear_programs
from slam_process_tpu_torch.utils.synthetic import (
    synthetic_session_bytes, to_hex_text, write_angle_table)
from test_torch_compiled_rounds import host_reads_raise
from test_torch_estimate import (
    RULES, SHAPES, assert_same_paths, lane, port_cfg, synthetic_scenes)
from test_torch_nn_omp import NEAR_TIE, selection_margin

CPU = torch.device("cpu")
SWEEP_NN = ("nn_omp", OmpConfig(max_paths=3), "positive", False)
SWEEP_SM = ("sm_sic", SmSicConfig(), None, None)

# factory, two keys, the JAX cache's size.
FACTORIES = {
    "nn_omp": (nn_omp.nn_omp_program, (OmpConfig(max_paths=20, min_power_ratio=3e-4),),
               (OmpConfig(max_paths=3), "positive", False), 32),
    "batched": (batch_estimation.batched_program, (OmpConfig(), "ratio", True, "vmap"),
                (OmpConfig(), "ratio", True, "gram"), 16),
    "sweep": (sweep_estimation.sweep_program, (SWEEP_NN,), (SWEEP_SM,), 16),
    "sm_sic": (sm_sic.sm_sic_program, (SmSicConfig(),), (SmSicConfig(max_paths=2),), 8),
    "tracker": (tracking.track_program, (8, 10.0), (4, 10.0), 8),
    "lasso": (lasso_refine.lasso_program, (10.0, 0.1), (10.0, 0.2), 8),
    "omp_dense": (omp_dense.omp_dense_program, (1.4, 5), (1.4, 3), 8),
    "fusion": (fusion.fusion_program, (True,), (False,), 8),
    "peaks": (peak_picking.peak_program, (90.0,), (80.0,), 8),
}


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_programs_are_cached_per_key_with_bounded_graphs(name):
    factory, key_a, key_b, size = FACTORIES[name]
    a = factory(*key_a, device="cpu")
    assert factory(*key_a, device="cpu") is a
    assert factory(*key_b, device="cpu") is not a
    assert factory.cache_info().maxsize == size and a.max_graphs == size
    assert a.device == CPU and not a.graphs          # the CPU runs the body: no graph
    clear_programs()
    assert factory(*key_a, device="cpu") is not a


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_programs_are_cached_per_card(name, monkeypatch):
    """None, "cuda", "cuda:0" and ``torch.device("cuda", 0)``, by keyword or
    by position, name one card and so one program: a card holds one
    program (and one set of graphs) per key.  Making a program touches no
    device, so the CPU can stand in for card 0."""
    factory, key_a, _, _ = FACTORIES[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    clear_programs()
    a = factory(*key_a, device=None)
    params = list(inspect.signature(factory).parameters.values())
    positional = [*key_a, *(p.default for p in params[len(key_a):-1])]
    for device in ("cuda", "cuda:0", torch.device("cuda", 0)):
        assert factory(*key_a, device=device) is a
        assert factory(*positional, device) is a
    assert a.device == torch.device("cuda", 0)
    assert factory.cache_info().currsize == 1
    clear_programs()


def excused_lanes(mats, dicts, cfg, keep_rule, stop_np):
    """The scenes whose float64 oracle has a near tie at some iteration."""
    return {i for i, (m, d) in enumerate(zip(mats, dicts))
            if selection_margin(d, m, jax_nn_omp.nn_omp_np(d, m, cfg, keep_rule, stop_np))
            < NEAR_TIE}


@pytest.mark.parametrize("flavor", ["v1-7", "v1"])
def test_nn_omp_program_matches_jitted_nn_omp(flavor):
    """``run_nn_omp(engine="device")`` (the session program, N = 1) against
    JAX's ``run_nn_omp(engine="device")`` (``_jitted_nn_omp``) per scene; the
    program's body reads nothing from the host."""
    cfg, keep_rule, stop_np = RULES[flavor]
    kind = "linspace" if flavor == "v1-7" else "arange"
    mats, dicts = synthetic_scenes(5, SHAPES, kind=kind)
    excused = excused_lanes(mats, dicts, cfg, keep_rule, stop_np)
    assert len(excused) <= 1
    fn = nn_omp.nn_omp_program(port_cfg(cfg), keep_rule, stop_np, "cpu")
    for i, (m, d) in enumerate(zip(mats, dicts)):
        got = nn_omp.run_nn_omp(d, m, port_cfg(cfg), keep_rule, stop_np, device="cpu")
        inputs = [np.asarray(x, np.float32)[None]
                  for x in (d.phi_rx, d.phi_tx, d.aoa_grid, d.aod_grid, m)]
        with host_reads_raise():
            body = fn(*inputs)
        for g, b in zip(got, body):
            np.testing.assert_array_equal(g, b[0].numpy())
        if i in excused:
            continue
        want = jax_nn_omp.run_nn_omp(d, m, cfg, keep_rule, stop_np, engine="device")
        assert_same_paths(got, want, f"scene {i}")


@pytest.mark.parametrize("form", ["vmap", "gram"])
def test_batched_programs_match_jax(form):
    """``_batched_nn_omp`` (``batched_program``) against JAX's
    ``_batched_nn_omp_fn`` of the same form on the same packed scenes, and
    ``nn_omp_sessions_device`` (the session program once per session)
    against JAX's; the bodies read nothing from the host."""
    import jax
    import jax.numpy as jnp

    cfg, keep_rule, stop_np = RULES["v1-7"]
    mats, dicts = synthetic_scenes(6, SHAPES)
    packed = jax_batch.pack_scenes(mats, dicts)
    port = batch_estimation.PackedScenes(*packed)
    with host_reads_raise():
        got = batch_estimation._batched_nn_omp(port, port_cfg(cfg), keep_rule, stop_np, form,
                                               device="cpu")
        per_session = batch_estimation.nn_omp_sessions_device(port, port_cfg(cfg), keep_rule,
                                                              stop_np, device="cpu")
    with jax.default_matmul_precision("highest"):
        want = jax.device_get(jax_batch._batched_nn_omp_fn(cfg, keep_rule, stop_np, form)(
            *(jnp.asarray(x) for x in packed[:5])))
    want_each = jax.device_get(jax_batch.nn_omp_sessions_device(packed, cfg, keep_rule,
                                                                stop_np))
    got = type(got)(*(x.numpy() for x in got))
    excused = excused_lanes(mats, dicts, cfg, keep_rule, stop_np)
    assert len(excused) <= 1 and len(per_session) == len(mats)
    for i in range(len(mats)):
        if i in excused:
            continue
        assert_same_paths(lane(got, i), lane(want, i), f"{form} scene {i}")
        one = type(got)(*(x.numpy() for x in per_session[i]))
        assert_same_paths(one, want_each[i], f"per-session scene {i}")


def sweep_inputs(seed, n_sweeps, est_key):
    """Per-sweep mats [S, U, B] (NaN cells, one all-NaN sweep) and the
    estimator's dictionary over random beams, as the per-sweep path passes
    them."""
    rng = np.random.default_rng(seed)
    ue = np.sort(rng.uniform(-30, 30, 10))
    bs = np.sort(rng.uniform(-25, 25, 12))
    d, _ = sweep_estimation.sweep_estimator_setup(est_key[0], ue, bs, grid_res=1.0)
    mats = np.zeros((n_sweeps, len(ue), len(bs)))
    for s in range(n_sweeps):
        for _ in range(3):
            mats[s] += rng.uniform(1.0, 5.0) * np.outer(
                d.phi_rx[:, rng.integers(len(d.aoa_grid))],
                d.phi_tx[:, rng.integers(len(d.aod_grid))])
    mats += rng.random(mats.shape) * 0.05
    mats[rng.random(mats.shape) < 0.2] = np.nan
    mats[-1] = np.nan
    return mats.astype(np.float32), sweep_estimation.estimator_dictionary(est_key, d)


@pytest.mark.parametrize("est_key", [SWEEP_NN, SWEEP_SM], ids=["nn_omp", "sm_sic"])
def test_sweep_programs_match_jax(est_key):
    """``sweep_program`` against JAX's ``_sweep_estimator_fn(est_key, None)``
    on the same sweeps (JAX's float32 dictionary); the body reads nothing
    from the host."""
    from slam_process_tpu.config import SmSicConfig as JaxSmSicConfig
    from slam_process_tpu.pipeline.session import _sweep_estimator_fn
    from test_torch_sm_sic import assert_peaks_equal, float32_masks_agree

    mats, d = sweep_inputs(7, 9, est_key)
    args = (mats, d.phi_rx, d.phi_tx, d.aoa_grid, d.aod_grid)
    with host_reads_raise():
        out, valid = sweep_estimation.sweep_program(est_key, "cpu")(*args)
    jax_key = ((est_key[0], JaxOmpConfig(max_paths=3), *est_key[2:]) if est_key[0] == "nn_omp"
               else (est_key[0], JaxSmSicConfig(), None, None))
    import jax
    import jax.numpy as jnp

    with jax.default_matmul_precision("highest"):
        want, want_valid = jax.device_get(_sweep_estimator_fn(jax_key, None)(
            *(jnp.asarray(np.asarray(x, np.float32)) for x in args)))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    assert valid[:-1].all() and not valid[-1]
    compared = 0
    for s in range(len(mats) - 1):
        got = type(out)(*(x[s].numpy() for x in out))
        ref = type(want)(*(np.asarray(x)[s] for x in want))
        if est_key[0] == "nn_omp":
            np.testing.assert_array_equal(got.valid, ref.valid)
            np.testing.assert_array_equal(got.aoa_idx[got.valid], ref.aoa_idx[ref.valid])
            np.testing.assert_array_equal(got.aod_idx[got.valid], ref.aod_idx[ref.valid])
            np.testing.assert_allclose(got.power[got.valid], ref.power[ref.valid], rtol=2e-4,
                                       atol=1e-6)
            compared += int(got.valid.sum())
        else:
            n = float32_masks_agree(d, got)
            assert_peaks_equal(got, ref, slots=n)
            compared += n
    assert compared >= 8


def test_sm_sic_program_matches_run_sm_sic_oracle_and_jax():
    """``run_sm_sic`` (``sm_sic_program``, read back once) against the oracle
    and JAX's ``sm_sic_jax`` on the same float32 operands."""
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.config import SmSicConfig as JaxSmSicConfig
    from slam_process_tpu.models.sm_sic import sm_sic_jax
    from test_torch_sm_sic import (
        CFG, NEAR_TIE as SM_NEAR_TIE, assert_peaks_equal, dictionary, float32_masks_agree,
        margins, planted_scene)

    d = dictionary()
    compared = 0
    for seed in (3, 4):
        m = planted_scene(seed)
        assert margins(d, m) > SM_NEAR_TIE
        got = sm_sic.run_sm_sic(d, m, CFG, device="cpu")
        with host_reads_raise():
            body = sm_sic.sm_sic_program(CFG, "cpu")(
                *(np.asarray(x, t) for x, t in ((d.phi_rx, np.float32), (d.phi_tx, np.float32),
                                                (d.aoa_grid, np.float64),
                                                (d.aod_grid, np.float64), (m, np.float32))))
        for g, b in zip(got, body):
            np.testing.assert_array_equal(g, b.numpy())
        assert_peaks_equal(got, sm_sic.sm_sic_np(d, m, CFG))
        with jax.default_matmul_precision("highest"):
            want = jax.device_get(jax.jit(lambda *a: sm_sic_jax(*a, cfg=JaxSmSicConfig()))(
                *(jnp.asarray(np.asarray(x, np.float32)) for x in (d.phi_rx, d.phi_tx,
                                                                   d.aoa_grid, d.aod_grid, m))))
        n = float32_masks_agree(d, got)
        assert_peaks_equal(got, type(got)(*(np.asarray(x) for x in want)), slots=n)
        compared += n
    assert compared >= 2


@pytest.mark.parametrize("s_n,t_n", [(25, 8), (9, 3)])
def test_track_program_matches_jitted_track_paths(s_n, t_n, monkeypatch):
    """``track_program`` (``path_tracks(engine="device")``) against JAX's
    jitted ``track_paths_jax``; the body reads the host only inside K6's
    plain version (the single tracker's, here)."""
    import jax

    import test_torch_compiled_rounds
    from slam_process_tpu.models.tracking import track_paths_jax
    from slam_process_tpu_torch.ops import tracker
    from test_torch_tracker import random_case

    monkeypatch.setattr(test_torch_compiled_rounds, "KERNEL_PLAIN",
                        test_torch_compiled_rounds.KERNEL_PLAIN + ((tracker, "track_block_plain"),))

    rng = np.random.default_rng(s_n)
    aoa, aod, pw, val = random_case(rng, s_n, 3)
    fn = tracking.track_program(t_n, 12.0, "cpu")
    got = fn.host(aoa, aod, pw, val)
    with host_reads_raise():
        body = fn(aoa, aod, pw, val)
    want = jax.device_get(jax.jit(lambda *a: track_paths_jax(*a, max_tracks=t_n,
                                                             gate_deg=12.0))(aoa, aod, pw, val))
    for name in ("pos_aoa", "pos_aod", "power", "observed", "created", "n_tracks"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))
        np.testing.assert_array_equal(getattr(body, name).numpy(), getattr(got, name))
    assert int(got.n_tracks) > 0


def lasso_case(seed, p=5, m=80):
    rng = np.random.default_rng(seed)
    meas = [rng.uniform(-30, 30, m), rng.uniform(-30, 30, m), rng.uniform(10, 100, m)]
    cent = [rng.uniform(-30, 30, (p, 49)), rng.uniform(-30, 30, (p, 49)),
            (rng.random((p, 49)) > 0.2).astype(np.float64)]
    return [torch.from_numpy(x) for x in meas + cent]


def test_lasso_sweeps_bit_equal_to_lasso_positive_torch():
    """``patch_setup`` then ``lasso_sweep_`` ``N_SWEEPS`` times, as the program's
    two graphs run them, against ``lasso_positive_torch`` on the unit-norm
    design (today's arithmetic) bit for bit; the program's CPU call is that
    body; neither reads the host."""
    inputs = lasso_case(1)
    with host_reads_raise():
        *gram, norms = lasso_refine.patch_setup(*inputs, 10.0)
        w = torch.zeros_like(gram[1])
        for _ in range(lasso_refine.N_SWEEPS):
            lasso.lasso_sweep_(w, *gram, 0.1)
        got = lasso_refine.lasso_program(10.0, 0.1, device="cpu")(*inputs)
    assert torch.equal(got, w / norms)
    meas_aoa, meas_aod, meas_rss, aoa_c, aod_c, ok = inputs
    sigma = 10.0 / 2.355
    da = (meas_aoa[None, :, None] - aoa_c[:, None, :]) / sigma
    dd = (meas_aod[None, :, None] - aod_c[:, None, :]) / sigma
    G = torch.exp(-0.5 * (da * da + dd * dd)) * ok[:, None, :]
    n = torch.linalg.vector_norm(G, dim=1) + 1e-8
    want = lasso.lasso_positive_torch(G / n[:, None, :],
                                      meas_rss[None, :].expand(G.shape[0], -1), 0.1) / n
    assert torch.equal(got, want)
    assert (got > 0).any() and (got[ok == 0] == 0).all()


def near_zero_column_case():
    """Samples in [-10, 10] deg and two 7 x 7 patches: one among them, one
    centred 26 deg off on both axes, where a column's raw norm falls to
    ~1e-6-1e-8 (a Gaussian ~5 sigma from its nearest sample), so the
    unit-norm rescale divides a coefficient by ~1e-6."""
    rng = np.random.default_rng(7)
    m = 60
    meas = [rng.uniform(-10, 10, m), rng.uniform(-10, 10, m), rng.uniform(20, 80, m)]
    c = np.arange(-3, 4, dtype=np.float64)
    aoa_c = np.stack([np.tile(c, 7), np.tile(c, 7) + 26.0])
    aod_c = np.stack([np.repeat(c, 7), np.repeat(c, 7) + 26.0])
    return [torch.from_numpy(x) for x in meas + [aoa_c, aod_c, np.ones((2, 49))]]


def test_lasso_program_on_near_zero_columns_matches_the_float64_oracle():
    """A patch far from every sample: coefficients of ~1e6-1e7 on columns
    of raw norm ~1e-6 are the method's (the host oracle, 200 sweeps of
    ``lasso_positive_np`` without its early stop, gives them within rtol
    1e-9), and no rounding artefact: the samples in another order (the
    same problem, other roundings) give them within rtol 1e-9."""
    from slam_process_tpu_torch.ops.lasso import lasso_positive_np

    inputs = near_zero_column_case()
    got = lasso_refine.lasso_program(10.0, 0.1, device="cpu")(*inputs).numpy()
    meas_aoa, meas_aod, meas_rss, aoa_c, aod_c, _ = (x.numpy() for x in inputs)
    sigma = 10.0 / 2.355
    want = np.zeros_like(got)
    norms = np.zeros_like(got)
    for p in range(got.shape[0]):
        G = np.exp(-0.5 * (((meas_aoa[:, None] - aoa_c[p][None, :]) / sigma) ** 2
                           + ((meas_aod[:, None] - aod_c[p][None, :]) / sigma) ** 2))
        norms[p] = np.linalg.norm(G, axis=0) + 1e-8
        want[p] = lasso_positive_np(G / norms[p], meas_rss, 0.1, n_sweeps=lasso_refine.N_SWEEPS,
                                    tol=0.0) / norms[p]
    assert ((norms < 1e-5) & (got > 1e6)).any()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    perm = torch.from_numpy(np.random.default_rng(8).permutation(len(meas_aoa)))
    shuffled = [x[perm] if i < 3 else x for i, x in enumerate(inputs)]
    np.testing.assert_allclose(lasso_refine.patch_lasso_torch(*shuffled).numpy(), got,
                               rtol=1e-9, atol=1e-9)


def test_lasso_program_matches_jax_device_map():
    """The device engine through the program against JAX's float32 device
    map within ``tests/test_torch_lasso.py``'s bound (2e-3 of the scale)."""
    from slam_process_tpu.models import lasso_refine as jax_lr
    from test_torch_lasso import lattice, scale_close

    aoa, aod, rss = lattice(43, ())
    aoa_grid, aod_grid, heat = lasso_refine.make_heatmap_interpolated(aoa, aod, rss, grid_res=2.0)
    peaks = lasso_refine.peak_regions_np(heat, 65.0)
    got = lasso_refine.refine_patches_device(aoa, aod, rss, aoa_grid, aod_grid, heat.shape,
                                             peaks, device="cpu")
    scale_close(got, jax_lr.refine_patches_device(aoa, aod, rss, aoa_grid, aod_grid,
                                                  heat.shape, peaks), 2e-3)


def test_omp_dense_program_matches_jax():
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.models import omp_dense as jax_od
    from test_torch_omp_dense import AOA_GRID, AOD_GRID, dense_scene

    meas_aoa, meas_aod, y = dense_scene(1, np.random.default_rng(12))
    got = omp_dense.run_omp_dense(meas_aoa, meas_aod, y, AOA_GRID, AOD_GRID, device="cpu")
    with host_reads_raise():
        body = omp_dense.omp_dense_program(1.4, 5, "cpu")(
            *(np.asarray(x, np.float64) for x in (meas_aoa, meas_aod, y, AOA_GRID, AOD_GRID)))
    for g, b in zip(got, body):
        np.testing.assert_array_equal(g, b.numpy())
    ref = omp_dense.omp_dense_np(meas_aoa, meas_aod, y, AOA_GRID, AOD_GRID)
    np.testing.assert_array_equal(got.aoa, ref.aoa)
    np.testing.assert_array_equal(got.aod, ref.aod)
    np.testing.assert_allclose(got.power, ref.power, rtol=1e-6, atol=0)
    rx, tx = (jax_od.gaussian_beam(jnp.asarray(m, jnp.float32)[:, None],
                                   jnp.asarray(g, jnp.float32)[None, :], 1.4)
              for m, g in ((meas_aoa, AOA_GRID), (meas_aod, AOD_GRID)))
    j = jax.device_get(jax_od._jitted_omp_dense(5)(
        rx, tx, jnp.asarray(y, jnp.float32), jnp.asarray(AOA_GRID, jnp.float32),
        jnp.asarray(AOD_GRID, jnp.float32)))
    np.testing.assert_allclose(np.asarray(j.aoa), got.aoa, atol=1e-5)
    np.testing.assert_allclose(np.asarray(j.aod), got.aod, atol=1e-5)
    np.testing.assert_allclose(np.asarray(j.power), got.power, rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("seed", [1, 2])
def test_fusion_program_matches_jax_and_oracle(seed):
    """One graph for every LoS: the program's LoS angles are inputs."""
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.models import fusion as jax_fusion
    from test_torch_fusion import scene, seeds_of

    d, mat = scene(seed)
    (los_aoa, los_aod), _ = seeds_of(d, mat)
    for aoa_0, aod_0 in ((los_aoa, los_aod), (los_aoa + 7.5, los_aod - 4.0)):
        args = [np.asarray(x, np.float64) for x in (d.phi_rx, d.phi_tx, d.aoa_grid, d.aod_grid,
                                                    mat, aoa_0, aod_0)]
        with host_reads_raise():
            a, dd, m, v = fusion.fusion_program(True, device="cpu")(*args)
        a, dd, m, v = (x.numpy() for x in (a, dd, m, v))
        ref = fusion.fusion_nlos_np(d, mat, aoa_0, aod_0)
        assert v.sum() == len(ref)
        np.testing.assert_array_equal(a[v], ref["aoa"])
        np.testing.assert_array_equal(dd[v], ref["aod"])
        np.testing.assert_allclose(m[v], ref["metric"], rtol=1e-9, atol=0)
        ja, jd, jm, jv = jax.device_get(jax.jit(jax_fusion.fusion_nlos_jax)(
            *(jnp.asarray(x, jnp.float32) for x in args[:5]), jnp.float32(aoa_0),
            jnp.float32(aod_0), jnp.bool_(True)))
        np.testing.assert_array_equal(np.asarray(jv), v)
        np.testing.assert_allclose(np.asarray(ja)[v], a[v], atol=0.51)
        np.testing.assert_allclose(np.asarray(jd)[v], dd[v], atol=0.51)
        np.testing.assert_allclose(np.asarray(jm)[v], m[v], rtol=1e-3)


def test_peak_program_matches_jax_host_mask():
    """The mask against JAX's peak picking on the host (its numpy local-max
    filter over the float64 grid, above ``np.percentile``), which its
    float64 device engine equals (``tests/test_torch_peaks.py``)."""
    from slam_process_tpu.ops.peaks import local_max_mask as jax_local_max_mask
    from test_torch_peaks import samples

    aoa, aod, rss = samples(6)
    _, _, heat = peak_picking.build_heatmap_grid(aoa, aod, rss)
    with host_reads_raise():
        body = peak_picking.peak_program(90.0, "cpu")(heat)
    got = peak_picking.peak_program(90.0, "cpu").host(heat)
    np.testing.assert_array_equal(body.numpy(), got)
    want = jax_local_max_mask(heat, 3) & (heat > np.percentile(heat, 90.0))
    np.testing.assert_array_equal(got, want)
    assert got.sum() >= 2


def test_svd_body_stays_eager_and_matches_the_oracle():
    """svd is the one family body left eager on the card (``torch.linalg.svd``
    reads its error info on the host); its float64 body equals the oracle."""
    rng = np.random.default_rng(3)
    heat = rng.random((30, 50)) * 10
    grid_ue, grid_bs = np.linspace(-40, 40, 30), np.linspace(-50, 50, 50)
    assert not hasattr(svd_est, "svd_program")
    got = svd_est.svd_paths_torch(*(torch.from_numpy(x) for x in (heat, grid_ue, grid_bs)))
    want = svd_est.svd_paths(heat, grid_ue, grid_bs)
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    v = want.valid
    np.testing.assert_array_equal(got.aoa.numpy()[v], want.aoa[v])
    np.testing.assert_array_equal(got.aod.numpy()[v], want.aod[v])
    np.testing.assert_allclose(got.power.numpy(), want.power, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.singular.numpy(), want.singular, rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def bucket_files(tmp_path_factory):
    """Three sessions of 3, 11 and 13 sweeps: buckets 8, 16 and 16."""
    tmp = tmp_path_factory.mktemp("buckets")
    logs = []
    for i, g in enumerate((3, 11, 13)):
        path = tmp / f"Serial Debug 2026-10-18 1{i}0000.txt"
        path.write_bytes(to_hex_text(synthetic_session_bytes(
            n_groups=g, frames_per_beam=1, baselines_per_group=4, seed=70 + i, n_paths=3),
            "shipped"))
        logs.append(path)
    return logs, write_angle_table(tmp / "beam_angle.xlsx")


def test_sweep_paths_dataset_pads_sweeps_to_jax_buckets(bucket_files, monkeypatch):
    from slam_process_tpu.pipeline.session import _sweep_bucket
    from test_torch_sweep_paths_dataset import assert_same

    logs, angles = bucket_files
    sessions = [session_mod.Session.from_log(p, device="cpu") for p in logs]
    for n in (1, 7, 8, 9, 16, 17, 58):
        assert session_mod.sweep_bucket(n) == _sweep_bucket(n)
    shapes = []
    real = session_mod.sweep_program

    def recorded(est_key, device=None):
        fn = real(est_key, device)

        def call(mats, *rest):
            shapes.append(tuple(mats.shape))
            return fn(mats, *rest)
        return call
    monkeypatch.setattr(session_mod, "sweep_program", recorded)
    got = session_mod.sweep_paths_dataset(sessions, angles, device="cpu")
    counts = [len(v) for _, v in got]
    assert counts == [3, 11, 13]
    assert [s[0] for s in shapes] == [_sweep_bucket(n) for n in counts] == [8, 16, 16]
    assert len(set(shapes)) == 2                   # the 11- and 13-sweep sessions share one
    monkeypatch.setattr(session_mod, "sweep_program", real)
    for s, res in zip(sessions, got):
        assert_same(res, s.sweep_paths(angles, device="cpu"))
