"""Port NNLS and NN-OMP (slam_process_tpu_torch) == the JAX package's.

* Batched ``nnls_gram`` against ``jax.vmap(nnls_gram)`` on seeded Gram
  systems: K = 3 (closed-form adjugate), K = 5 (Gauss-Jordan), the LU solve
  and a warm start from the previous solution; x within rtol 1e-5, the
  passive sets equal.  Near-collinear systems against scipy's objective.
* ``nn_omp_gram_batch`` against ``nn_omp_gram_batch_jax`` on structured
  scenes (planted Gaussian paths plus noise): aoa_idx, aod_idx, n_iters and
  valid equal, power within rtol 2e-4 / atol 1e-6; and every scene against
  the float64 oracle ``nn_omp_np`` at one grid step (0.11 deg) on angles
  and rtol 5e-2 on power.  A scene whose top two correlation values at some
  iteration sit closer than 1e-5 of the surface's scale (float32 noise
  between two BLAS libraries) is a near tie: it is held against the
  oracle only, and the seeds are chosen so that at most one scene of a
  batch is one.
* The dictionary: ``make_dictionary`` equal to JAX's, and
  ``dictionary_from_reference`` carrying JAX's dictionary across.
* The session estimator's K = 20 refits (its ``nnls_gram`` calls, recorded
  from ``nn_omp_scenes`` at the v1-7 flavor on one and on six planted
  scenes) against JAX's ``nnls_gram`` under vmap.
"""

import functools

import numpy as np
import pytest
import torch

from slam_process_tpu import config as jax_config
from slam_process_tpu.config import DictionaryConfig as JaxDictionaryConfig
from slam_process_tpu.config import OmpConfig as JaxOmpConfig
from slam_process_tpu.models import dictionary as jax_dictionary
from slam_process_tpu_torch.config import DictionaryConfig, OmpConfig
from slam_process_tpu_torch.convert import configs_from_reference, dictionary_from_reference
from slam_process_tpu_torch.models import dictionary
from slam_process_tpu_torch.models.nn_omp import nn_omp_gram_batch
from slam_process_tpu_torch.ops.nnls import nnls_gram

NEAR_TIE = 1e-5


def gram_systems(seed, s, k, m=256):
    rng = np.random.default_rng(seed)
    A = np.abs(rng.normal(size=(s, m, k))) + 0.01
    # Half the planted coefficients negative: NNLS must drop atoms.
    y = np.einsum("smk,sk->sm", A, rng.normal(size=(s, k))) + 0.1 * rng.normal(size=(s, m))
    G = np.einsum("smk,sml->skl", A, A).astype(np.float32)
    b = np.einsum("smk,sm->sk", A, y).astype(np.float32)
    return A, y, G, b


def jax_nnls(G, b, solver="auto", x0=None, P0=None):
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.ops.nnls import nnls_gram as jax_nnls_gram

    fn = jax.jit(jax.vmap(functools.partial(jax_nnls_gram, solver=solver)))
    warm = {} if x0 is None else dict(x0=jnp.asarray(x0), P0=jnp.asarray(P0))
    x, p = fn(jnp.asarray(G), jnp.asarray(b), **warm)
    return np.array(x), np.array(p)


@pytest.mark.parametrize("k,solver", [(3, "auto"), (5, "auto"), (5, "lu")],
                         ids=["K3_adjugate", "K5_gauss_jordan", "K5_lu"])
def test_nnls_gram_batched_matches_jax_vmap(k, solver):
    _, _, G, b = gram_systems(k, 24, k)
    want_x, want_p = jax_nnls(G, b, solver)
    x, p = nnls_gram(torch.from_numpy(G), torch.from_numpy(b), solver=solver)
    assert x.dtype == torch.float32 and p.dtype == torch.bool
    np.testing.assert_array_equal(p.numpy(), want_p)
    np.testing.assert_allclose(x.numpy(), want_x, rtol=1e-5)
    assert p.any() and (~p).any()   # atoms are both kept and dropped


def edge_lanes(k):
    """Two ordinary lanes (cold starts), three all-zero dead lanes (what the
    stream's read-free paths step feeds for its empty sweep lanes) and a
    lane whose first step-back ratio is 0/0: G = I, b = e_1, warm-started
    from P0 = {0} with x0 = 0, so the solve on {0, 1} leaves z_0 = 0 <= TOL
    with x_0 = 0.  That NaN ratio empties the passive set, and the lane
    ends at x = e_1, P = {1}."""
    _, _, G, b = gram_systems(k, 2, k)
    b_nan = np.zeros(k, np.float32)
    b_nan[1] = 1.0
    G = np.concatenate([G, np.zeros((3, k, k), np.float32), np.eye(k, dtype=np.float32)[None]])
    b = np.concatenate([b, np.zeros((3, k), np.float32), b_nan[None]])
    x0 = np.zeros((6, k), np.float32)
    P0 = np.zeros((6, k), bool)
    P0[5, 0] = True
    return G, b, x0, P0


@pytest.mark.parametrize("k,solver", [(3, "auto"), (5, "auto"), (5, "lu"), (2, "auto")],
                         ids=["K3_adjugate", "K5_gauss_jordan", "K5_lu", "K2_lu"])
def test_nnls_gram_dead_and_zero_over_zero_lanes_match_jax(k, solver):
    G, b, x0, P0 = edge_lanes(k)
    want_x, want_p = jax_nnls(G, b, solver, x0=x0, P0=P0)
    x, p = nnls_gram(*(torch.from_numpy(a) for a in (G, b)), solver=solver,
                     x0=torch.from_numpy(x0), P0=torch.from_numpy(P0))
    np.testing.assert_array_equal(p.numpy(), want_p)
    np.testing.assert_allclose(x.numpy(), want_x, rtol=1e-5)
    assert torch.isfinite(x).all()
    assert not p[2:5].any() and not x[2:5].any()             # dead lanes: x = 0
    np.testing.assert_array_equal(x[5].numpy(), np.eye(k, dtype=np.float32)[1])
    np.testing.assert_array_equal(p[5].numpy(), np.arange(k) == 1)


def test_nnls_gram_warm_start_matches_jax():
    """The OMP growth pattern: atoms join one at a time (zero columns for
    future slots) and each refit starts from the previous solution."""
    k, s = 5, 16
    A, y, _, _ = gram_systems(9, s, k)
    x_prev = np.zeros((s, k), np.float32)
    p_prev = np.zeros((s, k), bool)
    for n in range(1, k + 1):
        An = A.copy()
        An[:, :, n:] = 0.0
        G = np.einsum("smk,sml->skl", An, An).astype(np.float32)
        b = np.einsum("smk,sm->sk", An, y).astype(np.float32)
        want_x, want_p = jax_nnls(G, b, x0=x_prev, P0=p_prev)
        x, p = nnls_gram(torch.from_numpy(G), torch.from_numpy(b),
                         x0=torch.from_numpy(x_prev), P0=torch.from_numpy(p_prev))
        np.testing.assert_array_equal(p.numpy(), want_p)
        np.testing.assert_allclose(x.numpy(), want_x, rtol=1e-5)
        x_prev, p_prev = want_x, want_p


@pytest.mark.parametrize("k", [3, 5])
def test_nnls_gram_near_collinear_reaches_scipy_optimum(k):
    from scipy.optimize import nnls as scipy_nnls

    rng = np.random.default_rng(17 + k)
    A, y, _, _ = gram_systems(17 + k, 8, k)
    A[:, :, 1] = A[:, :, 0] * (1 + 1e-6 * rng.normal(size=A.shape[:2]))
    G = np.einsum("smk,sml->skl", A, A).astype(np.float32)
    b = np.einsum("smk,sm->sk", A, y).astype(np.float32)
    x, _ = nnls_gram(torch.from_numpy(G), torch.from_numpy(b))
    for lane in range(len(A)):
        x_ref, _ = scipy_nnls(A[lane], y[lane])
        f_ref = np.linalg.norm(A[lane] @ x_ref - y[lane])
        xl = x[lane].numpy().astype(np.float64)
        assert np.all(xl >= 0)
        assert np.linalg.norm(A[lane] @ xl - y[lane]) <= f_ref * (1 + 1e-5)


def test_nnls_gram_refuses_unbatched_shapes():
    with pytest.raises(ValueError, match="G \\[S, K, K\\]"):
        nnls_gram(torch.zeros(3, 3), torch.zeros(3))


# ---------------------------------------------------------------------------
# NN-OMP on structured scenes
# ---------------------------------------------------------------------------

UE_ANG = np.linspace(-40.0, 40.0, 32)
BS_ANG = np.linspace(-40.0, 40.0, 32)
SCENE_DICT = dict(grid_res=0.1, beam_width=3.0)


def planted_scenes(seed, s):
    """S scenes of 2-3 planted Gaussian paths (as tests/test_nn_omp.py's
    two-path recovery), the first at power 1, plus 1 % noise."""
    rng = np.random.default_rng(seed)
    mats = np.zeros((s, 32, 32))
    for lane in range(s):
        for p in range(int(rng.integers(2, 4))):
            aoa, aod = rng.uniform(-30, 30, 2)
            power = 1.0 if p == 0 else rng.uniform(0.2, 0.7)
            mats[lane] += power * np.outer(jax_dictionary.gaussian_beam(UE_ANG, aoa, 3.0),
                                           jax_dictionary.gaussian_beam(BS_ANG, aod, 3.0))
        mats[lane] += 0.01 * rng.normal(size=(32, 32))
    return mats


def selection_margin(d, mat, ref):
    """Smallest gap, over the oracle's iterations, between the top two
    values of the float64 residual correlation surface, relative to the
    largest |corr_y|."""
    from scipy.optimize import nnls as scipy_nnls

    y = mat.ravel()
    scale = np.abs(d.phi_rx.T @ mat @ d.phi_tx).max()
    resid, selected, margin = y, [], np.inf
    for r, t in zip(ref.aoa_idx[:ref.n_iters], ref.aod_idx[:ref.n_iters]):
        corr = (d.phi_rx.T @ resid.reshape(mat.shape) @ d.phi_tx).ravel()
        top2 = np.partition(corr, -2)[-2:]
        margin = min(margin, (top2[1] - top2[0]) / scale)
        selected.append((r, t))
        A = np.column_stack([np.outer(d.phi_rx[:, a], d.phi_tx[:, b]).ravel()
                             for a, b in selected])
        resid = y - A @ scipy_nnls(A, y)[0]
    return margin


@pytest.mark.parametrize("keep_rule,stop_nonpositive,seed",
                         [("positive", False, 1), ("ratio", True, 2)],
                         ids=["per_sweep_rule", "session_rule"])
def test_nn_omp_gram_batch_matches_jax_and_oracle(keep_rule, stop_nonpositive, seed):
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.models.nn_omp import nn_omp_gram_batch_jax, nn_omp_np
    from slam_process_tpu.utils.precision import jit_highest

    s = 8
    mats = planted_scenes(seed, s)
    d = jax_dictionary.make_dictionary(UE_ANG, BS_ANG, JaxDictionaryConfig(**SCENE_DICT))
    jax_cfg = JaxOmpConfig(max_paths=4, min_power_ratio=0.01)
    cfg = configs_from_reference(jax_config.DecodeConfig(), jax_config.CorrectConfig(),
                                 jax_config.SceneConfig(), omp_cfg=jax_cfg)[4]
    assert cfg == OmpConfig(max_paths=4, min_power_ratio=0.01)
    want = jit_highest(functools.partial(nn_omp_gram_batch_jax, cfg=jax_cfg,
                                         keep_rule=keep_rule,
                                         stop_nonpositive=stop_nonpositive))(
        *(jnp.asarray(x, jnp.float32) for x in (d.phi_rx, d.phi_tx, d.aoa_grid, d.aod_grid,
                                                mats)))
    want = jax.device_get(want)
    dd = dictionary_from_reference(d, device="cpu")
    got = nn_omp_gram_batch(dd.phi_rx, dd.phi_tx, dd.aoa_grid, dd.aod_grid,
                            torch.from_numpy(mats.astype(np.float32)), cfg=cfg,
                            keep_rule=keep_rule, stop_nonpositive=stop_nonpositive)
    for field, dtype in (("aoa_idx", torch.int32), ("n_iters", torch.int32),
                         ("power", torch.float32), ("valid", torch.bool)):
        assert getattr(got, field).dtype == dtype, field

    exact = 0
    for lane in range(s):
        ref = nn_omp_np(d, mats[lane], jax_cfg, keep_rule=keep_rule,
                        stop_nonpositive=stop_nonpositive)
        if selection_margin(d, mats[lane], ref) >= NEAR_TIE:
            exact += 1
            for field in ("aoa_idx", "aod_idx", "n_iters", "valid"):
                np.testing.assert_array_equal(getattr(got, field)[lane].numpy(),
                                              np.asarray(getattr(want, field))[lane],
                                              err_msg=f"lane {lane} {field}")
            np.testing.assert_allclose(got.power[lane].numpy(), np.asarray(want.power)[lane],
                                       rtol=2e-4, atol=1e-6)
        kept = ref.valid
        np.testing.assert_array_equal(got.valid[lane].numpy(), kept)
        np.testing.assert_allclose(got.aoa[lane].numpy()[kept], ref.aoa[kept], atol=0.11)
        np.testing.assert_allclose(got.aod[lane].numpy()[kept], ref.aod[kept], atol=0.11)
        np.testing.assert_allclose(got.power[lane].numpy()[kept], ref.power[kept], rtol=5e-2)
    assert exact >= s - 1


@pytest.mark.parametrize("kind", ["linspace", "arange", "arange_inclusive"])
def test_make_dictionary_matches_jax(kind):
    rng = np.random.default_rng(4)
    ue = np.sort(rng.uniform(-43.6, 45.0, 20)).astype(np.float32)
    bs = np.sort(rng.uniform(-43.6, 45.0, 30)).astype(np.float32)
    want = jax_dictionary.make_dictionary(ue, bs, JaxDictionaryConfig(grid_kind=kind))
    got = dictionary.make_dictionary(ue, bs, DictionaryConfig(grid_kind=kind))
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    moved = dictionary_from_reference(want, device="cpu")
    for g, w in zip(moved, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.float32))
    with pytest.raises(ValueError, match="grid_kind"):
        dictionary.make_dictionary(ue, bs, DictionaryConfig(grid_kind="log"))


@pytest.mark.parametrize("lanes", [1, 6], ids=["run_estimator_1_lane", "vmap_6_lanes"])
def test_estimator_k20_refits_match_jax_vmap(lanes, monkeypatch):
    """The session estimator's own NNLS inputs (what ``chip_smoke.py``
    times K7 on): ``nn_omp_scenes`` at the v1-7 flavor's settings (K = 20,
    "lu"; the chain that ``run_estimator("nn_omp")`` runs on one scene and
    the "vmap" form on several) over planted scenes, its ``nnls_gram``
    calls recorded as ``chip_smoke.k7_calls`` records them (copies of G, b,
    max_outer, solver, x0, P0; one call an NN-OMP iteration).  Each call
    through JAX's ``nnls_gram`` under vmap: passive sets equal, x within
    rtol 1e-5."""
    from slam_process_tpu_torch.models import nn_omp
    from slam_process_tpu_torch.models.batch_estimation import flavor_config

    _, cfg, _, keep, stop = flavor_config("v1-7")
    d = dictionary.make_dictionary(UE_ANG, BS_ANG, DictionaryConfig(grid_res=0.5,
                                                                    beam_width=3.0))
    mats = torch.from_numpy(planted_scenes(60 + lanes, lanes).astype(np.float32))
    phi = [torch.from_numpy(np.asarray(x, np.float32))[None].expand(lanes, *np.shape(x))
           .contiguous() for x in (d.phi_rx, d.phi_tx, d.aoa_grid, d.aod_grid)]
    real, calls = nn_omp.nnls_gram, []

    def record(G, b, max_outer=64, solver="auto", x0=None, P0=None):
        calls.append((G.clone(), b.clone(), max_outer, solver,
                      None if x0 is None else x0.clone(), None if P0 is None else P0.clone()))
        return real(G, b, max_outer, solver, x0, P0)

    monkeypatch.setattr(nn_omp, "nnls_gram", record)
    out = nn_omp.nn_omp_scenes(*phi, mats, cfg, keep, stop)
    assert len(calls) == cfg.max_paths == 20 and int(out.n_iters.max()) > 3
    for G, b, max_outer, solver, x0, P0 in calls:
        assert G.shape == (lanes, 20, 20) and (max_outer, solver) == (64, "lu")
        want_x, want_p = jax_nnls(G.numpy(), b.numpy(), solver, x0=x0.numpy(), P0=P0.numpy())
        x, p = real(G, b, max_outer, solver, x0, P0)
        np.testing.assert_array_equal(p.numpy(), want_p)
        np.testing.assert_allclose(x.numpy(), want_x, rtol=1e-5)
