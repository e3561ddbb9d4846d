"""The session estimator's comparator forms (slam_process_tpu_torch) == the
JAX package's.

* ``nn_omp_batch`` (S scenes sharing one dictionary, the chain form with
  whole-batch products) against ``nn_omp_batch_jax`` (jitted with HIGHEST
  matmuls, as it runs) on seeded scenes of planted atoms at a ~20 x 20
  grid, under both stop rules and keep rules, and against the port's
  ``nn_omp_gram_batch`` on the same inputs.
* ``_batched_nn_omp(form="gram")`` (``nn_omp_gram_batch`` with one
  dictionary per packed session) against the JAX package's
  ``_batched_nn_omp_fn(form="gram")`` and against the port's ``"vmap"``
  form on the same packed scenes.
* ``nn_omp_sessions_device(device="cpu")`` against the JAX package's
  ``nn_omp_sessions_device`` and the float64 oracle ``nn_omp_np`` on the
  padded scenes of very different sizes that
  ``tests/test_batch_estimation.py::test_batched_matches_host_oracle_synthetic``
  builds (made here from the same seed).

The tolerance throughout: ``aoa_idx``, ``aod_idx``, ``n_iters`` and
``valid`` equal, power within rtol 2e-4 (atol 1e-6).  A scene whose top two
oracle correlations at some iteration sit within ``NEAR_TIE`` of the
surface's scale is excused from the index comparison against a form of
other arithmetic (``tests/test_torch_nn_omp.py``); the tests count it.
"""

import functools

import numpy as np
import pytest
import torch

from slam_process_tpu.config import DictionaryConfig as JaxDictionaryConfig
from slam_process_tpu.config import OmpConfig as JaxOmpConfig
from slam_process_tpu.models import batch_estimation as jax_batch
from slam_process_tpu.models import dictionary as jax_dictionary
from slam_process_tpu.models import nn_omp as jax_nn_omp
from slam_process_tpu_torch.convert import dictionary_from_reference, packed_scenes_from_reference
from slam_process_tpu_torch.models import batch_estimation
from slam_process_tpu_torch.models.nn_omp import nn_omp_batch, nn_omp_gram_batch, nn_omp_scenes
from test_torch_estimate import RULES, SHAPES, assert_same_paths, lane, port_cfg, synthetic_scenes
from test_torch_nn_omp import NEAR_TIE, selection_margin

UE = np.linspace(-20.0, 20.0, 12)
BS = np.linspace(-18.0, 22.0, 14)
GRID = dict(grid_res=2.0, beam_width=3.0)      # 21 x 21 atoms


def shared_scenes(seed, s, offset=0.0):
    """S scenes over one dictionary: three planted atoms of random power
    plus 1 % noise, minus ``offset``; with an offset the last scene is
    negative everywhere, so every correlation is negative and the two stop
    rules part (v1-7 stops at once, v1 selects one atom that refits to 0)."""
    rng = np.random.default_rng(seed)
    d = jax_dictionary.make_dictionary(UE, BS, JaxDictionaryConfig(**GRID))
    mats = np.zeros((s, len(UE), len(BS)))
    for i in range(s):
        for _ in range(3):
            mats[i] += rng.uniform(0.3, 1.5) * np.outer(
                d.phi_rx[:, rng.integers(len(d.aoa_grid))],
                d.phi_tx[:, rng.integers(len(d.aod_grid))])
        mats[i] += 0.01 * rng.normal(size=mats[i].shape) - offset
    if offset:
        mats[-1] = -np.abs(mats[-1])
    return d, mats


def as_numpy(paths):
    return type(paths)(*(np.asarray(x) for x in paths))


@pytest.mark.parametrize("keep_rule,stop_nonpositive,offset",
                         [("ratio", True, 0.0), ("ratio", True, 0.05),
                          ("positive", False, 0.0), ("positive", False, 0.05)],
                         ids=["ratio_stop", "ratio_stop_negative_cells", "positive_no_stop",
                              "positive_no_stop_negative_cells"])
def test_nn_omp_batch_matches_jax_and_gram(keep_rule, stop_nonpositive, offset, capsys):
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.utils.precision import jit_highest

    s = 6
    d, mats = shared_scenes(3, s, offset)
    jax_cfg = JaxOmpConfig(max_paths=5, min_power_ratio=0.01)
    want = jax.device_get(jit_highest(functools.partial(
        jax_nn_omp.nn_omp_batch_jax, cfg=jax_cfg, keep_rule=keep_rule,
        stop_nonpositive=stop_nonpositive))(
        *(jnp.asarray(x, jnp.float32) for x in (d.phi_rx, d.phi_tx, d.aoa_grid, d.aod_grid,
                                                mats))))
    dd = dictionary_from_reference(d, device="cpu")
    args = (dd.phi_rx, dd.phi_tx, dd.aoa_grid, dd.aod_grid,
            torch.from_numpy(mats.astype(np.float32)), port_cfg(jax_cfg), keep_rule,
            stop_nonpositive)
    got = nn_omp_batch(*args)
    for field, dtype in (("aoa_idx", torch.int32), ("n_iters", torch.int32),
                         ("power", torch.float32), ("valid", torch.bool)):
        assert getattr(got, field).dtype == dtype, field
    assert got.power.shape == (s, 5) and got.n_iters.shape == (s,)
    got, gram = as_numpy(got), as_numpy(nn_omp_gram_batch(*args))
    if offset:
        assert int(got.n_iters[-1]) == (0 if stop_nonpositive else 1)
        assert not got.valid[-1].any()
    excused = 0
    for i in range(s):
        # The same arithmetic as nn_omp_scenes on the scene alone: equal.
        one = nn_omp_scenes(dd.phi_rx[None], dd.phi_tx[None], dd.aoa_grid[None],
                            dd.aod_grid[None], args[4][i:i + 1], *args[5:])
        for g, w in zip(lane(got, i), as_numpy(one)):
            np.testing.assert_array_equal(g, w[0])
        ref = jax_nn_omp.nn_omp_np(d, mats[i], jax_cfg, keep_rule, stop_nonpositive)
        if selection_margin(d, mats[i], ref) < NEAR_TIE:
            excused += 1
            continue
        assert_same_paths(lane(got, i), lane(want, i), f"scene {i} vs JAX")
        assert_same_paths(lane(gram, i), lane(got, i), f"scene {i} gram vs chain")
        np.testing.assert_array_equal(lane(got, i).aoa, np.asarray(want.aoa)[i])
    with capsys.disabled():
        print(f"\nnn_omp_batch {keep_rule}: {excused} of {s} scenes excused as near ties")
    assert excused <= 1


def jax_forms(packed, cfg, keep_rule, stop_np):
    import jax
    import jax.numpy as jnp

    args = [jnp.asarray(x) for x in packed[:5]]
    return {form: jax.device_get(jax_batch._batched_nn_omp_fn(cfg, keep_rule, stop_np,
                                                              form=form)(*args))
            for form in ("vmap", "gram")}


@pytest.mark.parametrize("flavor", ["v1-7", "v1"])
def test_gram_form_matches_jax_and_vmap(flavor, capsys):
    cfg, keep_rule, stop_np = RULES[flavor]
    cfg = JaxOmpConfig(max_paths=6, min_power_ratio=cfg.min_power_ratio)
    mats, dicts = synthetic_scenes(6, SHAPES, kind="linspace" if flavor == "v1-7" else "arange")
    packed = jax_batch.pack_scenes(mats, dicts)
    want = jax_forms(packed, cfg, keep_rule, stop_np)
    port = batch_estimation.pack_scenes(mats, dicts)
    forms = {form: batch_estimation._batched_nn_omp(port, port_cfg(cfg), keep_rule, stop_np,
                                                    form=form, device="cpu")
             for form in ("vmap", "gram")}
    assert forms["gram"].power.shape == (len(mats), 6)
    assert forms["gram"].power.device.type == "cpu"
    # Tensors on a device stay there and give the same paths.
    on_dev = packed_scenes_from_reference(packed, device="cpu")
    again = batch_estimation._batched_nn_omp(on_dev, port_cfg(cfg), keep_rule, stop_np,
                                             form="gram")
    for g, w in zip(again, forms["gram"]):
        assert torch.equal(g, w)
    forms = {k: as_numpy(v) for k, v in forms.items()}
    excused = 0
    for i, (m, d) in enumerate(zip(mats, dicts)):
        ref = jax_nn_omp.nn_omp_np(d, m, cfg, keep_rule, stop_np)
        if selection_margin(d, m, ref) < NEAR_TIE:
            excused += 1
            continue
        assert_same_paths(lane(forms["gram"], i), lane(want["gram"], i), f"scene {i} vs JAX gram")
        assert_same_paths(lane(forms["gram"], i), lane(forms["vmap"], i),
                          f"scene {i} gram vs vmap")
        assert_same_paths(lane(forms["vmap"], i), lane(want["vmap"], i), f"scene {i} vs JAX vmap")
        np.testing.assert_array_equal(lane(forms["gram"], i).aoa, np.asarray(want["gram"].aoa)[i])
        np.testing.assert_array_equal(lane(forms["gram"], i).aod, np.asarray(want["gram"].aod)[i])
    with capsys.disabled():
        print(f"\n_batched_nn_omp gram {flavor}: {excused} of {len(mats)} scenes excused")
    assert excused <= 1
    with pytest.raises(ValueError, match="form"):
        batch_estimation._batched_nn_omp(port, port_cfg(cfg), form="scan", device="cpu")


def oracle_synthetic_inputs():
    """The inputs of tests/test_batch_estimation.py's
    test_batched_matches_host_oracle_synthetic, from its seed."""
    rng = np.random.default_rng(5)
    mats, dicts = [], []
    for (u, b, span) in [(6, 9, 20.0), (16, 4, 55.0), (10, 10, 8.0)]:
        ue_ang = np.sort(rng.uniform(-span, span, u))
        bs_ang = np.sort(rng.uniform(-span, span, b))
        d = jax_dictionary.make_dictionary(ue_ang, bs_ang, JaxDictionaryConfig(
            grid_res=0.5, beam_width=1.4, grid_kind="linspace"))
        m = rng.random((u, b)) * 0.1
        for _ in range(3):
            rng.integers(u), rng.integers(b)    # drawn as that test draws them
            m += 2.0 * np.outer(d.phi_rx[:, rng.integers(len(d.aoa_grid))],
                                d.phi_tx[:, rng.integers(len(d.aod_grid))])
        mats.append(m)
        dicts.append(d)
    return mats, dicts


def test_sessions_device_matches_jax_and_oracle():
    import jax

    cfg = JaxOmpConfig(max_paths=4)
    mats, dicts = oracle_synthetic_inputs()
    packed = jax_batch.pack_scenes(mats, dicts)
    want = jax.device_get(jax_batch.nn_omp_sessions_device(packed, cfg, "ratio", True))
    got = batch_estimation.nn_omp_sessions_device(batch_estimation.pack_scenes(mats, dicts),
                                                  port_cfg(cfg), "ratio", True, device="cpu")
    assert len(got) == len(mats)
    vm = as_numpy(batch_estimation._batched_nn_omp(batch_estimation.pack_scenes(mats, dicts),
                                                   port_cfg(cfg), device="cpu"))
    for i, (m, d) in enumerate(zip(mats, dicts)):
        g = got[i]
        assert g.power.shape == (4,) and g.n_iters.shape == () and g.power.device.type == "cpu"
        g = as_numpy(g)
        ref = jax_nn_omp.nn_omp_np(d, m, cfg, keep_rule="ratio", stop_nonpositive=True)
        assert selection_margin(d, m, ref) >= NEAR_TIE, f"session {i} is a near tie"
        assert_same_paths(g, want[i], f"session {i} vs JAX")
        assert_same_paths(g, ref, f"session {i} vs nn_omp_np")
        # One run per session equals the batched run bit for bit.
        for a, b in zip(g, lane(vm, i)):
            np.testing.assert_array_equal(a, b)


def test_forms_need_cuda_without_falling_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mats, dicts = oracle_synthetic_inputs()
    packed = batch_estimation.pack_scenes(mats, dicts)
    cfg = port_cfg(JaxOmpConfig(max_paths=4))
    for call in (lambda: batch_estimation._batched_nn_omp(packed, cfg),
                 lambda: batch_estimation._batched_nn_omp(packed, cfg, form="gram"),
                 lambda: batch_estimation.nn_omp_sessions_device(packed, cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
