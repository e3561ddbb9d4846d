"""The port's fusion NLoS loop and power preprocessing == the JAX package's.

* ``fusion_nlos_np`` prints and records as JAX's DataFrame, with and
  without a LoS seed, with the stop rule taken (a weak scene) and not.
* ``fusion_nlos_torch`` (float64 on the CPU) against ``fusion_nlos_np``:
  the same peaks (cells, hence angles, equal; the same count), metric
  within rtol 1e-9; against JAX's float32 ``fusion_nlos_jax`` within JAX's
  own bounds (angles 0.51 deg, metric rtol 1e-3,
  ``tests/test_device_engines.py``).
* ``preprocess_power``: all five modes within 1e-12 of JAX's (in fact
  equal), and an unknown mode raises as JAX's does.
"""

import numpy as np
import pytest
import torch

import slam_process_tpu.models  # noqa: F401  (the JAX package loads its registry first)
from slam_process_tpu.config import DictionaryConfig as JaxDictionaryConfig
from slam_process_tpu.models import fusion as jax_fusion
from slam_process_tpu.models import preprocess as jax_pre
from slam_process_tpu.models.dictionary import make_dictionary
from slam_process_tpu_torch.models import fusion, preprocess
from slam_process_tpu_torch.utils.synthetic import ANGLES


def scene(seed, weak=False):
    """A [U, B] scene over the beam angles: three Gaussian paths plus noise,
    and its inclusive-arange 0.5 deg dictionary.  ``weak``: one dominant
    path, two narrow ones 100x and 2,000x weaker, little noise and 0.5 deg
    beams, so past the LoS masks the second NLoS peak falls below 0.1 of
    the first."""
    rng = np.random.default_rng(seed)
    ue, bs = ANGLES[::2].astype(np.float32), ANGLES[1::2].astype(np.float32)
    paths = [(1.0, rng.uniform(-35, 35), rng.uniform(-35, 35), 8.0)]
    if weak:    # narrow paths on the beams, far from the first
        noise, width = 1e-4, 0.5
        paths += [(0.01, ue[3], bs[28], 0.5), (0.0005, ue[28], bs[3], 0.5)]
    else:
        noise, width = 0.02, 1.4
        paths += [(rng.uniform(0.3, 0.8), rng.uniform(-35, 35), rng.uniform(-35, 35), 8.0)
                  for _ in range(2)]
    mat = rng.uniform(0, noise, (len(ue), len(bs)))
    for p, a, d, w in paths:
        mat += p * np.exp(-((ue[:, None] - a) ** 2 + (bs[None, :] - d) ** 2) / w)
    d = make_dictionary(ue, bs, JaxDictionaryConfig(grid_res=0.5, beam_width=width,
                                                    grid_kind="arange_inclusive"))
    return d, mat * 1e5


def seeds_of(d, mat):
    """(los_aoa, los_aod) at the scene's brightest correlation cell, and no
    seed."""
    corr = d.phi_rx.T @ mat @ d.phi_tx
    i, j = np.unravel_index(np.argmax(corr), corr.shape)
    return [(float(d.aoa_grid[i]), float(d.aod_grid[j])), (None, None)]


@pytest.mark.parametrize("seed,weak", [(1, False), (2, False), (3, True)])
def test_fusion_nlos_matches_jax_and_oracle(seed, weak):
    import jax
    import jax.numpy as jnp

    d, mat = scene(seed, weak)
    counts = set()
    for los_aoa, los_aod in seeds_of(d, mat):
        ref = fusion.fusion_nlos_np(d, mat, los_aoa, los_aod)
        want = jax_fusion.fusion_nlos_np(d, mat, los_aoa, los_aod)
        assert ref.to_string(index=False) == want.to_string(index=False)
        assert ref.to_dict("records") == want.to_dict("records")
        counts.add(len(ref))

        t = [torch.from_numpy(np.asarray(x, np.float64))
             for x in (d.phi_rx, d.phi_tx, d.aoa_grid, d.aod_grid, mat)]
        has = los_aoa is not None
        a, dd, m, v = (x.numpy() for x in fusion.fusion_nlos_torch(
            *t, los_aoa or 0.0, los_aod or 0.0, has))
        assert v.sum() == len(ref) and v[:len(ref)].all()
        np.testing.assert_array_equal(a[v], ref["aoa"])
        np.testing.assert_array_equal(dd[v], ref["aod"])
        np.testing.assert_allclose(m[v], ref["metric"], rtol=1e-9, atol=0)

        ja, jd, jm, jv = jax.device_get(jax.jit(jax_fusion.fusion_nlos_jax)(
            *(jnp.asarray(x, jnp.float32) for x in (d.phi_rx, d.phi_tx, d.aoa_grid,
                                                    d.aod_grid, mat)),
            jnp.float32(los_aoa or 0.0), jnp.float32(los_aod or 0.0), jnp.bool_(has)))
        np.testing.assert_array_equal(np.asarray(jv), v)
        np.testing.assert_allclose(np.asarray(ja)[v], a[v], atol=0.51)
        np.testing.assert_allclose(np.asarray(jd)[v], dd[v], atol=0.51)
        np.testing.assert_allclose(np.asarray(jm)[v], m[v], rtol=1e-3)
    assert (min(counts) < 3) == weak     # the stop rule cut the weak scene


@pytest.mark.parametrize("method", ["none", "log", "power", "quantile", "adaptive"])
def test_preprocess_power_matches_jax(method):
    rng = np.random.default_rng(7)
    for data in (rng.uniform(-90, -30, (17, 23)), rng.integers(1, 1 << 18, (64, 64)) * 1.0):
        got, want = preprocess.preprocess_power(data, method), jax_pre.preprocess_power(data,
                                                                                     method)
        assert got.dtype == want.dtype == np.float64
        assert np.max(np.abs(got - want)) <= 1e-12 * max(np.max(np.abs(want)), 1.0)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown preprocessing method"):
        preprocess.preprocess_power(np.ones((2, 2)), "gamma")
