"""The port's estimator registry as a whole == the JAX package's: the seven
families of the eleventh slice (svd, omp_dense, lasso_refine,
peak_picking, fusion, nn_omp_v13, geometric).

* The registry has the JAX registry's 13 names, in the JAX CLI's order,
  and ``cli estimate --model`` offers them; an unknown name raises
  ``KeyError``.
* ``engine="host"``: ``run_estimator(name, ...)`` prints
  ``to_string(index=False)`` byte for byte as JAX's ``run_estimator(name,
  ..., engine="host")`` and gives equal ``to_dict("records")``, on three
  seeded multipath sessions (a sparse one of 4 sweeps x 2 frames a beam,
  a dense one of 1 sweep x 64 frames with beam 40 unmapped, one of 2 x 40),
  and with four unmapped beams (where svd raises numpy's ``LinAlgError``
  in both packages: two unmapped BS beams share the angle 0).  Grids are
  widened (``grid_res`` 2.0 for lasso_refine, 1.0 for omp_dense, 0.5 for
  fusion and nn_omp_v13).
* ``engine="device", device="cpu"`` against the port's host engine: the
  same rows, Type / type / PathType labels and selected cells (angles
  equal; NN-OMP's float32 device grid equal to the float32 of the host's),
  and
    - svd: rank equal, Power and SingularValue within rtol 1e-9;
    - omp_dense (the dense sessions: on the sparse one the oracle selects
      atoms JAX's device rule calls unobservable,
      ``tests/test_torch_omp_dense.py``): Power within rtol 1e-6;
    - fusion: the NLoS metric within rtol 1e-9, the LoS row's (the v1
      NN-OMP's float32 power) within rtol 2e-4, as the NN-OMP flavors;
    - peak_picking: equal text;
    - lasso_refine: JAX's own bounds (angles 0.11 deg, Power rtol 2e-3,
      ``tests/test_device_engines.py``): the host engine stops at tol
      where the device runs 200 sweeps, and its design is float32;
    - nn_omp_v13: Power within rtol 2e-4 (the NN-OMP device engine);
    - geometric: equal text (the host body, with JAX's warning).
* ``cli estimate --model <each> --engine host --device cpu`` prints what
  JAX's ``cli.main`` prints, and writes the family's PNG.
"""

import warnings

import numpy as np
import pytest

import slam_process_tpu.models  # noqa: F401  (the JAX package loads its registry first)
from slam_process_tpu.models import registry as jax_registry
from slam_process_tpu.pipeline import cli as jax_cli
from slam_process_tpu_torch.models import registry
from slam_process_tpu_torch.pipeline import cli
from slam_process_tpu_torch.utils.synthetic import write_angle_table
from test_torch_cli import run
from test_torch_estimate import session_pair

SLICE = ("svd", "omp_dense", "lasso_refine", "peak_picking", "fusion", "nn_omp_v13",
         "geometric")
GRID = {"lasso_refine": 2.0, "omp_dense": 1.0, "fusion": 0.5, "nn_omp_v13": 0.5}
SESSIONS = {"sparse": dict(n_groups=4, frames_per_beam=2, seed=6),
            "dense": dict(n_groups=1, frames_per_beam=64, seed=9),
            "mid": dict(n_groups=2, frames_per_beam=40, seed=3)}
TABLES = {"sparse": (), "dense": (40,), "mid": ()}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    out = {k: (*session_pair(d, k, **kw), write_angle_table(d / f"{k}.xlsx",
                                                            unmapped=TABLES[k]))
           for k, kw in SESSIONS.items()}
    out["unmapped4"] = (*out["sparse"][:2], write_angle_table(d / "u4.xlsx",
                                                              unmapped=(3, 17, 40, 63)))
    return out


def overrides(name):
    return {"grid_res": GRID[name]} if name in GRID else {}


def run_both(name, scene, engine="host"):
    s, js, angles = scene
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)    # geometric's device warning
        got = registry.run_estimator(name, s, angles, engine=engine, device="cpu",
                                     **overrides(name))
    return got, js, angles


def test_registry_has_the_jax_names_in_cli_order():
    import argparse

    parser = argparse.ArgumentParser()
    jax_cli._add_estimate(parser.add_subparsers())
    jax_choices = next(a for a in parser._subparsers._group_actions[0].choices[
        "estimate"]._actions if a.dest == "model").choices
    assert registry.PORTED == tuple(jax_choices)
    assert set(registry.PORTED) == set(jax_registry._REGISTRY) and len(registry.PORTED) == 13
    assert not hasattr(registry, "NOT_PORTED")
    port_parser = cli.build_parser()
    port_choices = next(a for a in port_parser._subparsers._group_actions[0].choices[
        "estimate"]._actions if a.dest == "model").choices
    assert tuple(port_choices) == registry.PORTED


@pytest.mark.parametrize("scene", ["sparse", "dense", "mid", "unmapped4"])
@pytest.mark.parametrize("name", SLICE)
def test_host_engine_matches_jax(scenes, name, scene):
    s, js, angles = scenes[scene]
    if name == "svd" and scene == "unmapped4":
        for call in (lambda: registry.run_estimator(name, s, angles, engine="host",
                                                    device="cpu"),
                     lambda: jax_registry.run_estimator(name, js, angles, engine="host")):
            with pytest.raises(np.linalg.LinAlgError):
                call()
        return
    got, js, angles = run_both(name, scenes[scene])
    want = jax_registry.run_estimator(name, js, angles, engine="host", **overrides(name))
    assert len(got) == len(want) > 0
    assert got.to_string(index=False) == want.to_string(index=False)
    assert got.to_dict("records") == want.to_dict("records")


def assert_rows(got, host, angle_cols, type_col, exact_angles=True):
    assert len(got) == len(host) > 0
    assert list(got[type_col]) == list(host[type_col])
    for c in angle_cols:
        if exact_angles:
            np.testing.assert_array_equal(got[c], host[c], err_msg=c)
        else:   # the NN-OMP device engine's float32 grid
            np.testing.assert_array_equal(np.float32(got[c]), np.float32(host[c]), err_msg=c)


DEVICE_CASES = [(n, sc) for n in SLICE for sc in ("sparse", "dense", "mid")
                if not (n == "omp_dense" and sc == "sparse")]


@pytest.mark.parametrize("name,scene", DEVICE_CASES)
def test_device_engine_matches_host(scenes, name, scene):
    host = run_both(name, scenes[scene], "host")[0]
    got = run_both(name, scenes[scene], "device")[0]
    if name in ("peak_picking", "geometric"):
        assert got.to_string(index=False) == host.to_string(index=False)
        assert got.to_dict("records") == host.to_dict("records")
    elif name == "svd":
        assert_rows(got, host, ("AoA", "AoD"), "Type")
        np.testing.assert_array_equal(got["id"], host["id"])
        for c in ("Power", "SingularValue"):
            np.testing.assert_allclose(got[c], host[c], rtol=1e-9, atol=0, err_msg=c)
    elif name == "omp_dense":
        assert_rows(got, host, ("AoA", "AoD"), "Type")
        np.testing.assert_allclose(got["Power"], host["Power"], rtol=1e-6, atol=0)
    elif name == "fusion":
        assert_rows(got, host, ("aoa", "aod"), "type")
        np.testing.assert_array_equal(got["id"], host["id"])
        los = np.asarray(host["type"]) == "LoS"
        np.testing.assert_allclose(got["metric"][~los], host["metric"][~los], rtol=1e-9, atol=0)
        np.testing.assert_allclose(got["metric"][los], host["metric"][los], rtol=2e-4, atol=0)
    elif name == "lasso_refine":
        assert len(got) == len(host) > 0 and list(got["Type"]) == list(host["Type"])
        for c in ("AoA", "AoD"):
            np.testing.assert_allclose(got[c], host[c], atol=0.11, rtol=0, err_msg=c)
        np.testing.assert_allclose(got["Power"], host["Power"], rtol=2e-3, atol=0)
    else:   # nn_omp_v13
        assert_rows(got, host, ("AoA", "AoD"), "PathType", exact_angles=False)
        np.testing.assert_allclose(got["Power"], host["Power"], rtol=2e-4, atol=0)


@pytest.mark.parametrize("name", SLICE)
def test_cli_estimate_host_matches_jax(tmp_path, capsys, scenes, name):
    from test_torch_cli import own

    from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, to_hex_text

    angles = scenes["mid"][2]
    log = tmp_path / "mid.txt"
    log.write_bytes(to_hex_text(synthetic_session_bytes(
        n_groups=2, frames_per_beam=40, baselines_per_group=5, seed=3, n_paths=3)))
    argv = ["estimate", "--input", str(log), "--mapping", str(angles), "--model", name,
            "--engine", "host"] + (["--grid-res", str(GRID[name])] if name in GRID else [])
    rc, got = run(cli.main, argv + ["--output", str(tmp_path / "port.png"), "--device", "cpu"],
                  capsys)
    rc_j, want = run(jax_cli.main, argv + ["--output", str(tmp_path / "jax.png")], capsys)
    assert rc == rc_j == 0
    got, want = own(got), own(want)
    assert got[-1] == f"输出PNG: {tmp_path / 'port.png'}"
    assert got[:-1] == want[:-1] and len(got) > 2
    assert (tmp_path / "port.png").stat().st_size > 10_000
