"""The port's mesh forms (``parallel/mesh.py``) on the CPU against the JAX
package and against the port's own ``mesh=None``.

Meshes of 8 CPU positions at (8, 1) and (4, 2) (positions may name one
device; every shard computes what it would compute alone):

  * ``make_mesh``: shape, hashing, defaults and JAX's error text;
    ``Mesh.local`` refuses a model axis that spans processes;
  * ``batched_session_pipeline`` / ``run_dataset`` / the grouped form:
    every field equal to ``mesh=None`` bit for bit (padding to a multiple
    of ``data`` included); the (8, 1) batch against JAX's batch on its
    (8, 1) mesh and the (4, 2) one against JAX's unsharded batch (the
    JAX package's tier-1 tests hold those two equal), under
    ``test_torch_pipeline.py``'s contract;
  * the model axis in the estimators: a dictionary with two equal atoms in
    different model slices ties, and the combine keeps the lowest global
    index, as the unsharded argmax and JAX's do; padded atoms never win;
  * ``Session.sweep_paths`` / ``sweep_paths_dataset`` and
    ``estimate_sessions`` at both shapes equal ``mesh=None`` exactly, and
    JAX's under ``tests/test_sweep_paths.py``'s contract (selections and
    valid equal, power within rtol 2e-4); the estimate against JAX's
    ``estimate_sessions`` on its (4, 2) mesh;
  * ``MultiStreamingSession`` at both shapes with a ragged
    ``finalize_streams`` equals ``mesh=None`` exactly (counts, sums,
    filtered rows, paths, tracks), and JAX's unsharded session; a mesh
    checkpoint restores without a mesh and on another mesh.

Each JAX side runs once, in a module-scoped fixture.
"""

import numpy as np
import pytest
import torch

from slam_process_tpu_torch.models import batch_estimation
from slam_process_tpu_torch.models.nn_omp import nn_omp_gram_batch, nn_omp_scenes
from slam_process_tpu_torch.config import OmpConfig
from slam_process_tpu_torch.parallel import batch
from slam_process_tpu_torch.parallel import streaming_device as sd
from slam_process_tpu_torch.parallel.mesh import Mesh, make_mesh
from slam_process_tpu_torch.pipeline.session import sweep_paths_dataset
from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, write_angle_table
from test_torch_pipeline import assert_outputs_match
from test_torch_streaming import assert_same_paths

CPU8 = [torch.device("cpu")] * 8
SHAPES = [(8, 1), (4, 2)]
SESSIONS = [dict(n_groups=g, frames_per_beam=2, baselines_per_group=5, seed=s, n_paths=3,
                 junk_frac=0.05) for g, s in zip((2, 3, 4, 5, 2), range(40, 45))]
BOUNDS = dict(max_groups=16, max_baselines_per_group=32)
N_PADDED = 1 << 15


def mesh_of(shape) -> Mesh:
    return make_mesh(shape, devices=CPU8)


def same_bits(a, b) -> bool:
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def assert_tuples_equal(got, want):
    assert type(got) is type(want)
    for f in want._fields:
        if getattr(want, f) is None:
            assert getattr(got, f) is None
            continue
        assert same_bits(getattr(got, f), getattr(want, f)), f


def row(out, i):
    return type(out)(*(None if x is None else x[i] for x in out))


# -- make_mesh -------------------------------------------------------------------


def test_make_mesh_shape_defaults_and_errors():
    from slam_process_tpu.parallel.mesh import make_mesh as jax_make_mesh
    import jax

    m = mesh_of((4, 2))
    assert dict(m.shape) == {"data": 4, "model": 2} and list(m.shape) == ["data", "model"]
    assert m.size == 8 and m.devices.shape == (4, 2)
    assert hash(m) == hash(mesh_of((4, 2))) and m == mesh_of((4, 2)) and m != mesh_of((8, 1))
    assert [len(r) for r in m.rows()] == [2] * 4
    assert dict(make_mesh(devices=CPU8[:3]).shape) == {"data": 3, "model": 1}
    with pytest.raises(ValueError) as ours:
        make_mesh((4, 2), devices=CPU8[:4])
    with pytest.raises(ValueError) as ref:
        jax_make_mesh((4, 2), devices=jax.devices()[:4])
    assert str(ours.value) == str(ref.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device="):
            make_mesh((1, 1))
    # The model axis must lie within one process.
    devs = np.empty(8, dtype=object)
    devs[:] = CPU8
    split = Mesh(devs.reshape(4, 2), ("data", "model"),
                 np.array([[0, 0], [0, 1], [1, 1], [1, 1]]), 0)
    with pytest.raises(ValueError, match="model axis of data rows \\[1\\] across processes"):
        split.local()
    ok = Mesh(devs.reshape(4, 2), ("data", "model"), np.repeat([0, 1], 4).reshape(4, 2), 1)
    assert dict(ok.local().shape) == {"data": 2, "model": 2}


# -- batch -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def raws():
    return [synthetic_session_bytes(**c) for c in SESSIONS]


@pytest.fixture(scope="module")
def stacked(raws):
    return batch.stack_sessions([raws[i % len(raws)] for i in range(8)], N_PADDED)


@pytest.fixture(scope="module")
def jax_batches(stacked):
    """JAX's batch of the 8 sessions on its (8, 1) mesh and unsharded."""
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.ops.raster import colormap_lut
    from slam_process_tpu.parallel.batch import batched_session_pipeline
    from slam_process_tpu.parallel.mesh import make_mesh as jax_make_mesh

    lut = jnp.asarray(colormap_lut("viridis"))
    out = {}
    for shape in ((8, 1), (1, 1)):
        mesh = jax_make_mesh(shape)
        with mesh:
            fn = batched_session_pipeline(mesh, N_PADDED, **BOUNDS)
            out[shape] = jax.device_get(fn(jnp.asarray(stacked[0]), jnp.asarray(stacked[1]),
                                           lut))
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_batched_pipeline_on_a_mesh(stacked, jax_batches, shape):
    from slam_process_tpu_torch.ops.raster import colormap_lut

    lut = colormap_lut("viridis")
    want = batch.batched_session_pipeline(None, N_PADDED, device="cpu", **BOUNDS)(*stacked, lut)
    fn = batch.batched_session_pipeline(mesh_of(shape), N_PADDED, **BOUNDS)
    got = fn(*stacked, lut)
    assert_tuples_equal(got, want)
    shards = fn.shards(*stacked, lut)
    assert len(shards) == shape[0] and all(s.n_frames.shape[0] == 8 // shape[0] for s in shards)
    jax_out = jax_batches[shape if shape == (8, 1) else (1, 1)]
    for i in range(8):
        assert_outputs_match(row(got, i), row(jax_out, i))
    # Five sessions on four data rows: three empty sessions pad the batch.
    five = batch.batched_session_pipeline(mesh_of(shape), N_PADDED, **BOUNDS)(
        stacked[0][:5], stacked[1][:5], lut)
    assert_tuples_equal(five, row_slice(want, 5))


def row_slice(out, n):
    return type(out)(*(None if x is None else x[:n] for x in out))


@pytest.mark.parametrize("shape", SHAPES)
def test_run_dataset_on_a_mesh_equals_mesh_none(raws, shape):
    kw = dict(quantum=1 << 12, **BOUNDS)
    assert len({batch.bucket_size(len(r), 1 << 12) for r in raws}) > 1
    want = batch.run_dataset(None, raws, device="cpu", **kw)
    got = batch.run_dataset(mesh_of(shape), raws, **kw)
    for g, w in zip(got, want):
        assert_tuples_equal(g, w)
    grouped = batch.run_dataset_batched_grouped(mesh_of(shape), raws, 1 << 12, **BOUNDS)
    for idxs, out in grouped:
        assert out.n_frames.shape[0] % shape[0] == 0
        for r, i in enumerate(idxs):
            assert same_bits(out.counts[r], want[i].counts)
        assert not out.n_frames[len(idxs):].any()     # the padding sessions


# -- the model axis ------------------------------------------------------------------


def tied_dictionary():
    """phi_rx [U, 8] whose columns 1 and 5 are equal (slices 0 and 1 at
    model = 2), and scenes led by that atom (the two tie exactly) with a
    weaker second atom."""
    rng = np.random.default_rng(7)
    u, b = 6, 5
    phi_rx = rng.random((u, 8)).astype(np.float32)
    phi_rx[:, 5] = phi_rx[:, 1]
    phi_tx = rng.random((b, 4)).astype(np.float32)
    mats = np.stack([np.outer(phi_rx[:, 1], phi_tx[:, t]) * (2 + t)
                     + 0.5 * np.outer(phi_rx[:, 3], phi_tx[:, (t + 1) % 4]) for t in range(4)])
    return phi_rx, phi_tx, mats.astype(np.float32)


def test_model_axis_tie_keeps_the_lowest_global_index():
    import jax.numpy as jnp

    from slam_process_tpu.config import OmpConfig as JaxOmpConfig
    from slam_process_tpu.models.nn_omp import nn_omp_gram_batch_jax

    phi_rx, phi_tx, mats = tied_dictionary()
    aoa = np.arange(8, dtype=np.float32)
    aod = np.arange(4, dtype=np.float32)
    cfg = OmpConfig(max_paths=2)
    t = [torch.from_numpy(x) for x in (phi_rx, phi_tx, aoa, aod, mats)]
    plain = nn_omp_gram_batch(*t, cfg)
    want = nn_omp_gram_batch_jax(*(jnp.asarray(x) for x in (phi_rx, phi_tx, aoa, aod, mats)),
                                 cfg=JaxOmpConfig(max_paths=2))
    for tp in (2, 4, 3):     # 3: Ga pads 8 -> 9 with a zero atom
        got = nn_omp_gram_batch(*t, cfg, model_devices=CPU8[:tp])
        assert_tuples_equal(got, plain)
    assert (plain.aoa_idx[:, 0] == 1).all()          # 1, not its twin 5
    np.testing.assert_array_equal(plain.aoa_idx.numpy(), np.asarray(want.aoa_idx))
    # The session form: the same tie in the chain's flat argmax.
    scenes = [torch.from_numpy(np.repeat(x[None], 4, 0)) for x in (phi_rx, phi_tx, aoa, aod)]
    plain = nn_omp_scenes(*scenes, t[4], cfg)
    for tp in (2, 3):
        assert_tuples_equal(nn_omp_scenes(*scenes, t[4], cfg, model_devices=CPU8[:tp]), plain)
    assert (plain.aoa_idx[:, 0] == 1).all()


def test_padded_atoms_never_win():
    """Every real correlation negative: with stop_nonpositive=False a zero
    padded atom would win an argmax; the sharded form masks it out."""
    phi_rx, phi_tx, mats = tied_dictionary()
    t = [torch.from_numpy(x) for x in (phi_rx, phi_tx, np.arange(8, dtype=np.float32),
                                       np.arange(4, dtype=np.float32), -mats)]
    cfg = OmpConfig(max_paths=2)
    plain = nn_omp_gram_batch(*t, cfg, "positive", False)
    got = nn_omp_gram_batch(*t, cfg, "positive", False, model_devices=CPU8[:3])
    assert_tuples_equal(got, plain)
    assert (plain.aoa_idx[plain.aoa_idx >= 0] < 8).all()


# -- sweeps and sessions -----------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from test_torch_sweep_paths_dataset import SESSIONS as DS, sessions_of
    from slam_process_tpu_torch.utils.synthetic import to_hex_text

    tmp = tmp_path_factory.mktemp("mesh_dataset")
    logs = []
    for i, kw in enumerate(DS):
        path = tmp / f"Serial Debug 2026-10-17 1{i}0000.txt"
        path.write_bytes(to_hex_text(synthetic_session_bytes(**kw), "shipped"))
        logs.append(path)
    angles = write_angle_table(tmp / "beam_angle.xlsx")
    return logs, angles, sessions_of(logs), sessions_of(logs, "jax")


@pytest.fixture(scope="module")
def jax_dataset_paths(dataset):
    from slam_process_tpu.pipeline.session import sweep_paths_dataset as jax_dataset

    logs, angles, _, jax_sessions = dataset
    return jax_dataset(jax_sessions, angles)


def assert_paths_equal(a, b):
    (pa, va), (pb, vb) = a, b
    assert same_bits(va, vb)
    assert type(pa) is type(pb)
    for f in pa._fields:
        assert same_bits(getattr(pa, f), getattr(pb, f)), f


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("estimator", ["nn_omp", "sm_sic"])
def test_sweep_paths_on_a_mesh(dataset, jax_dataset_paths, shape, estimator):
    _, angles, sessions, _ = dataset
    mesh = mesh_of(shape)
    want = sweep_paths_dataset(sessions, angles, estimator=estimator, device="cpu")
    got = sweep_paths_dataset(sessions, angles, estimator=estimator, mesh=mesh)
    for g, w in zip(got, want):
        assert_paths_equal(g, w)
    for s, w in zip(sessions, want):
        assert_paths_equal(s.sweep_paths(angles, estimator=estimator, mesh=mesh), w)
    if estimator == "nn_omp":
        for (p, v), (q, w) in zip(got, jax_dataset_paths):
            np.testing.assert_array_equal(v, w)
            for field in ("aoa_idx", "aod_idx", "valid", "n_iters"):
                np.testing.assert_array_equal(getattr(p, field), np.asarray(getattr(q, field)),
                                              err_msg=field)
            np.testing.assert_allclose(p.power[p.valid], np.asarray(q.power)[p.valid],
                                       rtol=2e-4, atol=1e-6)


@pytest.fixture(scope="module")
def estimate_pairs(tmp_path_factory):
    from test_torch_estimate import session_pair

    tmp = tmp_path_factory.mktemp("mesh_estimate")
    return [session_pair(tmp, "a"), session_pair(tmp, "b", drop_ue=range(10), seed=4),
            session_pair(tmp, "c", drop_bs=range(40, 64), n_groups=2, seed=5)]


@pytest.fixture(scope="module")
def jax_estimate(estimate_pairs, dataset):
    """JAX's estimate_sessions of the three sessions on its (4, 2) mesh."""
    from slam_process_tpu.models import batch_estimation as jax_batch
    from slam_process_tpu.parallel.mesh import make_mesh as jax_make_mesh

    return jax_batch.estimate_sessions([js for _, js in estimate_pairs], dataset[1], "v1-7",
                                       grid_res=1.0, mesh=jax_make_mesh((4, 2)))


@pytest.mark.parametrize("shape", SHAPES)
def test_estimate_sessions_on_a_mesh(estimate_pairs, dataset, jax_estimate, shape):
    from test_torch_estimate import assert_same_paths as assert_omp_close

    angles = dataset[1]
    sessions = [s for s, _ in estimate_pairs]
    want = batch_estimation.estimate_sessions(sessions, angles, device="cpu", grid_res=1.0)
    got = batch_estimation.estimate_sessions(sessions, angles, mesh=mesh_of(shape), grid_res=1.0)
    for s, g, w, j in zip(sessions, got, want, jax_estimate):
        assert_tuples_equal(g, w)
        assert_omp_close(g, j, f"{s.name} on {shape} vs JAX (4, 2)")


# -- streams -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def stream_specs(tmp_path_factory):
    from slam_process_tpu.parallel import streaming_device as jsd
    from slam_process_tpu_torch.convert import paths_spec_from_reference

    angles = write_angle_table(tmp_path_factory.mktemp("mesh_streams") / "beam_angle.xlsx")
    jspec = jsd.make_paths_spec(angles, s_step=8, grid_res=2.0)
    return jspec, paths_spec_from_reference(*jspec, device="cpu")


CHUNK, STEP, ECAP = 1 << 12, 6000, 1 << 13


def ragged_run(make, raws):
    """Feed every stream, finalize stream 1 alone after two feeds, feed the
    rest (b"" for stream 1), finalize."""
    ms = make()
    end = max(len(r) for r in raws)
    for k, off in enumerate(range(0, end, STEP)):
        ms.feed([b"" if (i == 1 and k >= 2) else r[off:off + STEP] for i, r in enumerate(raws)])
        if k == 1:
            ms.finalize_streams([1])
    ms.finalize()
    return ms


def port_stream(spec, mesh=None):
    return sd.MultiStreamingSession(len(SESSIONS), chunk_bytes=CHUNK, collect_paths=spec,
                                    emit_capacity=ECAP, mesh=mesh,
                                    device=None if mesh is not None else "cpu")


@pytest.fixture(scope="module")
def streams_none(raws, stream_specs):
    return ragged_run(lambda: port_stream(stream_specs[1]), raws)


@pytest.fixture(scope="module")
def jax_streams(raws, stream_specs):
    from slam_process_tpu.parallel import streaming_device as jsd

    return ragged_run(lambda: jsd.MultiStreamingSession(
        len(SESSIONS), chunk_bytes=CHUNK, collect_paths=stream_specs[0], emit_capacity=ECAP),
        raws)


def readers(ms, i):
    return ms.stream_paths(i), ms.stream_tracks(i)[1], ms.stream_tracks(i)


@pytest.mark.parametrize("shape", SHAPES)
def test_multi_stream_on_a_mesh(raws, stream_specs, streams_none, jax_streams, shape):
    got = ragged_run(lambda: port_stream(stream_specs[1], mesh_of(shape)), raws)
    assert got._n_pad == 8 and len(got._shards) == shape[0]
    for g, w in zip(got.results(), streams_none.results()):
        assert same_bits(g, w)
    np.testing.assert_array_equal(got.n_sweeps_closed_all(), streams_none.n_sweeps_closed_all())
    jr = jax_streams.results()
    for g, w in zip(got.results()[:3], jr[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(got.results()[3], np.asarray(jr[3]).astype(np.int64))
    for i in range(len(SESSIONS)):
        assert same_bits(got.stream_filtered(i), streams_none.stream_filtered(i))
        assert_same_paths(readers(got, i), readers(streams_none, i))
        np.testing.assert_array_equal(got.stream_filtered(i), jax_streams.stream_filtered(i))
        assert_same_paths(readers(got, i), readers(jax_streams, i), exact=False)
        n = int(got.n_sweeps_closed_all()[i])
        for a, b in zip(got.stream_track_columns(i, 0, n),
                        streams_none.stream_track_columns(i, 0, n)):
            np.testing.assert_array_equal(a, b)


def test_multi_stream_mesh_checkpoint_restores_anywhere(raws, stream_specs, tmp_path):
    spec = stream_specs[1]
    half = 2 * STEP
    ms = port_stream(spec, mesh_of((4, 2)))
    for off in range(0, half, STEP):
        ms.feed([r[off:off + STEP] for r in raws])
    ms.save_checkpoint(tmp_path / "mesh.npz")
    ref = port_stream(spec)
    for off in range(0, half, STEP):
        ref.feed([r[off:off + STEP] for r in raws])
    ref.save_checkpoint(tmp_path / "none.npz")
    with np.load(tmp_path / "mesh.npz") as a, np.load(tmp_path / "none.npz") as b:
        assert int(a["n_leaves"]) == int(b["n_leaves"])
        for k in range(int(a["n_leaves"])):
            np.testing.assert_array_equal(a[f"leaf_{k:04d}"], b[f"leaf_{k:04d}"])
    end = max(len(r) for r in raws)
    outs = []
    for back in (sd.MultiStreamingSession.restore(tmp_path / "mesh.npz", device="cpu"),
                 sd.MultiStreamingSession.restore(tmp_path / "mesh.npz",
                                                  mesh=make_mesh((3, 1), devices=CPU8)),
                 ref):
        for off in range(half, end, STEP):
            back.feed([r[off:off + STEP] for r in raws])
        back.finalize()
        outs.append(back)
    for back in outs[:2]:
        for g, w in zip(back.results(), outs[2].results()):
            assert same_bits(g, w)
        for i in range(len(SESSIONS)):
            assert_same_paths(readers(back, i), readers(outs[2], i))
