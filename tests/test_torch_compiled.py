"""The port's compiled programs == the JAX package's, on the CPU.

``compiled_session_pipeline(n, ...)(padded, lut)`` and
``compiled_text_session_pipeline(n, ...)(text, n_text, lut)`` with
``device="cpu"`` (the eager bodies: the CUDA graphs run on the card, in
``tests/test_torch_cuda.py``) against the JAX package's functions of the
same names, jitted on the CPU, on the same seeded synthetic session, over
two buckets, ``use_log`` and ``blur_sigma``: ``DeviceSessionOut``'s integer
and bool fields equal, ``mean_grid`` bit-equal (cell sums < 2^24), the
blurred raster within 1e-5 relative, ``norm_t`` within 1e-3 absolute and
LUT-bin flips under 1 % (the bounds of ``tests/test_torch_pipeline.py``:
JAX blurs with separable matmuls, the port with direct 7 x 7 sums).  Also:
the programs' cache, outputs of two calls that share no storage, the
entry points going through the programs, the tokenizer's device-scalar
length, ``FlatOutputs`` bit for bit, K1's limit at the window's length
equal to no limit, and the stream's state updated in place (every state
tensor keeps its storage across windows) with results equal to JAX's
``DeviceStreamingSession``.
"""

import numpy as np
import pytest
import torch

from slam_process_tpu.ops.raster import colormap_lut as jax_colormap_lut
from slam_process_tpu.parallel import streaming_device as jax_sd
from slam_process_tpu.pipeline import device as jax_device
from slam_process_tpu_torch.ops.decode import decode_rows_streams
from slam_process_tpu_torch.ops.tokenize import prepare_text, stride3_offset, tokenize_stride3
from slam_process_tpu_torch.parallel import streaming_device as sd
from slam_process_tpu_torch.pipeline import device
from slam_process_tpu_torch.utils.graphs import FlatOutputs, GraphRunner
from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, to_hex_text

SESSION = dict(n_groups=3, frames_per_beam=2, baselines_per_group=5, junk_frac=0.05, seed=4)
EXACT = ("frames", "frame_valid", "n_frames", "corrected_bs", "keep", "correct_overflow",
         "n_kept", "counts")
BYTE_BUCKETS = (1 << 14, 1 << 15)
TEXT_BUCKETS = (3 << 13, 3 << 14)


@pytest.fixture(scope="module")
def raw():
    return synthetic_session_bytes(**SESSION)


@pytest.fixture(autouse=True)
def no_jax_disk_cache(monkeypatch):
    # The JAX factories would point XLA's persistent cache at the home
    # directory; these tests keep everything inside the process.
    monkeypatch.setenv("SLAM_PROCESS_TPU_NO_COMPILE_CACHE", "1")


def lut():
    return torch.from_numpy(device.colormap_lut("viridis"))


def assert_session_matches(got, want):
    assert got.n_discarded is None
    for field in EXACT:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    mean, counts = got.mean_grid.numpy(), got.counts.numpy()
    assert np.nanmax(np.nan_to_num(mean) * counts) < 2 ** 24
    np.testing.assert_array_equal(mean, np.asarray(want.mean_grid))
    b, w_b = got.blurred.numpy(), np.asarray(want.blurred)
    fin = np.isfinite(w_b)
    assert (np.isfinite(b) == fin).all() and fin.any()
    np.testing.assert_allclose(b[fin], w_b[fin], rtol=1e-5)
    t, w_t = got.norm_t.numpy(), np.asarray(want.norm_t)
    assert (np.isfinite(t) == np.isfinite(w_t)).all()
    np.testing.assert_allclose(t[fin], w_t[fin], atol=1e-3)
    bins = np.clip((np.nan_to_num(t) * 256).astype(int), 0, 255)
    w_bins = np.clip((np.nan_to_num(w_t) * 256).astype(int), 0, 255)
    assert (bins != w_bins).mean() < 0.01


@pytest.mark.parametrize("blur_sigma", [1.0, 2.0])
@pytest.mark.parametrize("use_log", [True, False])
@pytest.mark.parametrize("n", BYTE_BUCKETS)
def test_compiled_session_pipeline_matches_jax(raw, n, use_log, blur_sigma):
    import jax.numpy as jnp

    padded = device.pad_bytes(raw, n)
    want = jax_device.compiled_session_pipeline(n, blur_sigma, use_log)(
        jnp.asarray(padded), jnp.int32(len(raw)), jnp.asarray(jax_colormap_lut("viridis")))
    fn = device.compiled_session_pipeline(n, blur_sigma, use_log, device="cpu")
    got = fn(torch.from_numpy(padded), lut())
    assert isinstance(got, device.DeviceSessionOut)
    assert_session_matches(got, want)
    assert int(got.n_frames) > 0


@pytest.mark.parametrize("blur_sigma", [1.0, 2.0])
@pytest.mark.parametrize("use_log", [True, False])
@pytest.mark.parametrize("m", TEXT_BUCKETS)
def test_compiled_text_session_pipeline_matches_jax(raw, m, use_log, blur_sigma):
    import jax.numpy as jnp

    data = to_hex_text(raw, "shipped")
    text, n_text = prepare_text(data, stride3_offset(data), m)
    want = jax_device.compiled_text_session_pipeline(m, blur_sigma, use_log)(
        jnp.asarray(text), jnp.int32(n_text), jnp.asarray(jax_colormap_lut("viridis")))
    fn = device.compiled_text_session_pipeline(m, blur_sigma, use_log, device="cpu")
    got = fn(torch.from_numpy(text), n_text, lut())
    assert isinstance(got, device.TextSessionOut)
    assert bool(got.tokenize_regular) and bool(want.tokenize_regular)
    assert int(got.n_tokens) == int(want.n_tokens) == len(raw)
    assert_session_matches(got.out, want.out)
    # The length as a device scalar, as the CUDA graph reads it.
    again = fn(torch.from_numpy(text), torch.tensor(n_text, dtype=torch.int32), lut())
    for a, b in zip(FlatOutputs._leaves(got), FlatOutputs._leaves(again)):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("factory", [device.compiled_session_pipeline,
                                     device.compiled_text_session_pipeline])
def test_programs_are_cached_per_argument_set(factory):
    assert factory.cache_info().maxsize == 32
    a = factory(3 << 14, 1.0, True, device="cpu")
    assert factory(3 << 14, 1.0, True, device="cpu") is a
    assert factory(3 << 14, 1.0, False, device="cpu") is not a
    assert factory(3 << 14, 1.0, True, 128, device="cpu") is not a


@pytest.mark.parametrize("kind", ["bytes", "text"])
def test_two_calls_share_no_output_storage(raw, kind):
    other = synthetic_session_bytes(**dict(SESSION, seed=9))
    if kind == "bytes":
        fn = device.compiled_session_pipeline(1 << 14, device="cpu")
        outs = [fn(torch.from_numpy(device.pad_bytes(r, 1 << 14)), lut()) for r in (raw, other)]
    else:
        fn = device.compiled_text_session_pipeline(3 << 13, device="cpu")
        outs = []
        for r in (raw, other):
            data = to_hex_text(r, "shipped")
            text, n_text = prepare_text(data, stride3_offset(data), 3 << 13)
            outs.append(fn(torch.from_numpy(text), n_text, lut()))
    first = [t.clone() for t in FlatOutputs._leaves(outs[0])]
    ptrs = [{t.untyped_storage().data_ptr() for t in FlatOutputs._leaves(o)} for o in outs]
    assert not ptrs[0] & ptrs[1]
    for a, b in zip(first, FlatOutputs._leaves(outs[0])):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())      # untouched by the second call
    a, b = (o if kind == "bytes" else o.out for o in outs)
    assert not torch.equal(a.frames, b.frames)


def test_program_refuses_another_bucket(raw):
    fn = device.compiled_session_pipeline(1 << 14, device="cpu")
    with pytest.raises(ValueError, match="16384"):
        fn(torch.from_numpy(device.pad_bytes(raw, 1 << 15)), lut())


def test_entry_points_go_through_the_programs(raw, monkeypatch):
    calls = []
    for name in ("compiled_session_pipeline", "compiled_text_session_pipeline"):
        real = getattr(device, name)
        monkeypatch.setattr(device, name, lambda *a, _real=real, _name=name, **kw:
                            calls.append((_name, a[0], kw["device"])) or _real(*a, **kw))
    out = device.run_session_on_device(raw, device="cpu", count_discards=True)
    res = device.run_session_from_text(to_hex_text(raw, "shipped"), device="cpu")
    assert calls == [("compiled_session_pipeline", 1 << 18, torch.device("cpu")),
                     ("compiled_text_session_pipeline", 3 << 18, torch.device("cpu"))]
    assert int(out.n_discarded) >= 0 and bool(res.tokenize_regular)
    for field in EXACT:
        assert torch.equal(getattr(out, field), getattr(res.out, field)), field


@pytest.mark.parametrize("n_text", [0, 1, 2, 3, 299, 300])
def test_tokenizer_takes_the_length_as_a_device_scalar(raw, n_text):
    data = to_hex_text(raw, "shipped")
    text = torch.from_numpy(prepare_text(data[:stride3_offset(data) + n_text],
                                         stride3_offset(data), 3 << 8)[0])
    want = tokenize_stride3(text, n_text)
    got = tokenize_stride3(text, torch.tensor(n_text, dtype=torch.int32))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for bad in (torch.tensor(n_text), torch.tensor([n_text], dtype=torch.int32)):
        with pytest.raises(ValueError, match="0-d int32"):
            tokenize_stride3(text, bad)


def as_bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def test_flat_outputs_round_trip_bit_for_bit(raw):
    out = device.run_session_on_device(raw, device="cpu")
    tree = device.TextSessionOut(out, torch.tensor(True), torch.tensor(7, dtype=torch.int32))
    flat = FlatOutputs()
    buf = flat.pack(tree)
    assert buf.dtype == torch.uint8 and buf.dim() == 1
    back = flat.unpack(buf.clone())
    assert type(back) is device.TextSessionOut and type(back.out) is device.DeviceSessionOut
    assert back.out.n_discarded is None
    for a, b in zip(FlatOutputs._leaves(back), FlatOutputs._leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(as_bytes(a), as_bytes(b))
    with pytest.raises(ValueError, match="changed"):
        flat.pack(tree._replace(n_tokens=torch.tensor(7)))


def test_graph_runner_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        GraphRunner(lambda x: x + 1, [torch.zeros(4)])
    with pytest.raises(ValueError, match="CUDA"):
        GraphRunner(lambda: None, device="cpu")


@pytest.mark.parametrize("chunk", [1 << 12, 5_000])
def test_limit_at_the_window_length_equals_no_limit(raw, chunk):
    """A full window's limit is its length: K1's result for no limit."""
    b = torch.from_numpy(np.stack([device.pad_bytes(raw[i:i + chunk], chunk)
                                   for i in (0, chunk - 10)]))
    got = decode_rows_streams(b, n_valid=torch.tensor([chunk, chunk]))
    for a, w in zip(got, decode_rows_streams(b)):
        assert torch.equal(a, w)


def state_storage(s):
    """(field path, data_ptr) of every state tensor, paths state included."""
    out = []
    for f in sd.dataclasses.fields(s._state):
        x = getattr(s._state, f.name)
        if isinstance(x, torch.Tensor):
            out.append((f.name, x.data_ptr()))
        elif x is not None:
            out += [(f"paths.{i}", t.data_ptr()) for i, t in enumerate(sd._leaves(x))]
    return out


@pytest.mark.parametrize("kind", ["fixed_ring", "growing_ring", "no_ring", "paths"])
def test_stream_state_keeps_its_storage_and_equals_jax(raw, kind, tmp_path):
    """Every state tensor keeps its storage across windows (the emit ring
    apart from a growth), and the stream equals JAX's on the same bytes
    (the paths stream against JAX's in ``tests/test_torch_streaming.py``)."""
    stream = np.concatenate([raw] * 8)
    chunk = 1 << 12
    kw = {"fixed_ring": dict(collect_filtered=True, emit_capacity=1 << 16),
          "growing_ring": dict(collect_filtered=True), "no_ring": {}}.get(kind)
    if kind == "paths":
        from slam_process_tpu_torch.utils.synthetic import write_angle_table

        spec = sd.make_paths_spec(write_angle_table(tmp_path / "angles.xlsx"), s_step=8,
                                  grid_res=2.0)
        s = sd.DeviceStreamingSession(chunk_bytes=chunk, device="cpu", collect_paths=spec)
    else:
        s = sd.DeviceStreamingSession(chunk_bytes=chunk, device="cpu", **kw)
    if kind == "growing_ring":
        s._ecap = 1 << 10                 # a small ring, so that it must grow
        s._state.emit_buf = torch.zeros((s._ecap, 4), dtype=torch.int32)
    before = state_storage(s)
    window = s._window.data_ptr()
    for off in range(0, len(stream), 3_000):
        s.feed(stream[off:off + 3_000])
        for (name, a), (_, b) in zip(before, state_storage(s)):
            assert a == b or (name == "emit_buf" and kind == "growing_ring"), name
        assert s._window.data_ptr() == window
    s.finalize()
    assert s.n_kept > 1 << 10
    if kind == "growing_ring":
        assert dict(state_storage(s))["emit_buf"] != dict(before)["emit_buf"]
    if kind == "paths":
        assert s.n_sweeps_closed == 8 * SESSION["n_groups"]
        return

    js = jax_sd.DeviceStreamingSession(chunk_bytes=chunk, **kw)
    for off in range(0, len(stream), 3_000):
        js.feed(stream[off:off + 3_000])
    js.finalize()
    for name in ("n_frames", "n_kept", "n_groups", "overflow"):
        assert getattr(s, name) == getattr(js, name), name
    if kw:
        np.testing.assert_array_equal(s.filtered, js.filtered)
    a, b = s.intensity(), js.intensity()
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.mean, b.mean)
