"""The device stride-3 tokenizer (``ops/tokenize.py``) and the text path
(``pipeline/device.run_session_from_text``) on the CPU, against the
reference tokenizer and the JAX package.

The cases of ``tests/test_tokenize.py`` on synthetic text: a shipped-layout
log takes the device path and equals the reference; tails of rem 0, 1 and
2; ``0x`` tokens, double spaces, mid-stream junk, junk-only and empty
streams, a junk head past the scan window and a run the window cuts take
the host fallback with equal bytes; a fuzz of regular streams.  Then
``tokenize_stride3`` against JAX's ``tokenize_stride3_jax`` on the same
text (its 384-multiple MXU layout and its small-shape branch), and
``run_session_from_text`` against the port's byte path (every field
exactly, the raster bit-equal) and against JAX's ``run_session_from_text``
/ ``session_pipeline_from_text`` (integer fields and grids exactly, the
pre-log means within ``tests/test_scene.py``'s rtol 3e-5 / atol 3e-4,
norm_t within 1e-3).
"""

import numpy as np
import pytest
import torch

from slam_process_tpu_torch.io.hexlog import tokenize_hex_reference
from slam_process_tpu_torch.ops.tokenize import (
    TEXT_PAD, prepare_text, stride3_offset, text_bucket, tokenize_device, tokenize_stride3)
from slam_process_tpu_torch.pipeline.device import (
    run_session_from_text, run_session_on_device, session_pipeline_from_text)
from slam_process_tpu_torch.utils.synthetic import synthetic_session_bytes, to_hex_text


def assert_equiv(data: bytes, expect_device: bool):
    got, used_device = tokenize_device(data, device="cpu")
    assert used_device == expect_device
    np.testing.assert_array_equal(got, tokenize_hex_reference(data))


def test_shipped_layout_log_takes_the_device_path():
    raw = synthetic_session_bytes(n_groups=2, frames_per_beam=2, seed=1)
    got, used_device = tokenize_device(to_hex_text(raw, "shipped"), device="cpu")
    assert used_device, "the shipped layout is stride-3 regular"
    np.testing.assert_array_equal(got, raw)
    # Every line break of the CRLF layout breaks the stride.
    got, used_device = tokenize_device(to_hex_text(raw, "crlf"), device="cpu")
    assert not used_device
    np.testing.assert_array_equal(got, raw)


@pytest.mark.parametrize("data,expect_device", [
    ("\xab ".encode("utf-8") + b"33 00 FF 74 5C", True),     # the shipped junk prefix
    (b"33 00 FF", True),          # rem == 2: no trailing separator
    (b"33 00 FF ", True),         # rem == 0
    (b"33 00 FF 7", True),        # rem == 1: the lone-char token is skipped
    (b"33 00 FF \n", True),       # newline separator, then the pad
    (b"33 00 0x41 74", False),    # a 4-char token mid-stream
    (b"0x33 00 FF", False),       # ... and at the head
    (b"33 00  FF 74", False),     # a double space
    (b"33 00 ZZ 74 5C", False),   # mid-stream junk
    (b"33 00 F 74 5C", False),
    (b"33 00 FF1 74", False),
    (b"", False),                 # empty
    (b"zz yy \xc2\xab", False),   # junk only
    (b"z" * 5000 + b" 33 00 FF", False),           # first token past the scan window
    (b"z" * 4095 + b"33" + b"3 " + b"41 42", False),  # a run the scan window cuts
], ids=lambda x: repr(x)[:40] if isinstance(x, bytes) else str(x))
def test_stride_cases_match_reference(data, expect_device):
    assert_equiv(data, expect_device)


def test_scan_window_edges():
    assert stride3_offset(b"z" * 5000 + b" 33 00 FF") is None
    assert stride3_offset(b"z" * 4095 + b"333 41 42") is None
    assert stride3_offset("\xab ".encode() + b"33") == 3


def test_fuzz_regular_streams_match_reference():
    rng = np.random.default_rng(0)
    for _ in range(10):
        toks = rng.integers(0, 256, int(rng.integers(1, 300)))
        data = b" ".join(b"%02X" % int(v) for v in toks)
        if rng.integers(2):
            data = "\xab ".encode("utf-8") + data
        if rng.integers(2):
            data += b" "
        assert_equiv(data, True)


def test_prepare_text_and_bucket_invariants():
    data = b"33 00 FF"
    p = stride3_offset(data)
    assert p == 0
    target = text_bucket(len(data))
    assert target % 3 == 0 and target >= len(data)
    text, n_text = prepare_text(data, p, target)
    assert n_text == len(data) and (text[n_text:] == TEXT_PAD).all()
    with pytest.raises(ValueError):
        prepare_text(data, 0, 4)
    with pytest.raises(ValueError):
        text_bucket(10, quantum=4)


def test_padding_tokens_are_zero():
    data = b"CC 01 C1 41 41 41 41 41 81 81 81 "
    text, n_text = prepare_text(data, 0, 66)
    b, n_tok, regular = tokenize_stride3(torch.from_numpy(text), n_text)
    assert bool(regular) and int(n_tok) == 11 and b.dtype == torch.uint8
    np.testing.assert_array_equal(b[:11].numpy(), tokenize_hex_reference(data))
    assert not b[11:].any(), "padding must decode to inert non-flag bytes"
    with pytest.raises(ValueError, match="M % 3"):
        tokenize_stride3(torch.from_numpy(text[:65]), n_text)


@pytest.mark.parametrize("m", [66, 384 * 8, 3 << 18])
def test_stride3_matches_jax(m):
    """Both of JAX's layouts (the [M / 384, 384] MXU form where 384 divides
    M, the [M / 3, 3] form otherwise) against the port's, on regular text,
    text with junk (the flag) and a random byte soup."""
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.ops.tokenize import tokenize_stride3_jax

    rng = np.random.default_rng(m)
    n = min(m, 3000)
    regular = to_hex_text(rng.integers(0, 256, n // 3 - 1).astype(np.uint8), "shipped")[3:]
    soup = rng.integers(0, 256, n).astype(np.uint8).tobytes()
    junk = bytearray(regular)
    junk[len(junk) // 2] = ord("z")
    fn = jax.jit(tokenize_stride3_jax)
    for data in (regular, bytes(junk), soup):
        text, n_text = prepare_text(data, 0, m)
        b, n_tok, reg = tokenize_stride3(torch.from_numpy(text), n_text)
        jb, jn, jr = fn(jnp.asarray(text), jnp.int32(n_text))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        assert int(n_tok) == int(jn) and bool(reg) == bool(jr)
    assert bool(tokenize_stride3(torch.from_numpy(prepare_text(regular, 0, m)[0]),
                                 len(regular))[2])


def assert_outputs_equal(a, b):
    for field in b._fields:
        x, y = getattr(a, field), getattr(b, field)
        if y is None:
            assert x is None, field
            continue
        x, y = torch.as_tensor(np.asarray(x)), torch.as_tensor(np.asarray(y))
        assert x.shape == y.shape, field
        if x.is_floating_point():
            assert torch.equal(torch.isnan(x), torch.isnan(y)), field
            x, y = torch.nan_to_num(x, nan=0.0), torch.nan_to_num(y, nan=0.0)
        assert torch.equal(x, y.to(x.dtype)), field


@pytest.fixture(scope="module")
def session_raw():
    return synthetic_session_bytes(n_groups=4, frames_per_beam=3, baselines_per_group=9,
                                   junk_frac=0.05, seed=6)


def test_text_path_equals_byte_path(session_raw):
    text = to_hex_text(session_raw, "shipped")
    res = run_session_from_text(text, device="cpu")
    assert bool(res.tokenize_regular) and int(res.n_tokens) == len(session_raw)
    assert_outputs_equal(res.out, run_session_on_device(session_raw, device="cpu"))
    res = run_session_from_text(text, device="cpu", log_transform_scene=True)
    assert_outputs_equal(res.out, run_session_on_device(session_raw, device="cpu",
                                                        log_transform_scene=True))


def test_irregular_text_takes_the_fallback(session_raw, monkeypatch):
    """The CRLF layout: the flag is False, the host tokenizer reruns the
    session, and every output equals the byte path's.  ``check=False``
    leaves the flag for the caller."""
    import slam_process_tpu_torch.io.hexlog as hexlog

    calls = []
    real = hexlog.tokenize_hex
    monkeypatch.setattr(hexlog, "tokenize_hex", lambda d: calls.append(len(d)) or real(d))
    text = to_hex_text(session_raw, "crlf")
    res = run_session_from_text(text, device="cpu")
    assert not bool(res.tokenize_regular) and len(calls) == 1
    assert int(res.n_tokens) == len(session_raw)
    assert_outputs_equal(res.out, run_session_on_device(session_raw, device="cpu"))
    unchecked = run_session_from_text(text, device="cpu", check=False)
    assert not bool(unchecked.tokenize_regular) and len(calls) == 1


def test_text_path_matches_jax(session_raw):
    from slam_process_tpu.pipeline.device import run_session_from_text as jax_from_text

    for layout in ("shipped", "crlf"):
        text = to_hex_text(session_raw, layout)
        want = jax_from_text(text)
        got = run_session_from_text(text, device="cpu")
        assert bool(got.tokenize_regular) == bool(want.tokenize_regular) == (layout == "shipped")
        assert int(got.n_tokens) == int(want.n_tokens)
        for field in ("frames", "frame_valid", "n_frames", "corrected_bs", "keep", "n_kept",
                      "counts", "correct_overflow"):
            np.testing.assert_array_equal(getattr(got.out, field).numpy(),
                                          np.asarray(getattr(want.out, field)), err_msg=field)
        np.testing.assert_array_equal(got.out.mean_grid.numpy(), np.asarray(want.out.mean_grid))
        np.testing.assert_allclose(got.out.norm_t.numpy(), np.asarray(want.out.norm_t),
                                   atol=1e-3, equal_nan=True)


def test_session_pipeline_from_text_matches_jax(session_raw):
    """The fused bodies on one padded text tensor (JAX's jitted body, the
    port's on CPU tensors)."""
    import functools

    import jax
    import jax.numpy as jnp

    from slam_process_tpu.ops.decode import frame_capacity
    from slam_process_tpu.ops.raster import colormap_lut as jax_lut
    from slam_process_tpu.pipeline.device import (
        session_pipeline_from_text as jax_pipeline_from_text)
    from slam_process_tpu_torch.ops.raster import colormap_lut

    data = to_hex_text(session_raw, "shipped")
    p = stride3_offset(data)
    text, n_text = prepare_text(data, p, text_bucket(len(data) - p))
    fn = jax.jit(functools.partial(jax_pipeline_from_text, capacity=frame_capacity(
        len(text) // 3), log_transform_scene=True))
    want = fn(jnp.asarray(text), jnp.int32(n_text), jnp.asarray(jax_lut("viridis")))
    got = session_pipeline_from_text(torch.from_numpy(text), n_text,
                                     torch.from_numpy(colormap_lut("viridis")),
                                     log_transform_scene=True)
    assert bool(got.tokenize_regular) and bool(want.tokenize_regular)
    for field in ("frames", "frame_valid", "n_frames", "corrected_bs", "keep", "counts"):
        np.testing.assert_array_equal(getattr(got.out, field).numpy(),
                                      np.asarray(getattr(want.out, field)), err_msg=field)
    # Pre-log means: JAX sums float32 logs, the port float64 (tests/test_scene.py's
    # tolerance between the two).
    np.testing.assert_allclose(got.out.mean_grid.numpy(), np.asarray(want.out.mean_grid),
                               rtol=3e-5, atol=3e-4, equal_nan=True)
