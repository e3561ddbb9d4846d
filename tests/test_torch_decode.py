"""Port decode (slam_process_tpu_torch) == the JAX package's decoders.

The same seeded bytes go through both packages: ``decode_rows`` against
``decode_rows_jax`` (rows, valid, count exactly, with and without
``n_valid``; also on the edge inputs of ``utils/synthetic.decode_edge_cases``,
the contract kernel K1 is held to on the card), ``decode_frames`` against
``decode_frames_np`` and the Pallas kernel in interpret mode, and
``tokenize_hex`` against the JAX package's tokenizer.  Port tensors stay on the CPU, where the plain versions run.
"""

import numpy as np
import pytest
import torch

from slam_process_tpu.io.hexlog import tokenize_hex as jax_tokenize_hex
from slam_process_tpu.ops.decode import decode_frames_np, decode_rows_jax
from slam_process_tpu.ops.pallas_decode import decode_frames_pallas
from slam_process_tpu_torch.io import read_hex_log, tokenize_hex
from slam_process_tpu_torch.ops.decode import decode_frames, decode_rows, frame_capacity
from slam_process_tpu_torch.utils.synthetic import (
    decode_edge_cases, synthetic_session_bytes, to_hex_text, with_flag_junk)


def junk_heavy_bytes(seed: int) -> np.ndarray:
    """Synthetic session with junk after most frames, plus a tail of noise
    and a frame cut short at the end."""
    rng = np.random.default_rng(seed)
    raw = synthetic_session_bytes(n_groups=2, frames_per_beam=2, baselines_per_group=4,
                                  junk_frac=0.7, seed=seed)
    noise = rng.integers(0, 256, 300).astype(np.uint8)
    return np.concatenate([raw, noise, raw[2:9]])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cut", [None, 0, 37, 400])
def test_decode_rows_matches_jax(seed, cut):
    import jax.numpy as jnp

    raw = junk_heavy_bytes(seed)
    n_valid = None if cut is None else len(raw) - cut
    want = decode_rows_jax(jnp.asarray(raw),
                           n_valid=None if n_valid is None else jnp.int32(n_valid))
    got = decode_rows(torch.from_numpy(raw), n_valid=n_valid)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert got[2].dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2]) > 0


DECODE_EDGES = decode_edge_cases()


@pytest.mark.parametrize("name", sorted(DECODE_EDGES))
def test_decode_rows_edge_cases_match_jax(name):
    """All-flag bytes, back-to-back frames at each offset mod 11, a frame
    ending exactly at n_valid and one byte past it, and N at the edges of
    the kernel's row blocks: rows, valid and count equal JAX's, and the
    count equals the host engine's frames inside n_valid."""
    import jax.numpy as jnp

    raw, n_valid = DECODE_EDGES[name]
    got = decode_rows(torch.from_numpy(raw), n_valid=n_valid)
    want = decode_rows_jax(jnp.asarray(raw),
                           n_valid=None if n_valid is None else jnp.int32(n_valid))
    assert got[0].shape == (-(-len(raw) // 11), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    inside = raw if n_valid is None else raw[:n_valid]
    assert int(got[2]) == decode_frames_np(inside).valid == int(got[1].sum())
    if name.startswith("back_to_back"):
        assert int(got[2]) == 128
    if name == "frame_ends_at_n_valid":
        assert int(got[2]) == 21
    if name == "frame_one_byte_past_n_valid":
        assert int(got[2]) == 20


@pytest.mark.parametrize("seed", [3, 4])
def test_decode_frames_matches_np_and_pallas(seed):
    raw = junk_heavy_bytes(seed)
    cap = frame_capacity(len(raw))
    frames, count = decode_frames(torch.from_numpy(raw), cap)
    ref = decode_frames_np(raw)
    assert int(count) == ref.valid
    np.testing.assert_array_equal(frames[:ref.valid].numpy(), ref.frames)
    assert not frames[ref.valid:].any()
    p_frames, p_count = decode_frames_pallas(raw, cap, rows_per_chunk=8, interpret=True)
    assert int(p_count) == int(count)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(p_frames))


def test_decode_tiny_and_empty_streams():
    for raw in (np.zeros(0, np.uint8), np.asarray([0xCC, 0x00, 0xC1], np.uint8)):
        rows, valid, count = decode_rows(torch.from_numpy(raw))
        assert rows.shape == (-(-len(raw) // 11), 5) and int(count) == 0
        assert not valid.any()


def test_decode_rejects_non_bytes():
    with pytest.raises(ValueError):
        decode_rows(torch.zeros(22, dtype=torch.int32))


def irregular_hex_text(seed: int) -> bytes:
    """Hex text with every token shape the tokenizer must accept or skip."""
    rng = np.random.default_rng(seed)
    vocab = ["3f", "A0", "0x7e", "0XcC", "zz", "123", "0x1", "g1", "0x", "ff", "0xZZ",
             "«", "00", "0x0a", "Bb"]
    seps = [" ", "  ", "\t", "\r\n", "\n", " \x0b "]
    toks = rng.choice(vocab, 2000)
    parts = [t + seps[i] for t, i in zip(toks, rng.integers(0, len(seps), toks.size))]
    return "".join(parts).encode()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tokenize_hex_matches_jax(seed):
    data = irregular_hex_text(seed)
    np.testing.assert_array_equal(tokenize_hex(data), jax_tokenize_hex(data))


def test_read_hex_log_round_trip(tmp_path):
    raw = synthetic_session_bytes(n_groups=2, frames_per_beam=1, baselines_per_group=2,
                                  seed=5)
    path = tmp_path / "session.txt"
    path.write_bytes(to_hex_text(raw))
    np.testing.assert_array_equal(read_hex_log(path), raw)
    np.testing.assert_array_equal(jax_tokenize_hex(path.read_bytes()), raw)


def discard_inputs():
    """{name: (bytes, n_valid, (flag_true, flag_false))} for the discard
    counter: junk-heavy sessions, flag bursts with truncated tails (every
    cut from 0 to 21 bytes), dense random flag bytes, the K1 edge inputs,
    a padded tensor cut by n_valid and flags of another value."""
    out = {f"junk_heavy_{seed}": (junk_heavy_bytes(seed), None, (0xCC, 0x33))
           for seed in (0, 1)}
    base = synthetic_session_bytes(n_groups=2, frames_per_beam=1, baselines_per_group=3,
                                   junk_frac=0.2, seed=5)
    for cut in range(22):
        out[f"flag_bursts_cut_{cut}"] = (with_flag_junk(base, 15, cut, seed=cut), None,
                                         (0xCC, 0x33))
    rng = np.random.default_rng(9)
    alphabet = np.array([0xCC, 0x33, 0x05, 0xC1, 0x41, 0x81, 0x13], np.uint8)
    for i in range(6):
        out[f"dense_flags_{i}"] = (rng.choice(alphabet, int(rng.integers(0, 400))), None,
                                   (0xCC, 0x33))
    for name, (raw, n_valid) in DECODE_EDGES.items():
        out[f"edge_{name}"] = (raw, n_valid, (0xCC, 0x33))
    padded = np.concatenate([out["flag_bursts_cut_7"][0], np.zeros(300, np.uint8)])
    out["padded_n_valid"] = (padded, len(out["flag_bursts_cut_7"][0]), (0xCC, 0x33))
    other = base.copy()
    other[base == 0xCC], other[base == 0x33] = 0xC3, 0x3C
    out["other_flags"] = (with_flag_junk(other, 20, 5, seed=2, flags=(0xC3, 0x3C)), None,
                          (0xC3, 0x3C))
    return out


DISCARD_INPUTS = discard_inputs()


@pytest.mark.parametrize("name", sorted(DISCARD_INPUTS))
def test_discard_count_matches_jax_host_decoder(name):
    """``discard_count`` from the masked rows equals the reference's
    counter as JAX's host decoder keeps it, on ``b[:n_valid]``."""
    from slam_process_tpu import config as jax_config
    from slam_process_tpu_torch.config import DecodeConfig
    from slam_process_tpu_torch.ops.decode import discard_count

    raw, n_valid, (ft, ff) = DISCARD_INPUTS[name]
    cfg = DecodeConfig(flag_true=ft, flag_false=ff)
    b = torch.from_numpy(np.ascontiguousarray(raw))
    rows, valid, _ = decode_rows(b, cfg, n_valid)
    got = discard_count(b, rows, valid, cfg, n_valid)
    head = raw if n_valid is None else raw[:n_valid]
    want = decode_frames_np(head, jax_config.DecodeConfig(flag_true=ft, flag_false=ff))
    assert got.dtype == torch.int32 and int(got) == want.discarded

