"""The port's host tokenizers: the native scanner (``runtime/hexscan``),
numpy (``io/hexlog.tokenize_hex``) and the reference regex loop
(``tokenize_hex_reference``) give the same bytes (the reference on valid
UTF-8 without ``0X`` tokens, as ``tests/test_hexlog.py`` holds it), and
equal the JAX package's tokenizers.

Cases of ``tests/test_runtime.py`` on synthetic text: edge cases, random
token streams, long regular streams through the AVX-512 block path
(192-byte blocks) and junk planted at every offset of a block span (the
scalar resync), ``0x`` tokens, junk and empty input; the synthetic logs in
both layouts of ``utils/synthetic.to_hex_text`` and with flag junk.  Also
where the library lands (``build/slam_process_tpu_torch/hexscan-<hash>/``,
never the JAX package's ``build/libhexscan.so``), what its hash covers, and
``read_hex_log``'s engines.
"""

import numpy as np
import pytest

from slam_process_tpu_torch.io import hexlog
from slam_process_tpu_torch.runtime import hexscan
from slam_process_tpu_torch.utils.synthetic import (
    synthetic_session_bytes, to_hex_text, with_flag_junk)

ENGINES = ("native", "numpy", "reference")


def reference_applies(data: bytes) -> bool:
    """The byte-level tokenizers equal the reference's ``decode(errors=
    "ignore")`` + regex path on valid UTF-8 without ``0X`` tokens (the
    reference regex takes a lower-case ``0x`` only), which real logs are."""
    try:
        data.decode("utf-8")
    except UnicodeDecodeError:
        return False
    return b"0X" not in data


def assert_engines_agree(data: bytes, msg=""):
    want = hexlog.tokenize_hex(data)
    np.testing.assert_array_equal(hexlog.tokenize(data, "native"), want, err_msg=msg)
    if reference_applies(data):
        np.testing.assert_array_equal(hexlog.tokenize(data, "reference"), want, err_msg=msg)


EDGE_CASES = [b"", b" ", b"3", b"33", b"0x33 0XAB", b"GG zz 12", b"\xc2\xab 33 00 FF",
              b"ab\ncd\tef  ", b"123 4567 0xZZ 0x1", b"0x", b"0x3", b"0x333", b"x33",
              b"33\x0b44\x0c55\x1c66\x1d77\x1e88\x1f99", b"33\xa044", b"\xff\xfe 41 \xc2\xab42"]


@pytest.mark.parametrize("data", EDGE_CASES, ids=repr)
def test_edge_cases(data):
    assert_engines_agree(data)


def test_0x_tokens_take_either_case():
    for engine in ("native", "numpy"):
        assert hexlog.tokenize(b"0x33 0XAB cc", engine).tolist() == [0x33, 0xAB, 0xCC]
    assert hexlog.tokenize(b"0x33 0XAB cc", "reference").tolist() == [0x33, 0xCC]


def test_random_token_streams():
    rng = np.random.default_rng(40)
    tokens = [b"33", b"ff", b"AB", b"0x7f", b"0X1c", b"0", b"123", b"GG", b"\xc2\xab", b"zz"]
    seps = [b" ", b"\t", b"\n", b"\r\n", b"  "]
    for i in range(10):
        data = b"".join(tokens[rng.integers(len(tokens))] + seps[rng.integers(len(seps))]
                        for _ in range(int(rng.integers(100, 400))))
        assert_engines_agree(data, f"stream {i}")


@pytest.mark.parametrize("n_tok", [64, 65, 640, 641, 1000])
def test_simd_blocks(n_tok):
    """Regular streams of whole 192-byte blocks and odd tails."""
    vals = np.random.default_rng(7 + n_tok).integers(0, 256, n_tok)
    data = b" ".join(b"%02X" % int(v) for v in vals)
    for suffix in (b"", b" ", b"\n"):
        assert_engines_agree(data + suffix, f"suffix {suffix!r}")
        np.testing.assert_array_equal(hexscan.tokenize(data + suffix), vals.astype(np.uint8))


def test_simd_resync_at_every_offset():
    """Junk planted at every offset inside a block span: the block path must
    leave for one token and take up again at the next boundary."""
    rng = np.random.default_rng(7)
    base = b" ".join(b"%02x" % int(v) for v in rng.integers(0, 256, 256)) + b" "
    for pos in range(0, 384):
        for junk in (b"zz ", b"0x41 ", b"1 ", b"  ", b"\xc2\xab ", b"\r\n"):
            data = base[:pos] + junk + base[pos:]
            np.testing.assert_array_equal(hexscan.tokenize(data), hexlog.tokenize_hex(data),
                                          err_msg=f"pos={pos} junk={junk!r}")


@pytest.mark.parametrize("layout", ["shipped", "crlf"])
def test_synthetic_logs_both_layouts(layout):
    raw = synthetic_session_bytes(n_groups=3, frames_per_beam=3, junk_frac=0.1, seed=5)
    for b in (raw, with_flag_junk(raw, seed=5)):
        text = to_hex_text(b, layout)
        assert_engines_agree(text, layout)
        np.testing.assert_array_equal(hexscan.tokenize(text), b)


def test_shipped_layout_is_one_stride3_stream():
    raw = synthetic_session_bytes(n_groups=1, frames_per_beam=1)
    text = to_hex_text(raw, "shipped")
    assert text.startswith("« ".encode()) and b"\n" not in text
    assert len(text) == 3 + 3 * len(raw)
    assert to_hex_text(raw) == to_hex_text(raw, "crlf") and b"\r\n" in to_hex_text(raw)
    with pytest.raises(ValueError, match="layout"):
        to_hex_text(raw, "tsv")


def test_matches_jax_tokenizers():
    from slam_process_tpu.io import hexlog as jax_hexlog
    from slam_process_tpu.runtime import hexscan as jax_hexscan

    raw = synthetic_session_bytes(n_groups=2, frames_per_beam=2, seed=9)
    texts = [to_hex_text(raw, "shipped"), to_hex_text(with_flag_junk(raw, seed=1)),
             b"33 0x41 zz\t7 \xc2\xab 0XfF 123 ab"]
    for text in texts:
        np.testing.assert_array_equal(hexscan.tokenize(text), jax_hexscan.tokenize(text))
        np.testing.assert_array_equal(hexlog.tokenize_hex_reference(text),
                                      jax_hexlog.tokenize_hex_reference(text))


def test_library_lands_under_the_port_build_dir():
    lib = hexscan.library_path()
    assert hexscan.available() and lib.exists()
    assert lib.name == "libhexscan.so"
    assert lib.parent.parent == hexscan.BUILD_ROOT
    assert hexscan.BUILD_ROOT.parts[-2:] == ("build", "slam_process_tpu_torch")
    assert lib.parent.name.startswith("hexscan-")
    assert lib != hexscan.BUILD_ROOT.parent / "libhexscan.so"


def test_library_hash_covers_source_compiler_and_cpu(monkeypatch):
    base = hexscan.library_path()
    monkeypatch.setattr(hexscan, "cpu_identity", lambda: "model name: another CPU")
    assert hexscan.library_path() != base
    monkeypatch.undo()
    monkeypatch.setenv("CC", "another-cc")
    assert hexscan.library_path() != base
    monkeypatch.delenv("CC")
    assert hexscan.library_path() == base
    assert hexscan.cpu_identity()


def test_read_hex_log_engines(tmp_path, monkeypatch):
    raw = synthetic_session_bytes(n_groups=1, frames_per_beam=2, seed=2)
    path = tmp_path / "log.txt"
    path.write_bytes(to_hex_text(raw))
    for engine in ("auto",) + ENGINES:
        np.testing.assert_array_equal(hexlog.read_hex_log(path, engine=engine), raw)
    with pytest.raises(ValueError, match="engine"):
        hexlog.read_hex_log(path, engine="fast")
    # A build that fails: "auto" takes numpy, "native" raises.
    monkeypatch.setattr(hexscan, "_lib", None)
    monkeypatch.setattr(hexscan, "_build_error", None)
    monkeypatch.setattr(hexscan, "library_path", lambda: tmp_path / "none" / "libhexscan.so")
    monkeypatch.setenv("CC", str(tmp_path / "no-such-compiler"))
    np.testing.assert_array_equal(hexlog.read_hex_log(path, engine="auto"), raw)
    with pytest.raises(RuntimeError, match="hexscan build"):
        hexlog.read_hex_log(path, engine="native")
