"""Hex-token serial-log ingestion on the host.

The raw artifact is a text file of whitespace-separated hex byte tokens
("33 00 FF 74 ..."), possibly with junk tokens.  Accepted tokens are
exactly two hex digits, or ``0x``/``0X`` followed by exactly two hex
digits (the reference regex ``^(?:0x)?[0-9a-fA-F]{2}$``); everything else
is skipped.  Three tokenizers give the same bytes:

  * ``tokenize_hex``: one vectorized numpy pass over the raw bytes
    (boundary detection + nibble LUT);
  * the native C scanner (``runtime/hexscan``), the default of
    ``read_hex_log``;
  * ``tokenize_hex_reference``: the reference's per-token regex loop, the
    oracle of the tests.

Copies of ``slam_process_tpu/io/hexlog.py``.  The card's stride-3
tokenizer is ``ops/tokenize.py``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Union

import numpy as np

_HEX_LUT = np.full(256, 255, dtype=np.uint8)
for _c in b"0123456789":
    _HEX_LUT[_c] = _c - ord("0")
for _c in b"abcdef":
    _HEX_LUT[_c] = _c - ord("a") + 10
for _c in b"ABCDEF":
    _HEX_LUT[_c] = _c - ord("A") + 10

# ASCII whitespace as str.split() sees it in real logs.
_WS_LUT = np.zeros(256, dtype=bool)
for _c in b" \t\r\n\x0b\x0c\x1c\x1d\x1e\x1f":
    _WS_LUT[_c] = True

_TOKEN_RE = re.compile(r"^(?:0x)?[0-9a-fA-F]{2}$")
ENGINES = ("auto", "native", "numpy", "reference")


def tokenize_hex(data: bytes) -> np.ndarray:
    """Vectorized hex tokenizer: raw log bytes -> uint8 byte values."""
    if len(data) == 0:
        return np.zeros(0, dtype=np.uint8)
    arr = np.frombuffer(data, dtype=np.uint8)
    is_ws = _WS_LUT[arr]
    nonws = ~is_ws

    prev_ws = np.empty_like(is_ws)
    prev_ws[0] = True
    prev_ws[1:] = is_ws[:-1]
    starts = np.nonzero(nonws & prev_ws)[0]

    next_ws = np.empty_like(is_ws)
    next_ws[-1] = True
    next_ws[:-1] = is_ws[1:]
    ends = np.nonzero(nonws & next_ws)[0]

    lengths = ends - starts + 1
    hexval = _HEX_LUT[arr]

    # Bare two-digit tokens.
    s2 = starts[lengths == 2]
    hi2, lo2 = hexval[s2], hexval[s2 + 1]
    ok2 = (hi2 < 16) & (lo2 < 16)
    pos2, val2 = s2[ok2], (hi2[ok2] << 4) | lo2[ok2]

    # 0x-prefixed four-char tokens.
    s4 = starts[lengths == 4]
    pref = (arr[s4] == ord("0")) & ((arr[s4 + 1] == ord("x")) | (arr[s4 + 1] == ord("X")))
    hi4, lo4 = hexval[s4 + 2], hexval[s4 + 3]
    ok4 = pref & (hi4 < 16) & (lo4 < 16)
    pos4, val4 = s4[ok4], (hi4[ok4] << 4) | lo4[ok4]

    if pos4.size == 0:
        return val2.astype(np.uint8)
    pos = np.concatenate([pos2, pos4])
    val = np.concatenate([val2, val4])
    return val[np.argsort(pos, kind="stable")].astype(np.uint8)


def tokenize_hex_reference(data: bytes) -> np.ndarray:
    """The reference's tokenizer (slow; the tests' oracle): decode UTF-8
    ignoring errors, ``str.split()``, the token regex per token, ``int(s,
    16) & 0xFF``."""
    out = []
    for tok in data.decode("utf-8", errors="ignore").split():
        s = tok.strip()
        if not s or not _TOKEN_RE.fullmatch(s):
            continue
        if s.lower().startswith("0x"):
            s = s[2:]
        out.append(int(s, 16) & 0xFF)
    return np.asarray(out, dtype=np.uint8)


def tokenize(data: bytes, engine: str = "auto") -> np.ndarray:
    """Raw log bytes -> uint8 byte values with ``engine``: "auto" the
    native scanner, or numpy where it does not build; "native" the native
    scanner (a failed build raises); "numpy"; "reference"."""
    if engine not in ENGINES:
        raise ValueError(f"unknown tokenizer engine {engine!r}; use one of {ENGINES}")
    if engine == "reference":
        return tokenize_hex_reference(data)
    if engine in ("auto", "native"):
        from slam_process_tpu_torch.runtime import hexscan

        if engine == "native" or hexscan.available():
            return hexscan.tokenize(data)
    return tokenize_hex(data)


def read_hex_log(path: Union[str, Path], engine: str = "auto") -> np.ndarray:
    """Read a serial hex log file into a uint8 byte array (``tokenize``'s
    engines)."""
    return tokenize(Path(path).read_bytes(), engine)
