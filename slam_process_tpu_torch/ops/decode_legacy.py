"""Decoders of the two older wire formats (generations 1 and 2).

A copy of ``slam_process_tpu/ops/decode_legacy.py``, numpy on the host as
there (neither package has a device form):

  * v1, 5-byte frames: [UE 01xxxxxx][BS 00xxxxxx, or 11xxxxxx -> the
    sentinel 65][RSS x3 10xxxxxx -> 18-bit (hi << 12) | (mid << 6) | lo].
    There is no flag byte: a frame is attempted at every byte, and every
    failed attempt the cursor visits counts one discard.
  * v2, 6-byte frames: a leading FLAG byte 0xCC -> 1 / 0x33 -> 0, then UE,
    BS (valid iff 0xFF or 00xxxxxx) and RSS x3.

No two valid starts are closer than a frame's length in either layout
(each interior offset's tag class excludes a start), so the sequential
cursor emits exactly the positions whose window is valid.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class LegacyDecodeResult(NamedTuple):
    frames: np.ndarray   # v1: [F, 3] (ue, bs, rss); v2: [F, 4] (flag, ue, bs, rss)
    valid: int
    discarded: int
    windows: np.ndarray = np.zeros((0, 0), np.int64)  # the frames' raw bytes


def _shift_eq(top: np.ndarray, d: int, tag: int) -> np.ndarray:
    n = len(top)
    m = max(n - d, 0)
    out = np.zeros(n, dtype=bool)
    out[:m] = top[d:d + m] == tag
    return out


def _visited_mask(n: int, starts: np.ndarray, frame_len: int) -> np.ndarray:
    cov = np.zeros(n + 1, dtype=np.int32)
    if starts.size:
        cov[starts] += 1
        cov[np.minimum(starts + frame_len, n)] -= 1
    return np.cumsum(cov[:n]) == 0


def _windows(b: np.ndarray, starts: np.ndarray, frame_len: int) -> np.ndarray:
    if not starts.size:
        return np.zeros((0, frame_len), np.int64)
    return b[starts[:, None] + np.arange(frame_len)].astype(np.int64)


def decode_frames_v1_np(b: np.ndarray) -> LegacyDecodeResult:
    """5-byte format; a BS byte tagged 11 decodes to the sentinel 65."""
    b = np.asarray(b, dtype=np.uint8)
    n = len(b)
    top = (b >> 6).astype(np.uint8)
    ok = top == 0b01
    ok &= _shift_eq(top, 1, 0b00) | _shift_eq(top, 1, 0b11)
    for d in (2, 3, 4):
        ok &= _shift_eq(top, d, 0b10)
    # Starts only at i <= n - 5.
    if n >= 5:
        ok[n - 4:] = False
    else:
        ok[:] = False
    starts = np.nonzero(ok)[0]
    w = _windows(b, starts, 5)
    ue = w[:, 0] & 0x3F
    bs = np.where((w[:, 1] >> 6) == 0b11, 65, w[:, 1] & 0x3F)
    rss = (w[:, 2] & 0x3F) | ((w[:, 3] & 0x3F) << 6) | ((w[:, 4] & 0x3F) << 12)
    discarded = int(np.count_nonzero(_visited_mask(n, starts, 5) & ~ok))
    return LegacyDecodeResult(np.stack([ue, bs, rss], axis=1), len(starts), discarded, w)


def decode_frames_v2_np(b: np.ndarray) -> LegacyDecodeResult:
    """6-byte format with a FLAG byte; BS valid iff 0xFF or 00xxxxxx."""
    b = np.asarray(b, dtype=np.uint8)
    n = len(b)
    top = (b >> 6).astype(np.uint8)
    ok = (b == 0xCC) | (b == 0x33)
    ok &= _shift_eq(top, 1, 0b01)
    bs_ok = np.zeros(n, dtype=bool)
    m = max(n - 2, 0)
    bs_ok[:m] = (b[2:2 + m] == 0xFF) | (top[2:2 + m] == 0b00)
    ok &= bs_ok
    for d in (3, 4, 5):
        ok &= _shift_eq(top, d, 0b10)
    if n >= 6:
        ok[n - 5:] = False
    else:
        ok[:] = False
    starts = np.nonzero(ok)[0]
    w = _windows(b, starts, 6)
    flag = (w[:, 0] == 0xCC).astype(np.int64)
    ue = w[:, 1] & 0x3F
    bs = w[:, 2] & 0x3F
    rss = (w[:, 3] & 0x3F) | ((w[:, 4] & 0x3F) << 6) | ((w[:, 5] & 0x3F) << 12)
    discarded = int(np.count_nonzero(_visited_mask(n, starts, 6) & ~ok))
    return LegacyDecodeResult(np.stack([flag, ue, bs, rss], axis=1), len(starts), discarded,
                              w)


# The legacy exports' Excel layouts.
V1_COLUMNS = ["UE_Beam原始16进制值", "UE_Beam[5:0]十进制",
              "BS_Beam原始16进制值", "BS_Beam[5:0]十进制",
              "RSS0原始16进制值", "RSS1原始16进制值", "RSS2原始16进制值",
              "RSS十进制"]
V2_COLUMNS = ["FLAG", "UE_Beam[5:0]十进制", "BS_Beam[5:0]十进制", "RSS十进制",
              "UE_Beam原始16进制值", "BS_Beam原始16进制值",
              "RSS0原始16进制值", "RSS1原始16进制值", "RSS2原始16进制值"]


def to_hex(v: int) -> str:
    """A raw byte as the legacy exports write it: 0x followed by two
    upper-case hex digits."""
    return f"0x{v:02X}"
