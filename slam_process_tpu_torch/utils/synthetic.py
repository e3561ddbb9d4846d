"""Seeded synthetic capture sessions in the 11-byte v3 wire format.

The logic follows the JAX package's ``__graft_entry__._synthetic_log_bytes``
(copied, not imported): sweep groups of 64 UE beams, FLAG=0 frames with
the BS=0x3F placeholder, CLK advancing one beam cycle (61,000 ticks, with
jitter) per frame, and FLAG=1 baseline frames that repeat the previous
row's RSS and carry the true BS beam.  Beyond that generator it adds:

  * junk bytes between frames (never a flag byte 0xCC/0x33, so the set of
    valid frames is exactly the set written), exercising the resync;
  * an exact count of baselines per group;
  * one oversized group (``big_group`` frames, e.g. > 4,096);
  * ``to_hex_text``, the serial-log text form that ``read_hex_log`` reads.

All randomness comes from ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import numpy as np

CYCLE = 61_000
_JUNK = np.setdiff1d(np.arange(256), [0x33, 0xCC]).astype(np.uint8)


def synthetic_session_bytes(n_groups: int = 4, frames_per_beam: int = 2,
                            baselines_per_group: int = 4,
                            junk_frac: float = 0.05, big_group: int = 0,
                            seed: int = 0) -> np.ndarray:
    """One session as a uint8 byte stream.

    ``n_groups`` sweep groups of 64 beams x ``frames_per_beam`` frames;
    when ``big_group`` > 0 the first group instead holds 64 x
    ceil(big_group / 64) frames.  Every group holds exactly
    ``baselines_per_group`` baseline frames, at odd in-group positions so
    each follows a FLAG=0 row of its own group.  After each frame, with
    probability ``junk_frac``, 1-12 junk bytes follow.
    """
    rng = np.random.default_rng(seed)
    per_beam = np.full(n_groups, frames_per_beam, dtype=np.int64)
    if big_group > 0:
        per_beam[0] = -(-big_group // 64)
    sizes = 64 * per_beam
    if baselines_per_group > int(sizes.min()) // 2:
        raise ValueError(f"{baselines_per_group} baselines do not fit a group "
                         f"of {int(sizes.min())} frames")

    ue = np.concatenate([np.repeat(np.arange(64), k) for k in per_beam])
    n = ue.size
    flag = np.zeros(n, dtype=bool)
    start = 0
    for size in sizes:
        odd = np.arange(1, size, 2)
        flag[start + rng.choice(odd, baselines_per_group, replace=False)] = True
        start += size

    clk = 1_000_000 + np.cumsum(CYCLE + rng.integers(-200, 200, n))
    rss = rng.integers(1, 1 << 18, n)
    rss[flag] = rss[np.nonzero(flag)[0] - 1]          # baseline repeats RSS
    bs = np.where(flag, (7 + clk // CYCLE) % 64, 0x3F)

    frames = np.empty((n, 11), dtype=np.uint8)
    frames[:, 0] = np.where(flag, 0xCC, 0x33)
    frames[:, 1] = ue & 0x3F
    frames[:, 2] = 0xC0 | (bs & 0x3F)
    for k in range(5):
        frames[:, 3 + k] = 0x40 | ((clk >> (6 * k)) & 0x3F)
    for k in range(3):
        frames[:, 8 + k] = 0x80 | ((rss >> (6 * k)) & 0x3F)

    junk = np.where(rng.random(n) < junk_frac, rng.integers(1, 13, n), 0)
    head = 2                                          # a leading non-frame marker
    offsets = head + np.concatenate([[0], np.cumsum(11 + junk)[:-1]])
    out = rng.choice(_JUNK, int(head + 11 * n + junk.sum()))
    out[offsets[:, None] + np.arange(11)] = frames
    return out


def to_hex_text(b: np.ndarray) -> bytes:
    """Serial-log text: upper-case hex pairs, space separated, CRLF after
    every 16 tokens, behind a leading non-token marker (as shipped logs)."""
    b = np.asarray(b, dtype=np.uint8)
    digits = np.frombuffer(b"0123456789ABCDEF", dtype=np.uint8)
    tok = np.empty((b.size, 3), dtype=np.uint8)
    tok[:, 0] = digits[b >> 4]
    tok[:, 1] = digits[b & 0xF]
    tok[:, 2] = ord(" ")
    lines = []
    for i in range(0, b.size, 16):
        lines.append(tok[i:i + 16].tobytes() + b"\r\n")
    return "« ".encode() + b"".join(lines)
