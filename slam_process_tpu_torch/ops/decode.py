"""Data-parallel frame decoder for the 11-byte v3 wire format.

Position p is a frame start iff byte p is a flag (0xCC / 0x33) and the
next ten bytes carry the tag classes UE=00, BS=11, CLK x5=01, RSS x3=10.
Two valid starts are never closer than 11 bytes (the spacing theorem of
``slam_process_tpu/ops/decode.py``), so the reference's greedy cursor
emits exactly the positions whose window is valid, and the block of 11
positions [11r, 11r + 11) holds at most one start.  ``decode_rows`` uses
that to write the masked-row layout: row r holds the frame starting in
block r (FLAG, UE, BS, RSS, CLK as int32) and ``valid[r]`` says whether
there is one.  Frames appear in stream order with gaps.

``decode_rows`` launches kernel K1 (``ops/cuda_decode.py``) on a CUDA
tensor and runs ``decode_rows_plain`` on a CPU tensor.  ``discard_count``
gives the reference's discard counter from the masked rows, on the same
device.

The host engine (``decode_frames_np``, numpy, int64) is a copy of the JAX
package's: the same frames, plus the reference's discard counter.  It is
what ``Session.from_log`` uses with ``engine="host"`` and when the device
corrector's static bounds overflow.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from slam_process_tpu_torch.config import DecodeConfig
from slam_process_tpu_torch.ops import cuda_decode

_DEFAULT = DecodeConfig()

# Tag classes for frame offsets 1..10 (UE, BS, CLK x5, RSS x3).
_OFFSET_TAGS = (0b00, 0b11, 0b01, 0b01, 0b01, 0b01, 0b01, 0b10, 0b10, 0b10)


def _limit(n: int, n_valid: Optional[int]) -> int:
    return n if n_valid is None else min(n, int(n_valid))


def decode_rows_plain(b: torch.Tensor, cfg: DecodeConfig = _DEFAULT,
                      n_valid: Optional[int] = None):
    """Plain PyTorch decode to (rows [R, 5] i32, valid [R] bool, count i32),
    R = ceil(N / 11).  Only frames lying fully inside ``b[:n_valid]`` count.
    """
    n = b.shape[0]
    dev = b.device
    ok = _start_mask(b, cfg, _limit(n, n_valid))
    pad_b = torch.cat([b, torch.zeros(10, dtype=torch.uint8, device=dev)]).to(torch.int32)
    sh = [pad_b[d:d + n] for d in range(11)]
    clk = sh[3] & 0x3F
    for k in range(1, 5):
        clk |= (sh[3 + k] & 0x3F) << (6 * k)
    rss = (sh[8] & 0x3F) | ((sh[9] & 0x3F) << 6) | ((sh[10] & 0x3F) << 12)
    fields = torch.stack([(b == cfg.flag_true).to(torch.int32), sh[1] & 0x3F,
                          sh[2] & 0x3F, rss, clk], dim=1)
    fields *= ok[:, None]

    # <= 1 start per 11-position row: the masked row sum IS the frame.
    r = -(-n // 11)
    pad = r * 11 - n
    fields = torch.cat([fields, fields.new_zeros((pad, 5))]).view(r, 11, 5)
    okr = torch.cat([ok, ok.new_zeros(pad)]).view(r, 11)
    rows = fields.sum(dim=1, dtype=torch.int32)
    return rows, okr.any(dim=1), ok.sum(dtype=torch.int32)


def _start_mask(b: torch.Tensor, cfg: DecodeConfig, limit: int) -> torch.Tensor:
    """ok [N] bool: a frame starts at byte p and ends by ``limit``."""
    n = b.shape[0]
    ok = (b == cfg.flag_true) | (b == cfg.flag_false)
    pad_top = torch.cat([b >> 6, torch.full((10,), 255, dtype=torch.uint8, device=b.device)])
    for d, tag in enumerate(_OFFSET_TAGS, start=1):
        ok &= pad_top[d:d + n] == tag
    return ok & (torch.arange(n, device=b.device) + cfg.frame_len <= limit)


@functools.lru_cache(maxsize=None)
def _offset_tags(device: torch.device) -> torch.Tensor:
    """``_OFFSET_TAGS`` as a uint8 tensor on ``device``, made once."""
    return torch.tensor(_OFFSET_TAGS, dtype=torch.uint8, device=device)


def _interior(rows: torch.Tensor, d: int) -> torch.Tensor:
    """The 6-bit value of frame offset ``d`` (1..10) from the rows' fields:
    UE, BS, CLK's five limbs, RSS's three."""
    if d <= 2:
        return rows[:, d]
    field, k = (rows[:, 4], d - 3) if d <= 7 else (rows[:, 3], d - 8)
    return (field >> (6 * k)) & 0x3F


def discard_count(b: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor,
                  cfg: DecodeConfig = _DEFAULT, n_valid: Optional[int] = None) -> torch.Tensor:
    """The reference's discard counter of ``b[:n_valid]`` (what
    ``decode_frames_np`` gives) from its masked rows, as an int32 scalar
    tensor on ``b``'s device.

    The cursor discards every flag byte it visits, and visits every byte no
    emitted frame covers.  Inside a frame a flag byte can sit only at the
    start or at an interior offset whose tag class is the flag's top two
    bits with the same low six bits (for 0xCC / 0x33: a BS byte 0xCC or a
    UE byte 0x33), which the row's fields give.  So the visited flags are
    the flag bytes less, per frame, 1 plus those interior matches.  The
    truncated tail then counts once: the first visited flag in the last
    ``frame_len - 1`` bytes ends the parse, so the visited flags from there
    on count 1 together.  Those bytes can be covered only by a frame that
    starts in the ``2 frame_len - 1`` bytes before the end, whose windows
    are tested here.
    """
    fl = cfg.frame_len
    n = _limit(b.shape[0], n_valid)
    head = b[:n]
    is_flag = (head == cfg.flag_true) | (head == cfg.flag_false)
    inside = valid.to(torch.int64)
    for d, tag in enumerate(_OFFSET_TAGS, start=1):
        for f in {cfg.flag_true, cfg.flag_false}:
            if f >> 6 == tag:
                inside = inside + (valid & (_interior(rows, d) == (f & 0x3F))).to(torch.int64)
    visited = is_flag.sum(dtype=torch.int64) - inside.sum()

    lo = max(n - 2 * fl + 1, 0)
    tail = max(n - fl + 1, 0)
    tail_flags = is_flag[tail:]
    if n - lo >= fl:
        # Every window fully inside the last 2 fl - 1 bytes; window j covers
        # positions [lo + j, lo + j + fl).
        w = head[lo:].unfold(0, fl, 1)
        ok = ((((w[:, 0] == cfg.flag_true) | (w[:, 0] == cfg.flag_false))
               & ((w[:, 1:] >> 6) == _offset_tags(b.device)).all(dim=1)))
        gap = (torch.arange(tail, n, device=b.device)[None, :] - lo
               - torch.arange(w.shape[0], device=b.device)[:, None])
        tail_flags = tail_flags & ~(ok[:, None] & (gap >= 0) & (gap < fl)).any(dim=0)
    tail_visited = tail_flags.sum(dtype=torch.int64)
    return (visited - tail_visited + (tail_visited > 0).to(torch.int64)).to(torch.int32)


def decode_rows(b: torch.Tensor, cfg: DecodeConfig = _DEFAULT,
                n_valid: Optional[int] = None):
    """Decode a uint8 [N] byte tensor to the masked-row layout.

    Returns (rows [R, 5] i32, valid [R] bool, count i32 scalar tensor);
    the JAX counterpart is ``decode_rows_jax``.  Kernel K1 on a CUDA
    tensor, the plain version on a CPU tensor.
    """
    if cfg.frame_len != 11:
        raise ValueError(f"the v3 wire format has 11-byte frames, got {cfg.frame_len}")
    if b.dtype != torch.uint8 or b.dim() != 1:
        raise ValueError(f"decode needs a uint8 [N] tensor, got {b.dtype} {tuple(b.shape)}")
    if b.is_cuda:
        return cuda_decode.decode_rows_cuda(b.contiguous(), _limit(b.shape[0], n_valid),
                                            cfg.flag_true, cfg.flag_false)
    if b.device.type != "cpu":
        raise ValueError(f"decode runs on CUDA or CPU tensors, got {b.device}")
    return decode_rows_plain(b, cfg, n_valid)


def decode_rows_streams_plain(b: torch.Tensor, cfg: DecodeConfig = _DEFAULT,
                              n_valid: Optional[torch.Tensor] = None):
    """Plain PyTorch stream axis: ``decode_rows_plain`` on each row of the
    uint8 [S, N] tensor (with ``n_valid[s]``), stacked to (rows [S, R, 5],
    valid [S, R], count [S])."""
    outs = [decode_rows_plain(b[i], cfg, None if n_valid is None else int(n_valid[i]))
            for i in range(b.shape[0])]
    r = -(-b.shape[1] // 11)
    if not outs:
        return (b.new_zeros((0, r, 5), dtype=torch.int32), b.new_zeros((0, r), dtype=torch.bool),
                b.new_zeros(0, dtype=torch.int32))
    return tuple(torch.stack(x) for x in zip(*outs))


def decode_rows_streams(b: torch.Tensor, cfg: DecodeConfig = _DEFAULT,
                        n_valid: Optional[torch.Tensor] = None):
    """Decode S byte streams of one width, uint8 [S, N], each to the
    masked-row layout: (rows [S, R, 5] i32, valid [S, R] bool, count [S]
    i32).  ``n_valid`` is None (every byte counts) or an int64 [S] tensor on
    ``b``'s device: only frames inside ``b[s, :n_valid[s]]`` count.  One
    launch of kernel K1 for all S on a CUDA tensor, the plain version per
    stream on a CPU tensor."""
    if cfg.frame_len != 11:
        raise ValueError(f"the v3 wire format has 11-byte frames, got {cfg.frame_len}")
    if b.dtype != torch.uint8 or b.dim() != 2:
        raise ValueError(f"decode needs a uint8 [S, N] tensor, got {b.dtype} {tuple(b.shape)}")
    if b.is_cuda:
        return cuda_decode.decode_rows_streams_cuda(b.contiguous(), n_valid, cfg.flag_true,
                                                    cfg.flag_false)
    if b.device.type != "cpu":
        raise ValueError(f"decode runs on CUDA or CPU tensors, got {b.device}")
    return decode_rows_streams_plain(b, cfg, n_valid)


def decode_frames(b: torch.Tensor, capacity: int, cfg: DecodeConfig = _DEFAULT,
                  n_valid: Optional[int] = None):
    """Densely packed decode: (frames [capacity, 5] i32, count i32).

    The counterpart of ``decode_frames_pallas``: the masked rows compacted
    in stream order; rows past ``count`` are zero, and frames past
    ``capacity`` are dropped (``frame_capacity(N)`` always fits).
    """
    rows, valid, count = decode_rows(b, cfg, n_valid)
    packed = rows[valid][:capacity]
    frames = rows.new_zeros((capacity, 5))
    frames[:packed.shape[0]] = packed
    return frames, count


def frame_capacity(n_bytes: int, cfg: DecodeConfig = _DEFAULT) -> int:
    """Static frame-count upper bound for a byte-stream length."""
    return n_bytes // cfg.frame_len + 1


# ---------------------------------------------------------------------------
# numpy host engine
# ---------------------------------------------------------------------------


def frame_start_mask(b: np.ndarray, cfg: DecodeConfig = _DEFAULT) -> np.ndarray:
    """ok[i] == a frame starts at byte i; positions within 10 bytes of the
    end are always False (a full frame does not fit)."""
    b = np.asarray(b, dtype=np.uint8)
    n = b.shape[0]
    ok = (b == cfg.flag_true) | (b == cfg.flag_false)
    top = (b >> 6).astype(np.uint8)
    for d, tag in enumerate(_OFFSET_TAGS, start=1):
        m = max(n - d, 0)
        shifted = np.zeros(n, dtype=bool)
        shifted[:m] = top[d:d + m] == tag
        ok &= shifted
    return ok


def extract_fields(b: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """frames [F, 5] int64 (FLAG, UE, BS, RSS, CLK) at the start indices:
    CLK from five little-endian 6-bit limbs, RSS from three."""
    b = np.asarray(b, dtype=np.int64)
    w = b[starts[:, None] + np.arange(11)]
    flag = (w[:, 0] == _DEFAULT.flag_true).astype(np.int64)
    ue = w[:, 1] & 0x3F
    bs = w[:, 2] & 0x3F
    clk = np.zeros(len(starts), dtype=np.int64)
    for k in range(5):
        clk |= (w[:, 3 + k] & 0x3F) << (6 * k)
    rss = (w[:, 8] & 0x3F) | ((w[:, 9] & 0x3F) << 6) | ((w[:, 10] & 0x3F) << 12)
    return np.stack([flag, ue, bs, rss, clk], axis=1)


class DecodeResult(NamedTuple):
    frames: np.ndarray      # [F, 5] int64 (flag, ue, bs, rss, clk)
    valid: int              # == F
    discarded: int          # the reference's discard counter


def decode_frames_np(b: np.ndarray, cfg: DecodeConfig = _DEFAULT) -> DecodeResult:
    """Host decode with the reference's counter semantics.

    The discard counter counts cursor-visited flag bytes that fail the tag
    checks; a visited flag byte within 10 bytes of the end counts once and
    stops the parse.  Visited == not covered by an emitted frame.
    """
    b = np.asarray(b, dtype=np.uint8)
    n = b.shape[0]
    ok = frame_start_mask(b, cfg)
    starts = np.nonzero(ok)[0]
    frames = extract_fields(b, starts) if starts.size else np.zeros((0, 5), np.int64)

    isflag = (b == cfg.flag_true) | (b == cfg.flag_false)
    covered = np.zeros(n + 1, dtype=np.int32)
    if starts.size:
        covered[starts] += 1
        covered[np.minimum(starts + cfg.frame_len, n)] -= 1
    visited = np.cumsum(covered[:n]) == 0
    visited_flags = isflag & visited
    # Truncated tail: the first visited flag with < frame_len bytes left
    # counts one discard and ends the parse.
    tail_lo = max(n - cfg.frame_len + 1, 0)
    tail_hits = np.nonzero(visited_flags[tail_lo:])[0]
    if tail_hits.size:
        break_at = tail_lo + tail_hits[0]
        discarded = int(np.count_nonzero(visited_flags[:break_at] & ~ok[:break_at])) + 1
    else:
        discarded = int(np.count_nonzero(visited_flags & ~ok))
    return DecodeResult(frames, int(starts.size), discarded)
