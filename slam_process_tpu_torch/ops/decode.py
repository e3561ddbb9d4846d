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
tensor and runs ``decode_rows_plain`` on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

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
    limit = _limit(n, n_valid)
    ok = (b == cfg.flag_true) | (b == cfg.flag_false)
    pad_top = torch.cat([b >> 6, torch.full((10,), 255, dtype=torch.uint8, device=dev)])
    for d, tag in enumerate(_OFFSET_TAGS, start=1):
        ok &= pad_top[d:d + n] == tag
    ok &= torch.arange(n, device=dev) + cfg.frame_len <= limit

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
