"""The on-device session pipeline: bytes -> frames -> filtered ->
intensity -> raster, on one device.

The host work is file I/O and hex tokenization; everything from the byte
tensor onward runs on the device: kernel K1 decodes, kernel K2 gives the
corrector's verdicts, kernel K3 rasterizes, and plain PyTorch integer code
joins them.  The counterpart of ``slam_process_tpu/pipeline/device.py``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from slam_process_tpu_torch.config import CorrectConfig, DecodeConfig, SceneConfig
from slam_process_tpu_torch.ops.correct import correct_rows
from slam_process_tpu_torch.ops.decode import decode_rows, discard_count
from slam_process_tpu_torch.ops.raster import colormap_lut, rasterize_tiles
from slam_process_tpu_torch.ops.scene import fill_grid, intensity_grid


class DeviceSessionOut(NamedTuple):
    frames: torch.Tensor            # [R, 5] i32 masked-row layout (see below)
    frame_valid: torch.Tensor       # [R] bool: which rows hold real frames
    n_frames: torch.Tensor          # scalar i32 (== frame_valid.sum())
    n_discarded: Optional[torch.Tensor]  # scalar i32, the reference's discard
                                         # counter, where asked for; else None
    corrected_bs: torch.Tensor      # [R] i32
    keep: torch.Tensor              # [R] bool
    correct_overflow: torch.Tensor  # scalar bool: static bounds exceeded
    n_kept: torch.Tensor            # scalar i32
    mean_grid: torch.Tensor         # [64, 64] f32 UE-major (NaN empty)
    counts: torch.Tensor            # [64, 64] i32
    rgba: torch.Tensor              # [64, 64, 4] f32 AoD x AoA raster
    blurred: torch.Tensor           # [64, 64] f32
    norm_t: torch.Tensor            # [64, 64] f32 normalized (pre-colormap) raster

    # Masked-row layout: row r carries the frame whose start byte lies in
    # block [11r, 11r + 11) if any (frame_valid[r]); frames appear in stream
    # order with gaps.  Hosts compact with frames[frame_valid].


def session_pipeline(
    byte_tensor: torch.Tensor,   # [N] uint8, padded with non-flag bytes
    lut: torch.Tensor,           # [256, 4] f32 colormap LUT, same device
    *,
    blur_sigma: float = 1.0,
    use_log: bool = True,
    max_groups: int = 256,
    max_baselines_per_group: int = 256,
    decode_cfg: DecodeConfig = DecodeConfig(),
    correct_cfg: CorrectConfig = CorrectConfig(),
    discards_in: Optional[int] = None,
) -> DeviceSessionOut:
    """Full per-session pipeline on ``byte_tensor``'s device.

    Pad the byte tensor with 0x00 (never a flag byte), so padded regions
    decode to nothing.  With ``discards_in`` (the length before the
    padding, which the truncated-tail rule reads) the decoder's discard
    counter is counted too; it costs ~30 small device operations, which
    only ``cli decode`` asks for.
    """
    frames, valid, count = decode_rows(byte_tensor, cfg=decode_cfg)
    discarded = (None if discards_in is None
                 else discard_count(byte_tensor, frames, valid, decode_cfg, discards_in))
    corrected_bs, keep, overflow = correct_rows(
        frames, valid, max_groups=max_groups,
        max_baselines_per_group=max_baselines_per_group, cfg=correct_cfg)

    scene_cfg = SceneConfig(keep_nan=True, fill_with_min=False)
    grid = intensity_grid(frames[:, 1], corrected_bs, frames[:, 3], keep, cfg=scene_cfg)
    # Raster in AoD x AoA orientation (BS rows).
    matrix = fill_grid(grid, scene_cfg).T.contiguous()
    rgba, norm_t, blurred = rasterize_tiles(matrix[None], lut, blur_sigma, use_log)
    return DeviceSessionOut(
        frames=frames,
        frame_valid=valid,
        n_frames=count,
        n_discarded=discarded,
        corrected_bs=corrected_bs,
        keep=keep,
        correct_overflow=overflow,
        n_kept=keep.sum(dtype=torch.int32),
        mean_grid=grid.mean,
        counts=grid.counts,
        rgba=rgba[0],
        blurred=blurred[0],
        norm_t=norm_t[0],
    )


def pad_bytes(raw: np.ndarray, target: int) -> np.ndarray:
    """Pad a byte stream to a bucket size with inert (non-flag) bytes."""
    out = np.zeros(target, dtype=np.uint8)
    out[: len(raw)] = raw
    return out


def bucket_size(n: int, quantum: int = 1 << 18) -> int:
    """Round a byte length up to a bucket (the JAX package's buckets)."""
    return ((n + quantum - 1) // quantum) * quantum


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  Never moves to the CPU on its own: with
    no CUDA device a CUDA request raises and names ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the plain PyTorch versions on the host")
    return dev


@functools.lru_cache(maxsize=None)
def device_lut(device: torch.device, name: str = "viridis") -> torch.Tensor:
    """The colormap ``name``'s LUT on ``device``, made and copied once per
    (device, name); callers must not write to the tensor."""
    return torch.from_numpy(colormap_lut(name)).to(device)


def run_session_on_device(raw_bytes: np.ndarray, blur_sigma: float = 1.0,
                          use_log: bool = True, max_groups: int = 256,
                          max_baselines_per_group: int = 256, *, device=None,
                          decode_cfg: DecodeConfig = DecodeConfig(),
                          correct_cfg: CorrectConfig = CorrectConfig(),
                          count_discards: bool = False) -> DeviceSessionOut:
    """Tokenized bytes -> pipeline outputs on ``device`` (None: CUDA);
    ``count_discards`` also counts the decoder's discards."""
    dev = resolve_device(device)
    padded = torch.from_numpy(pad_bytes(raw_bytes, bucket_size(len(raw_bytes)))).to(dev)
    return session_pipeline(padded, device_lut(dev), blur_sigma=blur_sigma, use_log=use_log,
                            max_groups=max_groups,
                            max_baselines_per_group=max_baselines_per_group,
                            decode_cfg=decode_cfg, correct_cfg=correct_cfg,
                            discards_in=len(raw_bytes) if count_discards else None)
