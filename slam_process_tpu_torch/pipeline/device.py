"""The on-device session pipeline: bytes -> frames -> filtered ->
intensity -> raster, on one device.

The host work is file I/O and hex tokenization; everything from the byte
tensor onward runs on the device: kernel K1 decodes, kernel K2 gives the
corrector's verdicts, kernel K3 rasterizes, and plain PyTorch integer code
joins them.  The text path (``run_session_from_text``) also tokenizes on
the device: the raw log text is the only host-to-device copy
(``ops/tokenize.tokenize_stride3``), with the host tokenizer where the
text is not stride-3 regular.  The counterpart of
``slam_process_tpu/pipeline/device.py``.

As in the JAX package, the entry points run one compiled program per byte
bucket (``compiled_session_pipeline``, ``compiled_text_session_pipeline``):
on a CUDA device a CUDA graph of the whole body (``utils/graphs.py``), so
no host work is issued between the stages; on the CPU the eager body.
``session_pipeline`` and ``session_pipeline_from_text`` stay the eager
bodies that the graphs are held against.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from slam_process_tpu_torch.config import CorrectConfig, DecodeConfig, SceneConfig
from slam_process_tpu_torch.ops.correct import correct_rows
from slam_process_tpu_torch.ops.decode import decode_rows_streams, discard_count
from slam_process_tpu_torch.ops.raster import colormap_lut, rasterize_tiles
from slam_process_tpu_torch.ops.scene import cell_means, intensity_cell_sums
from slam_process_tpu_torch.ops.tokenize import (
    prepare_text, stride3_offset, text_bucket, tokenize_stride3)
from slam_process_tpu_torch.utils.graphs import FlatOutputs, GraphRunner


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


def session_pipeline_batch(
    byte_batch: torch.Tensor,    # [S, N] uint8, each row padded with non-flag bytes
    lut: torch.Tensor,           # [256, 4] f32 colormap LUT, same device
    *,
    blur_sigma: float = 1.0,
    use_log: bool = True,
    log_transform_scene: bool = False,
    max_groups: int = 256,
    max_baselines_per_group: int = 256,
    decode_cfg: DecodeConfig = DecodeConfig(),
    correct_cfg: CorrectConfig = CorrectConfig(),
) -> DeviceSessionOut:
    """``session_pipeline`` for S sessions of one padded width at once:
    every field with a leading S axis (``n_discarded`` None), one launch of
    K1, K2 and K3 for all S (``ops/correct.py`` offsets the group ids per
    session; the S grids come from one ``index_add_``)."""
    frames, valid, count = decode_rows_streams(byte_batch, decode_cfg)                 # K1
    corrected_bs, keep, overflow = correct_rows(                                        # K2
        frames, valid, max_groups=max_groups,
        max_baselines_per_group=max_baselines_per_group, cfg=correct_cfg)
    scene_cfg = SceneConfig(keep_nan=True, fill_with_min=False,
                            log_transform=log_transform_scene)
    sums, counts = intensity_cell_sums(frames[..., 1], corrected_bs, frames[..., 3], keep,
                                       cfg=scene_cfg)
    mean = cell_means(sums, counts)
    # Rasters in AoD x AoA orientation (BS rows); keep_nan leaves the grid
    # as it is (``fill_grid``).
    rgba, norm_t, blurred = rasterize_tiles(mean.transpose(1, 2).contiguous(), lut,    # K3
                                            blur_sigma, use_log)
    return DeviceSessionOut(
        frames=frames, frame_valid=valid, n_frames=count, n_discarded=None,
        corrected_bs=corrected_bs, keep=keep, correct_overflow=overflow,
        n_kept=keep.sum(dim=1, dtype=torch.int32), mean_grid=mean,
        counts=counts.to(torch.int32), rgba=rgba, blurred=blurred, norm_t=norm_t)


def session_pipeline(
    byte_tensor: torch.Tensor,   # [N] uint8, padded with non-flag bytes
    lut: torch.Tensor,           # [256, 4] f32 colormap LUT, same device
    *,
    discards_in: Optional[int] = None,
    **kw,
) -> DeviceSessionOut:
    """Full per-session pipeline on ``byte_tensor``'s device:
    ``session_pipeline_batch`` at S = 1 (``kw``: its keyword arguments).

    Pad the byte tensor with 0x00 (never a flag byte), so padded regions
    decode to nothing.  ``log_transform_scene`` makes the grid the pre-log
    scene (ln(RSS) means over the rows with RSS > 0, ``ops/scene.py``).
    With ``discards_in`` (the length before the padding, which the
    truncated-tail rule reads) the decoder's discard counter is counted
    too; it costs ~30 small device operations, which only ``cli decode``
    asks for.
    """
    out = DeviceSessionOut(*(None if x is None else x[0]
                             for x in session_pipeline_batch(byte_tensor[None], lut, **kw)))
    if discards_in is None:
        return out
    return out._replace(n_discarded=discard_count(
        byte_tensor, out.frames, out.frame_valid, kw.get("decode_cfg", DecodeConfig()),
        discards_in))


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


class _Program:
    """What ``compiled_session_pipeline`` and
    ``compiled_text_session_pipeline`` return: ``body`` for one static
    shape, called as the JAX package's jitted function is.  On a CUDA
    device the first call captures ``body`` as a CUDA graph (``GraphRunner``)
    and every call replays it; on the CPU each call runs ``body``.  Every
    call returns tensors of its own: on CUDA one clone of the graph's flat
    output buffer (``FlatOutputs``), every field a view of it, which the
    next replay does not overwrite."""

    def __init__(self, body, device: torch.device, n_padded: int):
        self._body = body
        self.device = device
        self.n_padded = n_padded
        self.runner: Optional[GraphRunner] = None
        self._flat = FlatOutputs()

    def __call__(self, *args):
        args = tuple(int(a) if isinstance(a, np.integer) else a for a in args)
        if args[0].shape != (self.n_padded,):
            raise ValueError(f"this program takes [{self.n_padded}] inputs, got "
                             f"{list(args[0].shape)}")
        if self.device.type != "cuda":
            return self._body(*args)
        if self.runner is None:
            body, flat = self._body, self._flat
            self.runner = GraphRunner(
                lambda *xs: flat.pack(body(*xs)),
                [torch.full((), a, dtype=torch.int32, device=args[0].device)
                 if isinstance(a, int) else a for a in args])
        return self._flat.unpack(self.runner(*args).clone())


@functools.lru_cache(maxsize=32)
def compiled_session_pipeline(n_bytes_padded: int, blur_sigma: float = 1.0,
                              use_log: bool = True, max_groups: int = 256,
                              max_baselines_per_group: int = 256, *, device=None,
                              log_transform_scene: bool = False,
                              decode_cfg: DecodeConfig = DecodeConfig(),
                              correct_cfg: CorrectConfig = CorrectConfig()):
    """The session pipeline for one byte bucket on ``device`` (None: CUDA),
    called as ``fn(padded, lut)``: padded uint8 [n_bytes_padded] and the
    [256, 4] LUT on the device, returning a ``DeviceSessionOut``
    (``n_discarded`` None).  On CUDA a CUDA graph, captured at the first
    call (a failed capture raises); on the CPU ``session_pipeline``.  The
    JAX function's jitted program also takes the unpadded length, which it
    does not use.  ``max_groups`` / ``max_baselines_per_group`` are the
    corrector's static bounds (``session_pipeline_batch``).  Cached per
    argument set, 32 at most as in the JAX package; an evicted program's
    graph frees its memory pool."""
    kw = dict(blur_sigma=blur_sigma, use_log=use_log, log_transform_scene=log_transform_scene,
              max_groups=max_groups, max_baselines_per_group=max_baselines_per_group,
              decode_cfg=decode_cfg, correct_cfg=correct_cfg)
    return _Program(lambda padded, lut: session_pipeline(padded, lut, **kw),
                    resolve_device(device), n_bytes_padded)


def run_session_on_device(raw_bytes: np.ndarray, blur_sigma: float = 1.0,
                          use_log: bool = True, max_groups: int = 256,
                          max_baselines_per_group: int = 256, *, device=None,
                          log_transform_scene: bool = False,
                          decode_cfg: DecodeConfig = DecodeConfig(),
                          correct_cfg: CorrectConfig = CorrectConfig(),
                          count_discards: bool = False) -> DeviceSessionOut:
    """Tokenized bytes -> pipeline outputs on ``device`` (None: CUDA),
    through ``compiled_session_pipeline`` of the bytes' bucket;
    ``log_transform_scene`` builds the pre-log grid, ``count_discards``
    also counts the decoder's discards (after the program, eagerly)."""
    dev = resolve_device(device)
    n = bucket_size(len(raw_bytes))
    fn = compiled_session_pipeline(n, blur_sigma, use_log, max_groups, max_baselines_per_group,
                                   device=dev, log_transform_scene=log_transform_scene,
                                   decode_cfg=decode_cfg, correct_cfg=correct_cfg)
    padded = torch.from_numpy(pad_bytes(raw_bytes, n)).to(dev)
    out = fn(padded, device_lut(dev))
    if not count_discards:
        return out
    return out._replace(n_discarded=discard_count(padded, out.frames, out.frame_valid,
                                                  decode_cfg, len(raw_bytes)))


class TextSessionOut(NamedTuple):
    out: DeviceSessionOut
    tokenize_regular: torch.Tensor   # scalar bool: the stride-3 proof flag held
    n_tokens: torch.Tensor           # scalar i32


def session_pipeline_from_text(text_tensor: torch.Tensor, n_text, lut: torch.Tensor,
                               **kw) -> TextSessionOut:
    """Text -> raster on ``text_tensor``'s device: the stride-3 tokenizer,
    then ``session_pipeline`` (``kw``: its keyword arguments).

    ``text_tensor`` is [M] uint8, M % 3 == 0, whitespace-padded, and
    ``n_text`` the body's length (an int, or a 0-d int32 tensor on the
    device, as the compiled program passes it); the caller has established
    ``stride3_offset``'s precondition.  The outputs hold only where
    ``tokenize_regular`` is True; ``run_session_from_text`` reruns through
    the host tokenizer where it is not.  The padding tokens are 0, inert
    bytes, as the byte path's padding is.
    """
    b, n_tok, regular = tokenize_stride3(text_tensor, n_text)
    return TextSessionOut(session_pipeline(b, lut, **kw), regular, n_tok)


@functools.lru_cache(maxsize=32)
def compiled_text_session_pipeline(n_text_padded: int, blur_sigma: float = 1.0,
                                   use_log: bool = True, max_groups: int = 256,
                                   max_baselines_per_group: int = 256, *, device=None,
                                   log_transform_scene: bool = False,
                                   decode_cfg: DecodeConfig = DecodeConfig(),
                                   correct_cfg: CorrectConfig = CorrectConfig()):
    """The text session pipeline for one text bucket, called as ``fn(text,
    n_text, lut)`` (``n_text`` an int or a 0-d int32 device tensor) and
    returning a ``TextSessionOut``: ``compiled_session_pipeline``'s
    counterpart for ``session_pipeline_from_text``.  The graph reads
    ``n_text`` from a device scalar that each call writes, so one graph
    serves every body length of the bucket."""
    kw = dict(blur_sigma=blur_sigma, use_log=use_log, log_transform_scene=log_transform_scene,
              max_groups=max_groups, max_baselines_per_group=max_baselines_per_group,
              decode_cfg=decode_cfg, correct_cfg=correct_cfg)
    return _Program(lambda text, n_text, lut: session_pipeline_from_text(text, n_text, lut, **kw),
                    resolve_device(device), n_text_padded)


def run_session_from_text(data: bytes, blur_sigma: float = 1.0, use_log: bool = True,
                          max_groups: int = 256, max_baselines_per_group: int = 256, *,
                          device=None, check: bool = True, log_transform_scene: bool = False,
                          decode_cfg: DecodeConfig = DecodeConfig(),
                          correct_cfg: CorrectConfig = CorrectConfig()) -> TextSessionOut:
    """Raw log file contents -> pipeline outputs on ``device`` (None:
    CUDA), tokenized on the device by ``compiled_text_session_pipeline``.

    The host scans the head for the body's start (``stride3_offset``) and
    pads one buffer; the text is copied to the device and tokenized there.
    With ``check=True`` (the default) the proof flag is read once (one host
    sync) and an irregular stream reruns through the host tokenizer and
    ``run_session_on_device``: the fallback follows the data, and
    ``tokenize_regular`` is then a False tensor.  ``check=False`` leaves
    the flag on the device for the caller to audit.
    """
    from slam_process_tpu_torch.io.hexlog import tokenize_hex

    dev = resolve_device(device)
    kw = dict(log_transform_scene=log_transform_scene, decode_cfg=decode_cfg,
              correct_cfg=correct_cfg)
    bounds = (blur_sigma, use_log, max_groups, max_baselines_per_group)

    def fallback() -> TextSessionOut:
        raw = tokenize_hex(data)
        out = run_session_on_device(raw, *bounds, device=dev, **kw)
        return TextSessionOut(out, torch.tensor(False, device=dev),
                              torch.tensor(len(raw), dtype=torch.int32, device=dev))

    p = stride3_offset(data)
    if p is None:
        return fallback()
    text, n_text = prepare_text(data, p, text_bucket(len(data) - p))
    fn = compiled_text_session_pipeline(len(text), *bounds, device=dev, **kw)
    res = fn(torch.from_numpy(text).to(dev), n_text, device_lut(dev))
    if check and not bool(res.tokenize_regular):
        return fallback()
    return res
