"""K5 wrapper: the masked-row compaction kernel (``csrc/compact.cu``).

Replaces ``slam_process_tpu/ops/pallas_compact.py::compact_rows_pallas``:
rows int32 [F, W] and a mask [F] in, the masked rows in stream order out,
written at a device-side offset up to a logical capacity, into one or two
destinations that share the ranks.  The plain PyTorch version it is held
against is ``ops/compact.py::compact_rows_multi_plain``;
``ops/compact.compact_rows`` and ``compact_rows_multi`` dispatch here for
CUDA tensors.  One launch per call, a single pass with decoupled
look-back; see the source note in ``csrc/compact.cu``.

``compact_rows_streams_cuda`` is the stream axis: S compactions of rows [S,
F, W] and masks [S, F] into per-stream destinations [S, capacity, W] at
per-stream offsets [S], one launch with one look-back chain per stream (at S
= 1 the single stream's schedule; for S > 1 a block takes a chunk of tiles
of one stream, the chunks sized to one resident wave)
(``ops/compact.compact_rows_streams``; its plain version is the single
stream's per stream).  Both entries add to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from slam_process_tpu_torch.ops import _build

LAUNCHES = 0   # kernel launches since the caller last set it to 0
_BLOCK = 1024
_TAIL_ELEMS = 1 << 12     # tail blocks: one per 4,096 int32 elements of capacity, at most 8
_MAX_TAIL = 8


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library().slam_compact_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _fn_streams():
    fn = _build.library().slam_compact_rows_streams
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _scratch_for(dev: torch.device, stream: int, n_tiles: int) -> torch.Tensor:
    """The ticket word, then one status word per tile: int64 [1 + tiles],
    zeroed once when made (or grown); every launch leaves it ready for the
    next on the same stream."""
    return _build.scratch("compaction kernel", dev, stream, 1 + n_tiles, 1 + 4096)


def compact_rows_multi_cuda(rows: torch.Tensor, mask: torch.Tensor,
                            dests: Sequence[Tuple[int, Optional[torch.Tensor],
                                                  Optional[torch.Tensor]]]):
    """([out per destination], count) on the card: see
    ``ops/compact.compact_rows_multi``."""
    global LAUNCHES
    dev = rows.device
    if not rows.is_cuda or not mask.is_cuda or mask.device != dev:
        raise ValueError(f"compaction kernel needs rows and mask on one CUDA device, got "
                         f"{rows.device} and {mask.device}")
    if rows.dtype != torch.int32 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(f"compaction kernel needs contiguous int32 [F, W] rows, got "
                         f"{rows.dtype} {list(rows.shape)}")
    f, width = rows.shape
    if mask.dtype != torch.bool or tuple(mask.shape) != (f,) or not mask.is_contiguous():
        raise ValueError(f"compaction kernel needs a contiguous bool [{f}] mask, got "
                         f"{mask.dtype} {list(mask.shape)}")
    if not 1 <= len(dests) <= 2:
        raise ValueError(f"compaction kernel takes one or two destinations, got {len(dests)}")
    if width < 1 or f >= 1 << 31:
        raise ValueError(f"bad shape: F={f}, width={width}")
    outs, args, tail_elems = [], [], 0
    for capacity, out, offset in dests:
        if capacity < 0:
            raise ValueError(f"bad capacity {capacity}")
        if out is None:
            if offset is not None:
                raise ValueError("an offset needs an out tensor")
            out = torch.empty((capacity, width), dtype=torch.int32, device=dev)
            tail_elems = max(tail_elems, capacity * width)
            zero_tail = int(capacity > 0)
        else:
            zero_tail = 0
            if (out.device != dev or out.dtype != torch.int32 or out.dim() != 2
                    or out.shape[1] != width or out.shape[0] < capacity
                    or not out.is_contiguous()):
                raise ValueError(f"compaction kernel needs a contiguous int32 [>= {capacity}, "
                                 f"{width}] out on {dev}, got {out.dtype} {list(out.shape)} "
                                 f"on {out.device}")
            if offset is not None and (offset.device != dev or offset.dtype != torch.int32
                                       or offset.numel() != 1):
                raise ValueError(f"compaction kernel needs an int32 scalar offset on {dev}")
        outs.append(out)
        args += [out.data_ptr(), None if offset is None else offset.data_ptr(), capacity,
                 zero_tail]
    args += [None, None, 0, 0] * (2 - len(outs))
    n_tail = min(_MAX_TAIL, -(-tail_elems // _TAIL_ELEMS))
    stream = _build.stream_of(rows)
    scratch = _scratch_for(dev, stream, max(1, -(-f // _BLOCK)))
    total = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _fn()(rows.data_ptr(), mask.data_ptr(), f, width, scratch.data_ptr(), len(outs),
                    *args, n_tail, total.data_ptr(), stream)
    _build.check(err, "compaction kernel")
    LAUNCHES += 1
    return outs, total


def compact_rows_cuda(rows: torch.Tensor, mask: torch.Tensor, capacity: int,
                      out: Optional[torch.Tensor] = None,
                      offset: Optional[torch.Tensor] = None):
    """(out, count) on the card: see ``ops/compact.compact_rows``."""
    outs, total = compact_rows_multi_cuda(rows, mask, [(capacity, out, offset)])
    return outs[0], total


def compact_rows_streams_cuda(rows: torch.Tensor, mask: torch.Tensor,
                              dests: Sequence[Tuple[int, Optional[torch.Tensor],
                                                    Optional[torch.Tensor]]]):
    """([out [S, capacity, W] per destination], count [S]) on the card: see
    ``ops/compact.compact_rows_streams``."""
    global LAUNCHES
    dev = rows.device
    if not rows.is_cuda or not mask.is_cuda or mask.device != dev:
        raise ValueError(f"compaction kernel needs rows and mask on one CUDA device, got "
                         f"{rows.device} and {mask.device}")
    if rows.dtype != torch.int32 or rows.dim() != 3 or not rows.is_contiguous():
        raise ValueError(f"compaction kernel needs contiguous int32 [S, F, W] rows, got "
                         f"{rows.dtype} {list(rows.shape)}")
    s_n, f, width = rows.shape
    if mask.dtype != torch.bool or tuple(mask.shape) != (s_n, f) or not mask.is_contiguous():
        raise ValueError(f"compaction kernel needs a contiguous bool [{s_n}, {f}] mask, got "
                         f"{mask.dtype} {list(mask.shape)}")
    if not 1 <= len(dests) <= 2:
        raise ValueError(f"compaction kernel takes one or two destinations, got {len(dests)}")
    if s_n < 1 or width < 1 or f >= 1 << 31:
        raise ValueError(f"bad shape: S={s_n}, F={f}, width={width}")
    outs, args, tail_elems = [], [], 0
    for capacity, out, offset in dests:
        if capacity < 0:
            raise ValueError(f"bad capacity {capacity}")
        if out is None:
            if offset is not None:
                raise ValueError("an offset needs an out tensor")
            out = torch.empty((s_n, capacity, width), dtype=torch.int32, device=dev)
            tail_elems = max(tail_elems, capacity * width)
            zero_tail = int(capacity > 0)
        else:
            zero_tail = 0
            if (out.device != dev or out.dtype != torch.int32 or out.dim() != 3
                    or out.shape[0] != s_n or out.shape[2] != width or out.shape[1] < capacity
                    or not out.is_contiguous()):
                raise ValueError(f"compaction kernel needs a contiguous int32 [{s_n}, >= "
                                 f"{capacity}, {width}] out on {dev}, got {out.dtype} "
                                 f"{list(out.shape)} on {out.device}")
            if offset is not None and (offset.device != dev or offset.dtype != torch.int32
                                       or tuple(offset.shape) != (s_n,)
                                       or not offset.is_contiguous()):
                raise ValueError(f"compaction kernel needs int32 [{s_n}] offsets on {dev}")
        outs.append(out)
        args += [out.data_ptr(), None if offset is None else offset.data_ptr(), capacity,
                 out.shape[1] * width, zero_tail]
    args += [None, None, 0, 0, 0] * (2 - len(outs))
    n_tail = min(_MAX_TAIL, -(-tail_elems // _TAIL_ELEMS))
    n_tiles = max(1, -(-f // _BLOCK))
    stream = _build.stream_of(rows)
    scratch = _scratch_for(dev, stream, s_n * n_tiles)
    total = torch.empty(s_n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _fn_streams()(rows.data_ptr(), mask.data_ptr(), s_n, f, width, scratch.data_ptr(),
                            len(outs), *args, n_tail, total.data_ptr(), stream)
    _build.check(err, "compaction kernel (stream axis)")
    LAUNCHES += 1
    return outs, total
