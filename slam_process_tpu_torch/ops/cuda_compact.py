"""K5 wrapper: the masked-row compaction kernel (``csrc/compact.cu``).

Replaces ``slam_process_tpu/ops/pallas_compact.py::compact_rows_pallas``:
rows int32 [F, W] and a mask [F] in, the masked rows in stream order out,
written at a device-side offset up to a logical capacity.  The plain
PyTorch version it is held against is ``ops/compact.py::
compact_rows_plain``; ``ops/compact.compact_rows`` dispatches here for CUDA
tensors.  Bound: bytes (each row read once, each slot written once); see
the source note in ``csrc/compact.cu``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from slam_process_tpu_torch.ops import _build

LAUNCHES = 0   # kernel launches since the caller last set it to 0
_BLOCK = 1024


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library().slam_compact_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def compact_rows_cuda(rows: torch.Tensor, mask: torch.Tensor, capacity: int,
                      out: Optional[torch.Tensor] = None,
                      offset: Optional[torch.Tensor] = None):
    """(out, count) on the card: see ``ops/compact.compact_rows``."""
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
    if out is None:
        if offset is not None:
            raise ValueError("an offset needs an out tensor")
        out = torch.empty((capacity, width), dtype=torch.int32, device=dev)
        zero_tail = 1
    else:
        zero_tail = 0
        if (out.device != dev or out.dtype != torch.int32 or out.dim() != 2
                or out.shape[1] != width or out.shape[0] < capacity or not out.is_contiguous()):
            raise ValueError(f"compaction kernel needs a contiguous int32 [>= {capacity}, "
                             f"{width}] out on {dev}, got {out.dtype} {list(out.shape)} on "
                             f"{out.device}")
        if offset is not None and (offset.device != dev or offset.dtype != torch.int32
                                   or offset.numel() != 1):
            raise ValueError(f"compaction kernel needs an int32 scalar offset on {dev}")
    if capacity < 0 or width < 1:
        raise ValueError(f"bad shape: capacity={capacity}, width={width}")
    counts = torch.empty(max(1, -(-f // _BLOCK)), dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _fn()(rows.data_ptr(), mask.data_ptr(), f, width, counts.data_ptr(),
                    None if offset is None else offset.data_ptr(), capacity, zero_tail,
                    out.data_ptr(), total.data_ptr(), _build.stream_of(rows))
    _build.check(err, "compaction kernel")
    LAUNCHES += 1
    return out, total
