"""K1 wrapper: the frame decode kernel (``csrc/decode.cu``).

Replaces ``slam_process_tpu/ops/pallas_decode.py::decode_frames_pallas``.
It writes the masked-row layout of ``ops/decode.py::decode_rows_plain``,
the plain PyTorch version it is held against; ``ops/decode.decode_rows``
dispatches here for CUDA tensors.  Bound: bytes (N read, ~21 R written);
see the source note in ``csrc/decode.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slam_process_tpu_torch.ops import _build

LAUNCHES = 0   # kernel launches since the caller last set it to 0


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library().slam_decode_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_rows_cuda(b: torch.Tensor, limit: int, flag_true: int, flag_false: int):
    """(rows [R, 5] i32, valid [R] bool, count i32) for a CUDA uint8 [N]
    byte tensor; frame windows must end at or below ``limit``."""
    global LAUNCHES
    if not b.is_cuda:
        raise ValueError(f"decode kernel needs a CUDA tensor, got {b.device}")
    if b.dtype != torch.uint8 or b.dim() != 1 or not b.is_contiguous():
        raise ValueError(f"decode kernel needs contiguous uint8 [N], got "
                         f"{b.dtype} {tuple(b.shape)}")
    n = b.shape[0]
    r = -(-n // 11)
    rows = torch.zeros((r, 5), dtype=torch.int32, device=b.device)
    valid = torch.zeros(r, dtype=torch.bool, device=b.device)
    count = torch.zeros((), dtype=torch.int32, device=b.device)
    if n == 0:
        return rows, valid, count
    with torch.cuda.device(b.device):
        err = _fn()(b.data_ptr(), n, min(int(limit), n), int(flag_true), int(flag_false),
                    rows.data_ptr(), valid.data_ptr(), count.data_ptr(), _build.stream_of(b))
    _build.check(err, "decode kernel")
    LAUNCHES += 1
    return rows, valid, count
