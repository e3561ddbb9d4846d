"""K1 wrapper: the frame decode kernel (``csrc/decode.cu``).

Replaces ``slam_process_tpu/ops/pallas_decode.py::decode_frames_pallas``.
It writes the masked-row layout of ``ops/decode.py::decode_rows_plain``,
the plain PyTorch version it is held against; ``ops/decode.decode_rows``
dispatches here for CUDA tensors.  One launch per call: the kernel writes
every row and the count, so the outputs come from ``torch.empty``.  Bound:
bytes (N read, 21 R + 4 written); see the source note in ``csrc/decode.cu``.

``decode_rows_streams_cuda`` is the stream axis: S byte streams [S, N], each
with its own limit, in one launch (``ops/decode.decode_rows_streams``; its
plain version is ``decode_rows_plain`` per stream).  Both entries add to
``LAUNCHES``.  A block whose rows lie wholly past its stream's limit reads
and tests nothing and writes zeros; every launch leaves the ticket words
zero, so a CUDA graph replays the call as it is.
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
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _fn_streams():
    fn = _build.library().slam_decode_rows_streams
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ticket_for(dev: torch.device, stream: int) -> torch.Tensor:
    """The count's scratch word on ``dev`` for ``stream``: zeroed once when
    made; every launch leaves it zero for the next on the same stream."""
    return _build.scratch("decode kernel ticket", dev, stream, 1, 1)


def decode_rows_cuda(b: torch.Tensor, limit: int, flag_true: int, flag_false: int):
    """(rows [R, 5] i32, valid [R] bool, count i32) for a CUDA uint8 [N]
    byte tensor; frame windows must end at or below ``limit``."""
    global LAUNCHES
    if not b.is_cuda:
        raise ValueError(f"decode kernel needs a CUDA tensor, got {b.device}")
    if b.dtype != torch.uint8 or b.dim() != 1 or not b.is_contiguous():
        raise ValueError(f"decode kernel needs contiguous uint8 [N], got "
                         f"{b.dtype} {tuple(b.shape)}")
    if not (0 <= flag_true <= 0xFF and 0 <= flag_false <= 0xFF):
        raise ValueError(f"flags must be byte values, got {flag_true} and {flag_false}")
    n = b.shape[0]
    r = -(-n // 11)
    rows = torch.empty((r, 5), dtype=torch.int32, device=b.device)
    valid = torch.empty(r, dtype=torch.bool, device=b.device)
    count = torch.empty((), dtype=torch.int32, device=b.device)
    stream = _build.stream_of(b)
    with torch.cuda.device(b.device):
        err = _fn()(b.data_ptr(), n, min(int(limit), n), int(flag_true), int(flag_false),
                    rows.data_ptr(), valid.data_ptr(), count.data_ptr(),
                    ticket_for(b.device, stream).data_ptr(), stream)
    _build.check(err, "decode kernel")
    LAUNCHES += 1
    return rows, valid, count


def tickets_for(dev: torch.device, stream: int, n_streams: int) -> torch.Tensor:
    """At least ``n_streams`` such words on ``dev`` for ``stream`` (grown,
    zeroed, when too few); every launch leaves them zero."""
    return _build.scratch("decode kernel tickets", dev, stream, n_streams, 64)


def decode_rows_streams_cuda(b: torch.Tensor, limits, flag_true: int, flag_false: int):
    """(rows [S, R, 5] i32, valid [S, R] bool, count [S] i32) for a CUDA
    uint8 [S, N] byte tensor; stream s's frame windows end at or below
    ``limits[s]`` (an int64 [S] tensor on the same device), or N where
    ``limits`` is None."""
    global LAUNCHES
    if not b.is_cuda:
        raise ValueError(f"decode kernel needs a CUDA tensor, got {b.device}")
    if b.dtype != torch.uint8 or b.dim() != 2 or not b.is_contiguous():
        raise ValueError(f"decode kernel needs contiguous uint8 [S, N], got "
                         f"{b.dtype} {tuple(b.shape)}")
    s_n, n = b.shape
    if not 1 <= s_n <= 65535:
        raise ValueError(f"decode kernel takes 1..65535 streams, got {s_n}")
    if limits is not None and (limits.device != b.device or limits.dtype != torch.int64
                               or tuple(limits.shape) != (s_n,) or not limits.is_contiguous()):
        raise ValueError(f"decode kernel needs int64 [{s_n}] limits on {b.device}")
    if not (0 <= flag_true <= 0xFF and 0 <= flag_false <= 0xFF):
        raise ValueError(f"flags must be byte values, got {flag_true} and {flag_false}")
    r = -(-n // 11)
    rows = torch.empty((s_n, r, 5), dtype=torch.int32, device=b.device)
    valid = torch.empty((s_n, r), dtype=torch.bool, device=b.device)
    count = torch.empty(s_n, dtype=torch.int32, device=b.device)
    stream = _build.stream_of(b)
    with torch.cuda.device(b.device):
        err = _fn_streams()(b.data_ptr(), s_n, n, None if limits is None else limits.data_ptr(),
                            int(flag_true), int(flag_false), rows.data_ptr(), valid.data_ptr(),
                            count.data_ptr(), tickets_for(b.device, stream, s_n).data_ptr(),
                            stream)
    _build.check(err, "decode kernel (stream axis)")
    LAUNCHES += 1
    return rows, valid, count
