"""K4 wrapper: the per-sweep sums kernel (``csrc/sweep_sums.cu``).

Replaces ``slam_process_tpu/ops/pallas_sweep_sums.py::sweep_sums_pallas``
with the same inputs (p, bs, val int32 [F]) and outputs (sums, counts
[S, n, n] float32).  The plain PyTorch version it is held against is
``ops/scene.py::sweep_sums_plain``; ``ops/scene.intensity_per_sweep_sums``
dispatches here for CUDA tensors.  One cooperative launch per call (no
fill, no conversion pass): the outputs come from ``torch.empty`` and the
kernel writes every cell.  Bound: bytes (12 B per row, 8 B per cell); see
the source note in ``csrc/sweep_sums.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slam_process_tpu_torch.ops import _build

LAUNCHES = 0   # kernel launches since the caller last set it to 0
_TILE = 1024   # rows per tile summary


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library().slam_sweep_sums
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def scratch_for(dev: torch.device, stream: int, f: int) -> torch.Tensor:
    """The epoch ticket, then two tagged summary words (min and max p) per
    tile of 1,024 rows: int64 [1 + 2 tiles], zeroed once when made (or
    grown); every launch leaves it ready for the next on the same stream."""
    return _build.scratch("sweep-sums kernel", dev, stream, 1 + 2 * -(-f // _TILE), 1 + 2 * 1024)


def sweep_sums_cuda(p: torch.Tensor, bs: torch.Tensor, val: torch.Tensor, max_sweeps: int,
                    n_beams: int = 64):
    """(sums, counts) [max_sweeps, n_beams, n_beams] f32 on the card."""
    global LAUNCHES
    for name, t in (("p", p), ("bs", bs), ("val", val)):
        if not t.is_cuda or t.device != p.device:
            raise ValueError(f"sweep-sums kernel needs {name} on {p.device} (CUDA), "
                             f"got {t.device}")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"sweep-sums kernel needs contiguous int32 [F] {name}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if bs.shape != p.shape or val.shape != p.shape:
        raise ValueError(f"p, bs and val must share one length, got {tuple(p.shape)}, "
                         f"{tuple(bs.shape)} and {tuple(val.shape)}")
    if max_sweeps < 0 or n_beams <= 0:
        raise ValueError(f"bad shape: max_sweeps={max_sweeps}, n_beams={n_beams}")
    shape = (max_sweeps, n_beams, n_beams)
    f = p.shape[0]
    if f == 0 or max_sweeps == 0:
        return (torch.zeros(shape, dtype=torch.float32, device=p.device),
                torch.zeros(shape, dtype=torch.float32, device=p.device))
    if f > (1 << 31) - 1 - _TILE or max_sweeps * n_beams >= 1 << 31:
        raise ValueError(f"sweep-sums kernel takes F < 2^31 - {_TILE} rows and S * n_beams "
                         f"< 2^31, got F={f}, S={max_sweeps}, n_beams={n_beams}")
    sums = torch.empty(shape, dtype=torch.float32, device=p.device)
    counts = torch.empty(shape, dtype=torch.float32, device=p.device)
    stream = _build.stream_of(p)
    with torch.cuda.device(p.device):
        err = _fn()(p.data_ptr(), bs.data_ptr(), val.data_ptr(), f, max_sweeps, n_beams,
                    scratch_for(p.device, stream, f).data_ptr(), sums.data_ptr(),
                    counts.data_ptr(), stream)
    _build.check(err, "sweep-sums kernel")
    LAUNCHES += 1
    return sums, counts
