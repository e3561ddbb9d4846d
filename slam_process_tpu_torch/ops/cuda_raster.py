"""K3 wrapper: the fused raster kernel (``csrc/raster.cu``).

Replaces ``slam_process_tpu/ops/pallas_raster.py::pallas_rasterize_batch``
and also returns the blurred tiles, which ``DeviceSessionOut.blurred``
carries.  The plain PyTorch version it is held against is
``ops/raster.py::raster_tiles_plain``; ``ops/raster.rasterize_tiles``
dispatches here for CUDA tensors.  One thread-block cluster of 8 blocks
per tile, each block a band of rows; the tile's min / max meet through
distributed shared memory (see ``csrc/raster.cu``).  Explicit norm bounds
``vmin`` / ``vmax`` (``cli heatmap --vmin/--vmax``) replace the tile's lo
and hi in the norm.  The kernel's shared-memory opt-in is set once per
device (``_ready``), not per launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from slam_process_tpu_torch.ops import _build

LAUNCHES = 0   # kernel launches since the caller last set it to 0


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library().slam_raster
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _ready(index: int) -> None:
    """Set the kernel's shared-memory opt-in on CUDA device ``index``, once
    per process."""
    init = _build.library().slam_raster_init
    init.argtypes = []
    init.restype = ctypes.c_int
    with torch.cuda.device(index):
        _build.check(init(), "raster kernel init")


def raster_tiles_cuda(mats: torch.Tensor, lut: torch.Tensor, taps: torch.Tensor,
                      use_log: bool, vmin: Optional[float] = None,
                      vmax: Optional[float] = None):
    """(rgba [S, H, W, 4], norm_t [S, H, W], blurred [S, H, W]) f32 on the
    card; ``vmin`` / ``vmax`` (float32) replace the tile's range in the
    norm where given."""
    global LAUNCHES
    for name, t in (("mats", mats), ("lut", lut), ("taps", taps)):
        if not t.is_cuda or t.device != mats.device:
            raise ValueError(f"raster kernel needs {name} on {mats.device} (CUDA), "
                             f"got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"raster kernel needs contiguous float32 {name}, got {t.dtype}")
    if mats.dim() != 3 or lut.dim() != 2 or lut.shape[1] != 4 or taps.dim() != 2:
        raise ValueError(f"raster kernel needs mats [S, H, W], lut [N, 4], taps [kh, kw]; "
                         f"got {tuple(mats.shape)}, {tuple(lut.shape)}, {tuple(taps.shape)}")
    if lut.data_ptr() % 16:
        raise ValueError("raster kernel needs a 16-byte aligned lut")
    kh, kw = taps.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"raster kernel needs odd tap sizes, got {kh} x {kw}")
    s, h, w = mats.shape
    rgba = torch.empty((s, h, w, 4), dtype=torch.float32, device=mats.device)
    norm_t = torch.empty((s, h, w), dtype=torch.float32, device=mats.device)
    blurred = torch.empty((s, h, w), dtype=torch.float32, device=mats.device)
    if s == 0 or h == 0 or w == 0:
        return rgba, norm_t, blurred
    _ready(mats.device.index)
    with torch.cuda.device(mats.device):
        err = _fn()(mats.data_ptr(), s, h, w, lut.data_ptr(), lut.shape[0], taps.data_ptr(),
                    kh, kw, int(bool(use_log)), int(vmin is not None),
                    0.0 if vmin is None else float(vmin), int(vmax is not None),
                    0.0 if vmax is None else float(vmax), rgba.data_ptr(), norm_t.data_ptr(),
                    blurred.data_ptr(), _build.stream_of(mats))
    _build.check(err, "raster kernel")
    LAUNCHES += 1
    return rgba, norm_t, blurred
