"""K2 wrapper: the corrector-verdict kernel (``csrc/correct.cu``).

Replaces ``slam_process_tpu/ops/pallas_correct.py::correct_planes_pallas``
with the same inputs (gid, clk, the residue-form packed table) and the
same outputs (has, k_best, bs_best).  The plain PyTorch version it is held
against is ``ops/correct.py::baseline_plane_verdicts``;
``ops/correct.correct_verdicts`` dispatches here for CUDA tensors.  Each
block stages its rows' groups once as int32 in shared memory and, where
2 tol + 1 < cycle, scores only the baselines whose residues lie within tol
of the row's on the circle (see ``csrc/correct.cu``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slam_process_tpu_torch.ops import _build

LAUNCHES = 0   # kernel launches since the caller last set it to 0


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library().slam_correct_verdicts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def correct_verdicts_cuda(gid: torch.Tensor, clk: torch.Tensor, packed: torch.Tensor, *,
                          bmax: int, cycle: int, tol: int):
    """(has [F] bool, k_best [F] i32, bs_best [F] i32) on the card."""
    global LAUNCHES
    for name, t, dtype in (("gid", gid, torch.int32), ("clk", clk, torch.int32),
                           ("packed", packed, torch.float32)):
        if not t.is_cuda or t.device != gid.device:
            raise ValueError(f"corrector kernel needs {name} on {gid.device} (CUDA), "
                             f"got {t.device}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"corrector kernel needs contiguous {dtype} {name}, "
                             f"got {t.dtype}")
    if gid.dim() != 1 or clk.shape != gid.shape:
        raise ValueError(f"gid and clk must be [F], got {tuple(gid.shape)} "
                         f"and {tuple(clk.shape)}")
    if packed.dim() != 2 or packed.shape[1] < 3 * bmax + 1:
        raise ValueError(f"packed must be [G, >= {3 * bmax + 1}], got {tuple(packed.shape)}")
    if cycle <= 0:
        raise ValueError(f"corrector kernel needs cycle > 0, got {cycle}")
    f = gid.shape[0]
    has = torch.empty(f, dtype=torch.bool, device=gid.device)
    k_best = torch.empty(f, dtype=torch.int32, device=gid.device)
    bs_best = torch.empty(f, dtype=torch.int32, device=gid.device)
    if f == 0:
        return has, k_best, bs_best
    with torch.cuda.device(gid.device):
        err = _fn()(gid.data_ptr(), clk.data_ptr(), f, packed.data_ptr(), packed.shape[0],
                    packed.shape[1], bmax, cycle, tol, has.data_ptr(), k_best.data_ptr(),
                    bs_best.data_ptr(), _build.stream_of(gid))
    _build.check(err, "corrector kernel")
    LAUNCHES += 1
    return has, k_best, bs_best
