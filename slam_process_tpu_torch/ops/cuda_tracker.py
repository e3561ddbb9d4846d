"""K6 wrapper: the streaming tracker block kernel (``csrc/tracker.cu``).

Replaces ``slam_process_tpu/ops/pallas_tracker.py::track_block_pallas``
with the same inputs (aoa / aod / power f32 [s1, K], valid [s1, K], the
closed-lane count ``m_eff`` as a device int32 scalar, and the carry pos
f32 [T, 2], created [T], count int32) and outputs (four [s1, T] column
blocks and the new carry).  The plain PyTorch version it is held against
is ``ops/tracker.py::track_block_plain``; ``ops/tracker.track_block``
dispatches here for CUDA tensors.  One launch of one block: one warp runs
the live lanes in order, with only the carry-dependent work on its chain,
while the others stage their inputs (a float4 a path, a mask word a lane),
then the block writes the dead lanes; see the source note in
``csrc/tracker.cu``.

``track_block_streams_cuda`` is the stream axis: S independent blocks of
lanes ([S, s1, K] inputs, [S] m_eff and counts, [S, T, 2] / [S, T]
carries), one launch of S thread blocks, one per stream
(``ops/tracker.track_block_streams``).  Both entries add to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from slam_process_tpu_torch.ops import _build

LAUNCHES = 0   # kernel launches since the caller last set it to 0
MAX_TRACKS = 16
MAX_PATHS = 20


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library().slam_track_block
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_float] + [ctypes.c_void_p] * 8)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _fn_streams():
    fn = _build.library().slam_track_block_streams
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_void_p] * 8)
    fn.restype = ctypes.c_int
    return fn


def _need(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"tracker kernel needs {name} on {dev} (CUDA), got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"tracker kernel needs contiguous {dtype} {list(shape)} {name}, got "
                         f"{t.dtype} {list(t.shape)}")


def track_block_cuda(aoa_l: torch.Tensor, aod_l: torch.Tensor, pow_l: torch.Tensor,
                     val_l: torch.Tensor, m_eff: torch.Tensor, pos: torch.Tensor,
                     created: torch.Tensor, count: torch.Tensor, gate_deg: float):
    """(col_aoa, col_aod, col_pow [s1, T] f32, col_obs [s1, T] bool, new_pos
    [T, 2] f32, new_created [T] bool, new_count int32) on the card."""
    global LAUNCHES
    dev = aoa_l.device
    if not aoa_l.is_cuda or aoa_l.dim() != 2:
        raise ValueError(f"tracker kernel needs CUDA [s1, K] lanes, got {aoa_l.device} "
                         f"{list(aoa_l.shape)}")
    s1, k_n = aoa_l.shape
    t_n = pos.shape[0] if pos.dim() == 2 else -1
    if not (1 <= t_n <= MAX_TRACKS and 1 <= k_n <= MAX_PATHS):
        raise ValueError(f"tracker kernel takes 1..{MAX_TRACKS} tracks and 1..{MAX_PATHS} "
                         f"paths, got T={t_n}, K={k_n}")
    for name, t in (("aoa", aoa_l), ("aod", aod_l), ("power", pow_l)):
        _need(t, name, torch.float32, (s1, k_n), dev)
    _need(val_l, "valid", torch.bool, (s1, k_n), dev)
    _need(m_eff, "m_eff", torch.int32, (), dev)
    _need(pos, "pos", torch.float32, (t_n, 2), dev)
    _need(created, "created", torch.bool, (t_n,), dev)
    _need(count, "count", torch.int32, (), dev)
    cols = [torch.empty((s1, t_n), dtype=torch.float32, device=dev) for _ in range(3)]
    col_obs = torch.empty((s1, t_n), dtype=torch.bool, device=dev)
    new_pos = torch.empty_like(pos)
    new_created = torch.empty_like(created)
    new_count = torch.empty_like(count)
    # gate2 rounded as the host oracle rounds it: f32(gate) * f32(gate).
    gate2 = float(np.float32(gate_deg) * np.float32(gate_deg))
    with torch.cuda.device(dev):
        err = _fn()(aoa_l.data_ptr(), aod_l.data_ptr(), pow_l.data_ptr(), val_l.data_ptr(),
                    m_eff.data_ptr(), pos.data_ptr(), created.data_ptr(), count.data_ptr(),
                    s1, k_n, t_n, gate2, *(c.data_ptr() for c in cols), col_obs.data_ptr(),
                    new_pos.data_ptr(), new_created.data_ptr(), new_count.data_ptr(),
                    _build.stream_of(aoa_l))
    _build.check(err, "tracker kernel")
    LAUNCHES += 1
    return (*cols, col_obs, new_pos, new_created, new_count)


def track_block_streams_cuda(aoa_l: torch.Tensor, aod_l: torch.Tensor, pow_l: torch.Tensor,
                             val_l: torch.Tensor, m_eff: torch.Tensor, pos: torch.Tensor,
                             created: torch.Tensor, count: torch.Tensor, gate_deg: float):
    """``track_block_cuda`` with a leading S axis on every input and output
    (m_eff and count int32 [S]); one launch for all S streams."""
    global LAUNCHES
    dev = aoa_l.device
    if not aoa_l.is_cuda or aoa_l.dim() != 3:
        raise ValueError(f"tracker kernel needs CUDA [S, s1, K] lanes, got {aoa_l.device} "
                         f"{list(aoa_l.shape)}")
    s_n, s1, k_n = aoa_l.shape
    t_n = pos.shape[1] if pos.dim() == 3 else -1
    if not (1 <= t_n <= MAX_TRACKS and 1 <= k_n <= MAX_PATHS and s_n >= 1):
        raise ValueError(f"tracker kernel takes 1..{MAX_TRACKS} tracks, 1..{MAX_PATHS} "
                         f"paths and S >= 1, got T={t_n}, K={k_n}, S={s_n}")
    for name, t in (("aoa", aoa_l), ("aod", aod_l), ("power", pow_l)):
        _need(t, name, torch.float32, (s_n, s1, k_n), dev)
    _need(val_l, "valid", torch.bool, (s_n, s1, k_n), dev)
    _need(m_eff, "m_eff", torch.int32, (s_n,), dev)
    _need(pos, "pos", torch.float32, (s_n, t_n, 2), dev)
    _need(created, "created", torch.bool, (s_n, t_n), dev)
    _need(count, "count", torch.int32, (s_n,), dev)
    cols = [torch.empty((s_n, s1, t_n), dtype=torch.float32, device=dev) for _ in range(3)]
    col_obs = torch.empty((s_n, s1, t_n), dtype=torch.bool, device=dev)
    new_pos = torch.empty_like(pos)
    new_created = torch.empty_like(created)
    new_count = torch.empty_like(count)
    gate2 = float(np.float32(gate_deg) * np.float32(gate_deg))
    with torch.cuda.device(dev):
        err = _fn_streams()(s_n, aoa_l.data_ptr(), aod_l.data_ptr(), pow_l.data_ptr(),
                            val_l.data_ptr(), m_eff.data_ptr(), pos.data_ptr(),
                            created.data_ptr(), count.data_ptr(), s1, k_n, t_n, gate2,
                            *(c.data_ptr() for c in cols), col_obs.data_ptr(),
                            new_pos.data_ptr(), new_created.data_ptr(), new_count.data_ptr(),
                            _build.stream_of(aoa_l))
    _build.check(err, "tracker kernel (stream axis)")
    LAUNCHES += 1
    return (*cols, col_obs, new_pos, new_created, new_count)
