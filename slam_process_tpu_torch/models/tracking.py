"""CLK-anchored multipath tracking across sweeps.

A copy of ``slam_process_tpu/models/tracking.py``'s numpy code
(``Tracks``, ``track_paths_np``, ``track_sweep_step_np``,
``track_velocities``), unchanged in behaviour, and ``track_paths``, the
counterpart of ``track_paths_jax`` on tensors: one call of
``ops/tracker.track_block`` over all S sweeps (kernel K6 on CUDA tensors),
compiled per shape by ``track_program`` (a CUDA graph on the card).

Association is greedy global-nearest-neighbour in angle space, one sweep
at a time in CLK order:

  * a track's position is its last observed (AoA, AoD);
  * per sweep, (track, path) pairs assign in ascending squared-distance
    order, gated at ``gate_deg`` (Euclidean angle distance), the lowest
    flat index ``t * K + k`` winning a tie;
  * unassigned valid paths open new tracks while capacity remains;
  * unmatched tracks coast (position held, no observation recorded).

All cost arithmetic is float32, each product and sum rounded on its own.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from slam_process_tpu_torch.ops.tracker import track_block
from slam_process_tpu_torch.utils.graphs import GraphProgram, program_cache


class Tracks(NamedTuple):
    """Associated path tracks over S sweeps (T static track slots).

    ``pos_aoa/pos_aod[t, s]`` hold track t's position AT sweep s (last
    observed position while coasting); ``observed[t, s]`` marks sweeps
    where the track matched a path (only those carry measurements);
    ``power[t, s]`` is the matched path's power (0 while coasting);
    ``created[t]`` marks live track slots.
    """

    pos_aoa: np.ndarray    # [T, S] f32
    pos_aod: np.ndarray    # [T, S] f32
    power: np.ndarray      # [T, S] f32
    observed: np.ndarray   # [T, S] bool
    created: np.ndarray    # [T] bool
    n_tracks: int          # scalar


def track_paths_np(aoa: np.ndarray, aod: np.ndarray, power: np.ndarray, valid: np.ndarray,
                   max_tracks: int = 8, gate_deg: float = 10.0) -> Tracks:
    """Host oracle for the greedy global-NN association (f32 arithmetic)."""
    aoa = np.asarray(aoa, np.float32)
    aod = np.asarray(aod, np.float32)
    power = np.asarray(power, np.float32)
    valid = np.asarray(valid, bool)
    s_n, _ = aoa.shape
    t_n = int(max_tracks)
    gate2 = np.float32(gate_deg) * np.float32(gate_deg)

    pos = np.zeros((t_n, 2), np.float32)
    created = np.zeros(t_n, bool)
    count = 0
    o_aoa = np.zeros((t_n, s_n), np.float32)
    o_aod = np.zeros((t_n, s_n), np.float32)
    o_pow = np.zeros((t_n, s_n), np.float32)
    o_obs = np.zeros((t_n, s_n), bool)

    for s in range(s_n):
        count, o_aoa[:, s], o_aod[:, s], o_pow[:, s], o_obs[:, s] = \
            track_sweep_step_np(pos, created, count, aoa[s], aod[s], power[s], valid[s], gate2)

    return Tracks(o_aoa, o_aod, o_pow, o_obs, created, count)


def track_sweep_step_np(pos: np.ndarray, created: np.ndarray, count: int, aoa_s: np.ndarray,
                        aod_s: np.ndarray, power_s: np.ndarray, valid_s: np.ndarray,
                        gate2: np.float32
                        ) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One sweep of the greedy global-NN association.

    Mutates ``pos`` [T, 2] and ``created`` [T] in place; returns ``(count,
    col_aoa, col_aod, col_pow, col_obs)``: the updated track count and this
    sweep's [T] output column (positions carry the coasting hold).
    """
    t_n = pos.shape[0]
    k_n = len(aoa_s)
    assigned = np.zeros(t_n, bool)
    used = np.zeros(k_n, bool)
    col_pow = np.zeros(t_n, np.float32)
    col_obs = np.zeros(t_n, bool)
    for _ in range(k_n):
        da = pos[:, 0:1] - aoa_s[None, :]
        dd = pos[:, 1:2] - aod_s[None, :]
        cost = (da * da + dd * dd).astype(np.float32)
        mask = (created & ~assigned)[:, None] & (valid_s & ~used)[None, :]
        cost = np.where(mask, cost, np.float32(np.inf))
        flat = int(np.argmin(cost))
        t, k = divmod(flat, k_n)
        if not (cost[t, k] <= gate2):
            break
        assigned[t] = True
        used[k] = True
        pos[t] = (aoa_s[k], aod_s[k])
        col_obs[t] = True
        col_pow[t] = power_s[k]
    # New tracks for leftover valid paths, in path order.
    for k in range(k_n):
        if valid_s[k] and not used[k] and count < t_n:
            pos[count] = (aoa_s[k], aod_s[k])
            created[count] = True
            col_obs[count] = True
            col_pow[count] = power_s[k]
            count += 1
    return count, pos[:, 0].copy(), pos[:, 1].copy(), col_pow, col_obs


def track_paths(aoa: torch.Tensor, aod: torch.Tensor, power: torch.Tensor, valid: torch.Tensor,
                max_tracks: int = 8, gate_deg: float = 10.0) -> Tracks:
    """Tracks of tensors on the inputs' device (``track_paths_jax``): one
    ``track_block`` over all S sweeps with ``m_eff = S``, from an empty
    carry.  Equal to ``track_paths_np`` bit for bit."""
    dev = aoa.device
    s_n, _ = aoa.shape
    t_n = int(max_tracks)
    pos = torch.zeros((t_n, 2), dtype=torch.float32, device=dev)
    created = torch.zeros(t_n, dtype=torch.bool, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    m_eff = torch.full((), s_n, dtype=torch.int32, device=dev)
    f32 = [x.to(torch.float32).contiguous() for x in (aoa, aod, power)]
    c_aoa, c_aod, c_pow, c_obs, _, created, count = track_block(
        *f32, valid.to(torch.bool).contiguous(), m_eff, pos, created, count, gate_deg)
    return Tracks(c_aoa.T, c_aod.T, c_pow.T, c_obs.T, created, count)


@program_cache(8)
def track_program(max_tracks: int = 8, gate_deg: float = 10.0, device=None) -> GraphProgram:
    """``track_paths`` of one (max_tracks, gate) as one compiled program on
    ``device`` (None: CUDA), the JAX package's ``jax.jit(track_paths_jax)``
    (``Session.path_tracks(engine="device")``), called as ``fn(aoa, aod,
    power, valid)``: on CUDA one graph per shape (K6 inside).  JAX builds a
    fresh jitted function per call; the port keeps 8 programs of 8 shapes."""
    return GraphProgram(lambda aoa, aod, power, valid: track_paths(
        aoa, aod, power, valid, max_tracks=max_tracks, gate_deg=gate_deg),
        device, 8)


def track_velocities(tracks: Tracks, times: np.ndarray, ticks_per_second: float = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-track angular velocity by masked least squares on the CLK axis.

    Returns (vel_aoa[T], vel_aod[T], ok[T]): slopes in deg per CLK tick
    (or deg/s when ``ticks_per_second`` is given), fit over each track's
    observed sweeps; ``ok`` is False for tracks with <2 observations or a
    degenerate time axis (identical CLK values).
    """
    times = np.asarray(times, np.float64)
    obs = np.asarray(tracks.observed, bool) & (times >= 0)[None, :]
    w = obs.astype(np.float64)
    n = w.sum(axis=1)
    safe_n = np.maximum(n, 1.0)
    tm = (w * times[None, :]).sum(axis=1) / safe_n
    dt = np.where(obs, times[None, :] - tm[:, None], 0.0)
    var_t = (dt * dt).sum(axis=1)
    ok = (n >= 2) & (var_t > 0)
    safe_var = np.where(var_t > 0, var_t, 1.0)

    def slope(y):
        y = np.asarray(y, np.float64)
        ym = (w * y).sum(axis=1) / safe_n
        dy = np.where(obs, y - ym[:, None], 0.0)
        return (dt * dy).sum(axis=1) / safe_var

    scale = float(ticks_per_second) if ticks_per_second else 1.0
    vel_aoa = np.where(ok, slope(tracks.pos_aoa) * scale, 0.0)
    vel_aod = np.where(ok, slope(tracks.pos_aod) * scale, 0.0)
    return vel_aoa, vel_aod, ok
