"""The streaming tracker's per-window sweep block.

``track_block`` advances the greedy global-NN tracker
(``models/tracking.track_sweep_step_np``) over the s1 sweep lanes a
streaming window closed, from a carry (pos [T, 2], created [T], count).
Lanes at or past ``min(m_eff, s1)`` run with every path invalid, which
leaves the carry as it is (no pair passes the gate, no path is left to
open a track).  ``m_eff`` is a device scalar: the kernel reads it without
a host sync.

``track_block`` launches kernel K6 (``ops/cuda_tracker.py``) on CUDA
tensors and runs ``track_block_plain`` on CPU tensors.  The plain version
is the counterpart of ``slam_process_tpu/ops/pallas_tracker.py::
track_block_pallas`` and equals ``track_sweep_step_np`` applied lane by
lane: f32 cost ``(pa - a)^2 + (pd - d)^2`` with each operation rounded on
its own, ``torch.argmin``'s first flat index on ties, acceptance iff
``cost <= gate2`` with ``gate2 = f32(gate_deg) * f32(gate_deg)``.

``track_block_streams`` is the stream axis: S independent trackers, every
input and output with a leading S axis (m_eff and count [S]); one launch of
K6 for all S on CUDA tensors, ``track_block_plain`` per stream on CPU
tensors.  The multi-stream session uses it.
"""

from __future__ import annotations

import torch

from slam_process_tpu_torch.ops import cuda_tracker


def _gate2(gate_deg: float) -> torch.Tensor:
    g = torch.tensor(float(gate_deg), dtype=torch.float32)
    return g * g


def track_block_plain(aoa_l: torch.Tensor, aod_l: torch.Tensor, pow_l: torch.Tensor,
                      val_l: torch.Tensor, m_eff, pos: torch.Tensor, created: torch.Tensor,
                      count, gate_deg: float):
    """Plain PyTorch tracker block: a Python loop over the s1 lanes.

    Returns ``(col_aoa, col_aod, col_pow, col_obs, new_pos, new_created,
    new_count)``: the [s1, T] per-lane output columns (positions after the
    lane's update, the matched power, observed) and the new carry.
    """
    s1, k_n = aoa_l.shape
    t_n = pos.shape[0]
    dev = aoa_l.device
    gate2 = _gate2(gate_deg).to(dev)
    pos = pos.to(torch.float32).clone()
    created = created.to(torch.bool).clone()
    count = int(count)
    live = max(0, min(int(m_eff), s1))
    cols = [torch.zeros((s1, t_n), dtype=torch.float32, device=dev) for _ in range(3)]
    col_obs = torch.zeros((s1, t_n), dtype=torch.bool, device=dev)
    for i in range(s1):
        p_aoa, p_aod, p_pow = aoa_l[i], aod_l[i], pow_l[i]
        p_val = val_l[i].to(torch.bool) & (i < live)
        assigned = torch.zeros(t_n, dtype=torch.bool, device=dev)
        used = torch.zeros(k_n, dtype=torch.bool, device=dev)
        opow = torch.zeros(t_n, dtype=torch.float32, device=dev)
        obs = torch.zeros(t_n, dtype=torch.bool, device=dev)
        for _ in range(k_n):
            da = pos[:, 0:1] - p_aoa[None, :]
            dd = pos[:, 1:2] - p_aod[None, :]
            cost = da * da + dd * dd
            mask = (created & ~assigned)[:, None] & (p_val & ~used)[None, :]
            cost = torch.where(mask, cost, float("inf")).flatten()
            flat = int(torch.argmin(cost))
            if not bool(cost[flat] <= gate2):
                break
            t, k = divmod(flat, k_n)
            assigned[t] = True
            used[k] = True
            pos[t, 0], pos[t, 1] = p_aoa[k], p_aod[k]
            obs[t] = True
            opow[t] = p_pow[k]
        for k in range(k_n):
            if bool(p_val[k]) and not bool(used[k]) and count < t_n:
                pos[count, 0], pos[count, 1] = p_aoa[k], p_aod[k]
                created[count] = True
                obs[count] = True
                opow[count] = p_pow[k]
                count += 1
        cols[0][i], cols[1][i], cols[2][i] = pos[:, 0], pos[:, 1], opow
        col_obs[i] = obs
    return (*cols, col_obs, pos, created, torch.tensor(count, dtype=torch.int32, device=dev))


def track_block(aoa_l: torch.Tensor, aod_l: torch.Tensor, pow_l: torch.Tensor,
                val_l: torch.Tensor, m_eff: torch.Tensor, pos: torch.Tensor,
                created: torch.Tensor, count: torch.Tensor, gate_deg: float):
    """Advance the tracker over one block of sweep lanes: kernel K6 on CUDA
    tensors, ``track_block_plain`` on CPU tensors (same outputs)."""
    if aoa_l.is_cuda:
        return cuda_tracker.track_block_cuda(aoa_l, aod_l, pow_l, val_l, m_eff, pos, created,
                                             count, gate_deg)
    if aoa_l.device.type != "cpu":
        raise ValueError(f"the tracker runs on CUDA or CPU tensors, got {aoa_l.device}")
    return track_block_plain(aoa_l, aod_l, pow_l, val_l, m_eff, pos, created, count, gate_deg)


def track_block_streams_plain(aoa_l, aod_l, pow_l, val_l, m_eff, pos, created, count,
                              gate_deg: float):
    """Plain PyTorch stream axis: ``track_block_plain`` on each stream,
    stacked."""
    outs = [track_block_plain(aoa_l[i], aod_l[i], pow_l[i], val_l[i], m_eff[i], pos[i],
                              created[i], count[i], gate_deg) for i in range(aoa_l.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def track_block_streams(aoa_l: torch.Tensor, aod_l: torch.Tensor, pow_l: torch.Tensor,
                        val_l: torch.Tensor, m_eff: torch.Tensor, pos: torch.Tensor,
                        created: torch.Tensor, count: torch.Tensor, gate_deg: float):
    """Advance S trackers over their blocks of sweep lanes: kernel K6 once
    for all S on CUDA tensors, the plain version per stream on CPU
    tensors."""
    if aoa_l.is_cuda:
        return cuda_tracker.track_block_streams_cuda(aoa_l, aod_l, pow_l, val_l, m_eff, pos,
                                                     created, count, gate_deg)
    if aoa_l.device.type != "cpu":
        raise ValueError(f"the tracker runs on CUDA or CPU tensors, got {aoa_l.device}")
    return track_block_streams_plain(aoa_l, aod_l, pow_l, val_l, m_eff, pos, created, count,
                                     gate_deg)
