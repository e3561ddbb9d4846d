"""CLK-based BS-beam reconstruction + filtering on the masked-row layout.

The hardware reports a placeholder BS index on normal frames; rare FLAG=1
baseline frames carry the true index.  Per frame the corrector finds, among
its sweep group's baselines, the one whose CLK distance is nearest a whole
number k of beam cycles (residual <= tol, lowest residual then first
baseline winning) and sets corrected = (bs_b + k) mod 64:

  * sweep groups: a new group where UE decreases against the previous
    valid row;
  * baselines: rows with a FLAG 0 -> 1 transition AND RSS equal to the
    previous valid row, in the same group; the pair is (CLK of the
    previous row, BS of the flag row).

The per-row verdict runs on a residue-form table of each group's
baselines (see ``baseline_plane_verdicts``).  ``correct_verdicts``
launches kernel K2 (``ops/cuda_correct.py``) for CUDA tensors.  Around it,
plain PyTorch on both devices, exact in integers: "previous valid row" is
a ``cummax`` over ``where(valid, arange, -1)``, group ids a clipped
``cumsum``, group baseline counts a ``bincount``, and the table is built
by writing each baseline's integer payload to its unique (gid, rank) cell.

The host engine (``correct_frames_np``, numpy) is a copy of the JAX
package's: int64 arithmetic on a padded [G, Bmax] baseline table sized
to the data (no static bounds), the score ``resid (Bmax + 1) + column``
with a ``2**60`` sentinel, and ``np.argmin``'s first index on ties.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from slam_process_tpu_torch.config import CorrectConfig
from slam_process_tpu_torch.ops import cuda_correct

_DEFAULT = CorrectConfig()
_SENTINEL = 1 << 30


def _check_bounds(bmax: int, tol: int, mod_base: int) -> None:
    # Packed-verdict range: score <= tol * (bmax + 1) + bmax - 1 in bits
    # 10.., (k_frac + 1) in bits 8..9 and e < 256 in bits 0..7, all strictly
    # below the 2^30 sentinel.
    if (tol * (bmax + 1) + bmax) * 1024 + 1023 >= _SENTINEL or mod_base > 256:
        raise ValueError(f"tol={tol}, bmax={bmax}, mod_base={mod_base} overflow "
                         "the packed verdict (the host engine, Session.from_log("
                         "engine='host'), has no such bound)")


def baseline_plane_verdicts(gid: torch.Tensor, clk: torch.Tensor, packed: torch.Tensor, *,
                            bmax: int, cycle: int, tol: int):
    """Plain PyTorch per-row verdicts (has, k_best, bs_best) over planes.

    ``packed`` [G, W >= 3 bmax + 1] f32 is the residue-form table: cols
    [0:B) r_hi8, [B:2B) r_lo8, [2B:3B) e, col 3B n, where
    r_b = clk_b mod cycle and e_b = (bs_b - clk_b // cycle) mod mod_base.
    With clk = Q_f cycle + r_f, the reference's k = round((clk - clk_b) /
    cycle) is Q_f - Q_b + k_frac with k_frac in {-1, 0, 1} from two
    compares, the residual is |r_f - r_b - k_frac cycle|, and the corrected
    beam (bs_b + k) mod M equals (e_b + Q_f + k_frac) mod M.  So it returns
    k_best = Q_f + k_frac_best and bs_best = e_best, from one min over the
    unique packed score ((resid (B+1) + col) << 10) | ((k_frac+1) << 8) | e.
    A gid outside [0, G) selects no baseline.  Same formulas as
    ``slam_process_tpu/ops/correct.py::baseline_plane_verdicts``.
    """
    g_rows = packed.shape[0]
    inside = (gid >= 0) & (gid < g_rows)
    sel = packed[gid.clamp(0, max(g_rows - 1, 0)).long()]
    row_r = (sel[:, :bmax].to(torch.int32) << 8) | sel[:, bmax:2 * bmax].to(torch.int32)
    row_e = sel[:, 2 * bmax:3 * bmax].to(torch.int32)
    row_n = torch.where(inside, sel[:, 3 * bmax].to(torch.int32), 0)
    cols = torch.arange(bmax, dtype=torch.int32, device=gid.device)

    q_f = torch.div(clk, cycle, rounding_mode="floor")
    r_f = clk - q_f * cycle
    diff = r_f[:, None] - row_r
    k_frac = ((diff >= cycle - cycle // 2).to(torch.int32)
              - (diff < -(cycle // 2)).to(torch.int32))
    resid = (diff - k_frac * cycle).abs()
    accept = (resid <= tol) & (cols < row_n[:, None])
    score = torch.where(accept,
                        ((resid * (bmax + 1) + cols) << 10) | ((k_frac + 1) << 8) | row_e,
                        _SENTINEL)
    best = score.min(dim=1).values
    return best < _SENTINEL, q_f + ((best >> 8) & 3) - 1, best & 0xFF


def correct_verdicts(gid: torch.Tensor, clk: torch.Tensor, packed: torch.Tensor, *,
                     bmax: int, cycle: int, tol: int):
    """Per-row verdicts: kernel K2 on CUDA tensors, the plain version on CPU."""
    if gid.is_cuda:
        return cuda_correct.correct_verdicts_cuda(gid, clk, packed, bmax=bmax, cycle=cycle,
                                                  tol=tol)
    if gid.device.type != "cpu":
        raise ValueError(f"the corrector runs on CUDA or CPU tensors, got {gid.device}")
    return baseline_plane_verdicts(gid, clk, packed, bmax=bmax, cycle=cycle, tol=tol)


def _segments(frames: torch.Tensor, valid: torch.Tensor):
    """(boundary [F] bool: a sweep group starts here, is_bl [F] bool: a
    baseline row, prev_clk [F]: the previous valid row's CLK)."""
    flag, ue, _, rss, clk = frames.unbind(dim=1)
    # Previous valid row of every row (-1: none).
    pos = torch.arange(frames.shape[0], device=frames.device)
    last = torch.cummax(torch.where(valid, pos, -1), dim=0).values
    prev = torch.cat([last.new_full((1,), -1), last[:-1]])
    has_prev = prev >= 0
    prev = prev.clamp(min=0)
    boundary = valid & (~has_prev | (ue[prev] > ue))
    is_bl = (valid & has_prev & (flag == 1) & (flag[prev] == 0) & (rss == rss[prev])
             & ~boundary)
    return boundary, is_bl, clk[prev]


def correct_bounds(frames: torch.Tensor, valid: torch.Tensor) -> Tuple[int, int]:
    """(sweep groups, most baselines in one group) of the masked rows: the
    least ``max_groups`` and ``max_baselines_per_group`` with which
    ``baseline_table`` does not overflow on them."""
    boundary, is_bl, _ = _segments(frames, valid.to(torch.bool))
    gid = torch.cumsum(boundary, dim=0) - 1
    per_group = torch.bincount(gid[is_bl])
    return int(boundary.sum()), int(per_group.max()) if per_group.numel() else 0


def baseline_table(frames: torch.Tensor, valid: torch.Tensor, max_groups: int = 128,
                   max_baselines_per_group: int = 256, cfg: CorrectConfig = _DEFAULT):
    """Group ids and the residue-form baseline table of the masked rows.

    Returns (gid [F] i32, packed [max_groups, 3 B + 1] f32, overflow bool
    scalar tensor), the inputs of ``correct_verdicts``.  ``overflow`` is
    True when more than ``max_groups`` groups or more than B =
    ``max_baselines_per_group`` baselines in a group occur; the table is
    then unusable (``correct_bounds`` gives the bounds that fit).
    """
    bmax = max_baselines_per_group
    _check_bounds(bmax, cfg.tol, cfg.mod_base)
    dev = frames.device
    bs = frames[:, 2]
    boundary, is_bl, prev_clk = _segments(frames, valid.to(torch.bool))
    gid = (torch.cumsum(boundary, dim=0, dtype=torch.int32) - 1).clamp(0, max_groups - 1)

    # Baseline count per group; rows that are not baselines land in bin G.
    group_counts = torch.bincount(torch.where(is_bl, gid, max_groups).long(),
                                  minlength=max_groups + 1)[:max_groups]

    # Rank of each baseline inside its group: baselines before it minus the
    # baselines before the group (the cumsum at the group's boundary row,
    # which is never itself a baseline; cumsum is nondecreasing, so the
    # running max of the boundary anchors is the latest one).
    csum = torch.cumsum(is_bl, dim=0, dtype=torch.int32)
    last_anchor = torch.cummax(torch.where(boundary, csum, -1), dim=0).values
    rank = csum - 1 - last_anchor

    # Residue-form payload, written to its unique (gid, rank) cell; rows
    # that are not live baselines write to a dump cell past the table.
    q_b = torch.div(prev_clk, cfg.cycle, rounding_mode="floor")
    bl_r = prev_clk - q_b * cfg.cycle
    bl_e = torch.remainder(bs - q_b, cfg.mod_base)
    live = is_bl & (rank < bmax)
    cell = torch.where(live, gid * bmax + rank, max_groups * bmax).long()
    tbl_r = torch.zeros(max_groups * bmax + 1, dtype=torch.int32, device=dev)
    tbl_e = torch.zeros_like(tbl_r)
    tbl_r.index_put_((cell,), bl_r)
    tbl_e.index_put_((cell,), bl_e)
    tbl_r = tbl_r[:-1].view(max_groups, bmax)
    packed = torch.cat([tbl_r >> 8, tbl_r & 0xFF, tbl_e[:-1].view(max_groups, bmax),
                        group_counts.clamp(max=bmax).to(torch.int32)[:, None]],
                       dim=1).to(torch.float32)
    overflow = (group_counts.max() > bmax) | (boundary.sum() > max_groups)
    return gid, packed, overflow


def correct_rows(frames: torch.Tensor, valid: torch.Tensor, max_groups: int = 128,
                 max_baselines_per_group: int = 256, cfg: CorrectConfig = _DEFAULT):
    """Correct + filter the masked-row layout.

    frames [F, 5] i32 (flag, ue, bs, rss, clk) at the True rows of
    ``valid``.  Returns (corrected_bs [F] i32, keep [F] bool, overflow
    bool scalar tensor); the JAX counterpart is ``correct_rows_jax``.
    On overflow (see ``baseline_table``) the other outputs are unusable.
    """
    gid, packed, overflow = baseline_table(frames, valid, max_groups,
                                           max_baselines_per_group, cfg)
    flag, bs, clk = frames[:, 0], frames[:, 2], frames[:, 4].contiguous()
    has, k_best, bs_best = correct_verdicts(gid, clk, packed, bmax=max_baselines_per_group,
                                            cycle=cfg.cycle, tol=cfg.tol)
    cand = torch.remainder(bs_best + k_best, cfg.mod_base)
    keep = (flag == 0) & valid.to(torch.bool) & has
    corrected_bs = torch.where(keep, cand, bs)
    return corrected_bs, keep, overflow


# ---------------------------------------------------------------------------
# numpy host engine
# ---------------------------------------------------------------------------


def detect_groups_np(ue: np.ndarray) -> np.ndarray:
    """Sweep segmentation: group id per row (a UE decrease starts a group)."""
    ue = np.asarray(ue)
    boundary = np.ones(len(ue), dtype=bool)
    if len(ue) > 1:
        boundary[1:] = ue[:-1] > ue[1:]
    return np.cumsum(boundary) - 1


def identify_baselines_np(flag: np.ndarray, rss: np.ndarray, bs: np.ndarray,
                          clk: np.ndarray, gid: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(baseline_gid, clk_b, bs_b) in row order: a FLAG 0 -> 1 step with
    equal RSS against the previous row of the same group."""
    n = len(flag)
    mask = np.zeros(n, dtype=bool)
    if n > 1:
        mask[1:] = ((flag[1:] == 1) & (flag[:-1] == 0) & (rss[1:] == rss[:-1])
                    & (gid[1:] == gid[:-1]))
    idx = np.nonzero(mask)[0]
    return gid[idx], clk[idx - 1], bs[idx]


class CorrectResult(NamedTuple):
    filtered: np.ndarray       # [K, 4] (ue, corrected_bs, rss, clk), kept rows
    corrected_bs: np.ndarray   # [F] per-row corrected BS
    keep: np.ndarray           # [F] bool: row appears in filtered output
    n_baselines: int
    n_groups: int


def correct_frames_np(frames: np.ndarray, cfg: CorrectConfig = _DEFAULT) -> CorrectResult:
    """Host correct + filter of frames [F, 5] (flag, ue, bs, rss, clk)."""
    frames = np.asarray(frames, dtype=np.int64)
    flag, ue, bs, rss, clk = (frames[:, i] for i in range(5))
    n = len(flag)
    gid = detect_groups_np(ue)
    b_gid, b_clk, b_bs = identify_baselines_np(flag, rss, bs, clk, gid)
    n_groups = int(gid[-1]) + 1 if n else 0

    corrected = bs.copy()   # rows without a verdict keep the raw BS
    keep = np.zeros(n, dtype=bool)
    if b_gid.size:
        counts = np.bincount(b_gid, minlength=n_groups)
        bmax = int(counts.max())
        offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(len(b_gid)) - offs[b_gid]
        tbl_clk = np.zeros((n_groups, bmax), dtype=np.int64)
        tbl_bs = np.zeros((n_groups, bmax), dtype=np.int64)
        tbl_valid = np.zeros((n_groups, bmax), dtype=bool)
        tbl_clk[b_gid, rank] = b_clk
        tbl_bs[b_gid, rank] = b_bs
        tbl_valid[b_gid, rank] = True

        d = clk[:, None] - tbl_clk[gid]                       # [F, Bmax]
        k = (d + cfg.cycle // 2) // cfg.cycle                  # floor division
        resid = np.abs(d - k * cfg.cycle)
        accept = (resid <= cfg.tol) & tbl_valid[gid]
        score = np.where(accept, resid * (bmax + 1) + np.arange(bmax), 2**60)
        best = np.argmin(score, axis=1)
        has = accept[np.arange(n), best]
        k_best = k[np.arange(n), best]
        bs_best = tbl_bs[gid, best]
        cand = (bs_best + k_best) % cfg.mod_base

        normal = flag == 0
        corrected = np.where(normal & has, cand, corrected)
        keep = normal & has

    filtered = np.stack([ue[keep], corrected[keep], rss[keep], clk[keep]], axis=1)
    return CorrectResult(filtered, corrected, keep, int(b_gid.size), n_groups)
