"""Track-based scene change detection over CLK-anchored path tracks.

The port of ``slam_process_tpu/models/change_detection.py``: the batch
detector in numpy (``detect_scene_changes_np``, the oracle) and on torch
tensors on the tracks' device (``detect_scene_changes``, the counterpart
of ``detect_scene_changes_jax``), one formulation over both and
bit-identical; ``scene_change_events``; and the streamed form
(``IncrementalChangeDetector``), unchanged in behaviour.  It turns a
tracked session (``Session.path_tracks``) into scene change events on the
testbed clock:

  * **birth**: a track reaches its ``min_persist``-th observation;
  * **death**: a confirmed track has ``min_gone`` consecutive sweeps with
    no observation (the event fires at the sweep where the gap reaches
    ``min_gone``);
  * **jump**: a confirmed track moves more than ``jump_deg`` (Euclidean
    angle distance) between consecutive observations;
  * **LoS handover**: the dominant-power observed track changes between
    consecutive sweeps that observe any track.

Everything comes from the [T, S] track tensors with cumulative masked
reductions.  ``Tracks`` holds a coasting track's last observed position,
so the displacement between consecutive observations is the one-step
position delta at observed sweeps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_process_tpu_torch.models.tracking import Tracks

__all__ = ["SceneChanges", "detect_scene_changes_np", "detect_scene_changes",
           "scene_change_events", "IncrementalChangeDetector", "EVENT_KINDS"]

EVENT_KINDS = ("birth", "death", "jump", "los_handover")


class SceneChanges(NamedTuple):
    """Per-sweep change masks (same [T, S] layout as ``Tracks``)."""

    birth: np.ndarray        # [T, S] bool — min_persist-th observation
    death: np.ndarray        # [T, S] bool — min_gone-th consecutive miss
    jump: np.ndarray         # [T, S] bool — move > jump_deg between obs
    los_track: np.ndarray    # [S] i32 — dominant observed track (-1: none)
    los_change: np.ndarray   # [S] bool — dominant identity changed


class _NumpyOps:
    """The array operations of ``_detect`` in numpy (the oracle)."""

    bool, int32, float32 = bool, np.int32, np.float32

    @staticmethod
    def asarray(x, dtype):
        return np.asarray(x, dtype)

    @staticmethod
    def zeros(shape, dtype):
        return np.zeros(shape, dtype)

    @staticmethod
    def arange(n):
        return np.arange(n, dtype=np.int32)

    @staticmethod
    def scalar(x):
        return x

    where = staticmethod(np.where)

    @staticmethod
    def cumsum(x, axis):
        return np.cumsum(x.astype(np.int32), axis=axis)

    @staticmethod
    def cummax(x, axis):
        return np.maximum.accumulate(x, axis=axis)

    @staticmethod
    def cat(xs, axis):
        return np.concatenate(xs, axis=axis)

    @staticmethod
    def any(x, axis):
        return np.any(x, axis=axis)

    @staticmethod
    def argmax(x, axis):
        return np.argmax(x, axis=axis).astype(np.int32)

    @staticmethod
    def take(x, idx):
        return x[np.maximum(idx, 0)]


class _TorchOps:
    """The same operations on torch tensors on ``device``: ``torch.cummax``
    where the JAX package uses ``lax.cummax``, the first maximal index
    from ``torch.argmax``, float32 arithmetic one rounding an operation."""

    bool, int32, float32 = torch.bool, torch.int32, torch.float32

    def __init__(self, device):
        self.device = device

    def asarray(self, x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def zeros(self, shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def arange(self, n):
        return torch.arange(n, dtype=torch.int32, device=self.device)

    @staticmethod
    def scalar(x):
        return x.item()

    @staticmethod
    def where(cond, a, b):
        return torch.where(cond, a, b)

    @staticmethod
    def cumsum(x, axis):
        return torch.cumsum(x.to(torch.int32), dim=axis)

    @staticmethod
    def cummax(x, axis):
        return torch.cummax(x, dim=axis).values

    @staticmethod
    def cat(xs, axis):
        return torch.cat(xs, dim=axis)

    @staticmethod
    def any(x, axis):
        return x.any(dim=axis)

    @staticmethod
    def argmax(x, axis):
        return x.argmax(dim=axis).to(torch.int32)

    @staticmethod
    def take(x, idx):
        return x[idx.clamp(min=0).long()]


def _detect(xp, tracks, min_persist: int, min_gone: int, jump_deg: float):
    """Cumulative operations only (cumsum / running max), no per-event
    loop: one formulation over ``xp`` = ``_NumpyOps`` or ``_TorchOps``, as
    the JAX package's ``_detect(xp, ...)`` serves numpy and jax.numpy."""
    obs = xp.asarray(tracks.observed, xp.bool)
    pos_a = xp.asarray(tracks.pos_aoa, xp.float32)
    pos_d = xp.asarray(tracks.pos_aod, xp.float32)
    power = xp.asarray(tracks.power, xp.float32)
    created = xp.asarray(tracks.created, xp.bool)
    t_n, s_n = obs.shape
    if s_n == 0:
        # Zero-sweep session (e.g. a junk-only stream): no events.
        z = xp.zeros((t_n, 0), xp.bool)
        return SceneChanges(z, z, z, xp.zeros(0, xp.int32), xp.zeros(0, xp.bool))

    obs = obs & created[:, None]
    cum = xp.cumsum(obs, axis=1)                        # [T, S] obs count
    confirmed = cum >= min_persist

    # birth: the sweep of the min_persist-th observation.
    birth = obs & (cum == min_persist)

    # Last observed sweep index at-or-before s (running max of s*obs,
    # -1 before the first observation).
    s_iota = xp.arange(s_n)[None, :]
    marked = xp.where(obs, s_iota, xp.scalar(np.int32(-1)))
    last_obs = xp.cummax(marked, axis=1)
    miss_run = xp.where(last_obs >= 0, s_iota - last_obs, xp.scalar(np.int32(0)))

    # death: the miss run ending at s reaches exactly min_gone, and the
    # track was confirmed by its last observation (cum is constant while
    # coasting, so cum[t, s] equals the count at last_obs).
    death = (last_obs >= 0) & (miss_run == min_gone) & confirmed

    # jump: displacement between consecutive observations, using the
    # coasting-hold property (pos[:, s-1] = last observed position).
    d_a = pos_a[:, 1:] - pos_a[:, :-1]
    d_d = pos_d[:, 1:] - pos_d[:, :-1]
    disp2 = d_a * d_a + d_d * d_d
    had_prev = last_obs[:, :-1] >= 0
    moved = xp.cat(
        [xp.zeros((t_n, 1), xp.bool),
         obs[:, 1:] & had_prev & (disp2 > xp.scalar(np.float32(jump_deg) ** 2))],
        axis=1)
    # Only tracks confirmed BEFORE the move report jumps (wobble up to
    # and including the confirming observation is the estimator
    # settling, not scene geometry).
    confirmed_prev = xp.cat([xp.zeros((t_n, 1), xp.bool), confirmed[:, :-1]], axis=1)
    jump = moved & confirmed_prev

    # LoS handover: dominant observed track per sweep, forward-filled
    # over empty sweeps, change fires when the identity differs from the
    # previous defined sweep.
    p_masked = xp.where(obs, power, -np.inf)
    any_obs = xp.any(obs, axis=0)                       # [S]
    dom = xp.where(any_obs, xp.argmax(p_masked, axis=0), xp.scalar(np.int32(-1)))
    s_vec = xp.arange(s_n)
    def_mark = xp.where(any_obs, s_vec, xp.scalar(np.int32(-1)))
    last_def = xp.cummax(def_mark, axis=0)
    prev_def = xp.cat([xp.asarray([-1], xp.int32), last_def[:-1]], axis=0)
    prev_dom = xp.where(prev_def >= 0, xp.take(dom, prev_def), xp.scalar(np.int32(-1)))
    los_change = any_obs & (prev_dom >= 0) & (dom != prev_dom)
    return SceneChanges(birth, death, jump, dom, los_change)


def detect_scene_changes_np(
    tracks: Tracks,
    min_persist: int = 3,
    min_gone: int = 3,
    jump_deg: float = 5.0,
) -> SceneChanges:
    """Numpy engine (float64-free f32 arithmetic — the oracle)."""
    out = _detect(_NumpyOps, tracks, int(min_persist), int(min_gone),
                  float(jump_deg))
    return SceneChanges(*(np.asarray(x) for x in out))


def detect_scene_changes(tracks: Tracks, min_persist: int = 3, min_gone: int = 3,
                         jump_deg: float = 5.0) -> SceneChanges:
    """The detector on torch tensors on the tracks' device (the port of
    ``detect_scene_changes_jax``): ``tracks``' fields are tensors of one
    device (``models/tracking.track_paths``' output), and so are the
    returned masks (bool [T, S], los_track int32 [S], los_change bool [S]),
    bit-identical to ``detect_scene_changes_np`` on the same tracks read
    back."""
    if not isinstance(tracks.observed, torch.Tensor):
        raise TypeError("detect_scene_changes takes tracks of tensors; "
                        "detect_scene_changes_np takes numpy")
    return _detect(_TorchOps(tracks.observed.device), tracks, int(min_persist),
                   int(min_gone), float(jump_deg))


def scene_change_events(
    changes: SceneChanges,
    tracks: Tracks,
    times: np.ndarray,
) -> np.ndarray:
    """Flatten the change masks into an event table (host side).

    Returns [N, 7] float64: (sweep, clk, kind, track, aoa, aod, power),
    sorted by sweep then kind then track; ``kind`` indexes
    ``EVENT_KINDS``.  LoS handover rows carry the NEW dominant track.
    """
    times = np.asarray(times, np.float64)
    rows = []
    per_track = (np.asarray(changes.birth), np.asarray(changes.death),
                 np.asarray(changes.jump))
    for kind, mask in enumerate(per_track):
        for t, s in zip(*np.nonzero(mask)):
            rows.append([s, times[s], kind, t,
                         float(tracks.pos_aoa[t, s]),
                         float(tracks.pos_aod[t, s]),
                         float(tracks.power[t, s])])
    for s in np.nonzero(np.asarray(changes.los_change))[0]:
        t = int(changes.los_track[s])
        rows.append([s, times[s], 3, t,
                     float(tracks.pos_aoa[t, s]),
                     float(tracks.pos_aod[t, s]),
                     float(tracks.power[t, s])])
    if not rows:
        return np.zeros((0, 7), np.float64)
    table = np.asarray(rows, np.float64)
    order = np.lexsort((table[:, 3], table[:, 2], table[:, 0]))
    return table[order]


class IncrementalChangeDetector:
    """The streamed ``detect_scene_changes_np`` + ``scene_change_events``,
    behind the live ``watch --events`` feed.

    ``step`` takes ONE sweep's track column (the coasting-hold [T] outputs
    of ``track_sweep_step_np``, or one row of the device session's track
    rings) and that sweep's unwrapped CLK anchor, and returns the event
    rows the batch detector gives that sweep.  The four detectors are
    cumulative per-sweep predicates, so this state (observation counts, the
    last observed sweep, the previous column, the previous dominant track)
    is enough: the ``step`` outputs over all sweeps, concatenated, equal the
    batch table row for row, at O(T) per sweep however many have closed.
    """

    def __init__(self, n_tracks: int, min_persist: int = 3, min_gone: int = 3,
                 jump_deg: float = 5.0) -> None:
        t_n = int(n_tracks)
        self._mp = int(min_persist)
        self._mg = int(min_gone)
        self._j2 = np.float32(jump_deg) ** 2   # the batch detector's literal
        self._s = 0
        self._cum = np.zeros(t_n, np.int64)        # observations so far
        self._last = np.full(t_n, -1, np.int64)    # last observed sweep
        self._prev_a = np.zeros(t_n, np.float32)   # previous column (positions)
        self._prev_d = np.zeros(t_n, np.float32)
        self._prev_dom = -1                        # dominant track at the last observing sweep

    @property
    def n_sweeps(self) -> int:
        return self._s

    def step(self, col_aoa, col_aod, col_pow, col_obs, time) -> np.ndarray:
        """Feed sweep ``n_sweeps``'s column; returns [N, 7] float64 event
        rows (sweep, clk, kind, track, aoa, aod, power) in the batch table's
        order (kind, then track, within the sweep)."""
        a = np.asarray(col_aoa, np.float32)
        d = np.asarray(col_aod, np.float32)
        p = np.asarray(col_pow, np.float32)
        obs = np.asarray(col_obs, bool)
        s = self._s
        prev_last = self._last
        prev_cum = self._cum
        cum = prev_cum + obs
        last = np.where(obs, np.int64(s), prev_last)

        birth = obs & (cum == self._mp)
        miss = np.where(last >= 0, s - last, np.int64(0))
        death = (last >= 0) & (miss == self._mg) & (cum >= self._mp)
        if s > 0:
            da = a - self._prev_a
            dd = d - self._prev_d
            disp2 = da * da + dd * dd
            jump = obs & (prev_last >= 0) & (disp2 > self._j2) & (prev_cum >= self._mp)
        else:
            jump = np.zeros_like(obs)

        rows = []
        tt = float(time)
        for kind, mask in enumerate((birth, death, jump)):
            for t in np.nonzero(mask)[0]:
                rows.append([s, tt, kind, t, float(a[t]), float(d[t]), float(p[t])])
        if obs.any():
            dom = int(np.argmax(np.where(obs, p, -np.inf)))
            if self._prev_dom >= 0 and dom != self._prev_dom:
                rows.append([s, tt, 3, dom, float(a[dom]), float(d[dom]), float(p[dom])])
            self._prev_dom = dom

        self._cum = cum
        self._last = last
        self._prev_a = a
        self._prev_d = d
        self._s = s + 1
        if not rows:
            return np.zeros((0, 7), np.float64)
        return np.asarray(rows, np.float64)
