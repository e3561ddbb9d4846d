"""Session orchestration: one capture session through the device pipeline.

``Session.from_log`` fills ``frames``, ``corrected_bs`` and ``filtered``
as ``slam_process_tpu/pipeline/session.py``'s device engine does.  The
host engine is not ported yet, so where the JAX package falls back to it
on a corrector overflow, this raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from slam_process_tpu_torch.io import read_hex_log
from slam_process_tpu_torch.pipeline.device import run_session_on_device

MAX_GROUPS = 256
MAX_BASELINES_PER_GROUP = 256


class Session:
    """One serial-debug capture session, decoded and corrected."""

    def __init__(self, name: str = "session"):
        self.name = name
        self.frames: Optional[np.ndarray] = None        # [F, 5] int64
        self.corrected_bs: Optional[np.ndarray] = None  # [F] int64
        self.filtered: Optional[np.ndarray] = None      # [K, 4] int64

    @classmethod
    def from_log(cls, path: Union[str, Path], engine: str = "device",
                 device=None) -> "Session":
        """Load, decode and correct a raw log on ``device`` (None: CUDA)."""
        if engine != "device":
            raise ValueError(f"engine {engine!r} is not ported; only 'device' is")
        s = cls(name=Path(path).stem)
        raw = read_hex_log(path)
        out = run_session_on_device(raw, max_groups=MAX_GROUPS,
                                    max_baselines_per_group=MAX_BASELINES_PER_GROUP,
                                    device=device)
        if bool(out.correct_overflow):
            raise RuntimeError(
                f"{path}: the device corrector's bounds were exceeded (more than "
                f"max_groups={MAX_GROUPS} sweep groups or more than "
                f"max_baselines_per_group={MAX_BASELINES_PER_GROUP} baselines in a "
                "group); the host engine that would take over is not ported")
        valid = out.frame_valid.cpu().numpy()
        s.frames = out.frames.cpu().numpy()[valid].astype(np.int64)
        corrected = out.corrected_bs.cpu().numpy()[valid].astype(np.int64)
        keep = out.keep.cpu().numpy()[valid]
        if len(s.frames) != int(out.n_frames):
            raise RuntimeError("decoded frame count disagrees with the valid rows")
        s.corrected_bs = corrected
        s.filtered = np.stack([s.frames[keep, 1], corrected[keep], s.frames[keep, 3],
                               s.frames[keep, 4]], axis=1)
        return s
