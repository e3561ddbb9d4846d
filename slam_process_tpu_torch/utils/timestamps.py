"""Session timestamps from file names, and CLK sweep-anchor unwrapping.

A copy of ``slam_process_tpu/utils/timestamps.py``'s ``extract_timestamp``
and ``unwrap_clk_anchors``.  File names look like
``Serial Debug 2026-01-26 164520_filtered.xlsx`` -> ``2026-01-26 164520``.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

_TS_RE = re.compile(r"(\d{4}-\d{2}-\d{2}\s+\d{6})")
_TS_RE2 = re.compile(r"(\d{4}-\d{2}-\d{2})[_\s]+(\d{6})")


def extract_timestamp(path: str) -> Optional[str]:
    """Return ``YYYY-MM-DD HHMMSS`` from a session file name, or None."""
    filename = os.path.basename(str(path))
    m = _TS_RE.search(filename)
    if m:
        return m.group(1)
    m2 = _TS_RE2.search(filename)
    if m2:
        return f"{m2.group(1)} {m2.group(2)}"
    return None


def unwrap_clk_anchors(times, logger=None) -> np.ndarray:
    """Unwrap 30-bit CLK sweep anchors onto a monotone axis (a copy).

    ``times`` holds int64 per-sweep CLK anchors (-1 = sweep with no rows).
    Only decreases consistent with a counter wrap (a drop of more than half
    the 2^30 period) unwrap; smaller decreases are counter resets or
    out-of-order anchors and are left as they are, with a warning.
    """
    times = np.array(times, dtype=np.int64, copy=True)
    obs = times >= 0
    if obs.sum() > 1:
        t = times[obs]
        d = np.diff(t)
        wrap = (d < 0) & (-d > (1 << 29))
        odd = (d < 0) & ~wrap
        if odd.any() and logger is not None:
            logger.warning(
                "sweep anchors: %d non-wrap CLK decrease(s) between sweeps (counter "
                "reset or out-of-order anchor); timestamps left unadjusted", int(odd.sum()))
        wraps = np.cumsum(np.concatenate([[0], wrap]))
        times[obs] = t + (wraps.astype(np.int64) << 30)
    return times
