"""Track-trajectory figure: AoA / AoD against CLK time per track.

A copy of ``slam_process_tpu/render/tracks.py``: each track's angular
trajectory (``models/tracking.Tracks``) against the testbed's 30-bit CLK
counter, with its fitted angular velocity in the legend.  matplotlib is
imported inside the function: the card's machine has none, and importing
this module must not need it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

__all__ = ["save_track_figure"]


def save_track_figure(
    tracks,                  # models.tracking.Tracks
    times: np.ndarray,       # [S] CLK per sweep (-1 missing)
    output_path: Union[str, Path],
    velocities=None,         # optional (vel_aoa, vel_aod, ok)
    title: Optional[str] = None,
    dpi: int = 150,
) -> Path:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    times = np.asarray(times, np.float64)
    t0 = times[times >= 0].min() if np.any(times >= 0) else 0.0
    rel = times - t0

    fig, (ax_a, ax_d) = plt.subplots(2, 1, figsize=(10, 8), sharex=True)
    cmap = plt.get_cmap("tab10")
    n = int(tracks.n_tracks)
    for t in range(n):
        obs = np.asarray(tracks.observed[t], bool) & (times >= 0)
        if not obs.any():
            continue
        x = rel[obs]
        color = cmap(t % 10)
        label = f"track {t}"
        if velocities is not None and velocities[2][t]:
            label += (f" ({velocities[0][t]:+.2e}, "
                      f"{velocities[1][t]:+.2e} deg/tick)")
        ax_a.plot(x, tracks.pos_aoa[t][obs], "o-", color=color, label=label,
                  markersize=4)
        ax_d.plot(x, tracks.pos_aod[t][obs], "o-", color=color,
                  markersize=4)
    ax_a.set_ylabel("AoA (deg)")
    ax_d.set_ylabel("AoD (deg)")
    ax_d.set_xlabel("CLK ticks since first sweep")
    ax_a.grid(alpha=0.3)
    ax_d.grid(alpha=0.3)
    if n:
        ax_a.legend(fontsize=8, loc="best")
    ax_a.set_title(title or f"Path tracks ({n} tracks)")
    fig.tight_layout()
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=dpi)
    plt.close(fig)
    return output_path
