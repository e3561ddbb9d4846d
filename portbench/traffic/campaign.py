"""The one traffic generator: a measurement campaign of seeded logs.

A configuration file (``portbench/configs/<config>.json``) fixes the
campaign's shape: its logs' frame counts, the frames per beam, the
oversized first group, the baselines per group, the junk share and the
planted paths.  A seed orders the logs and makes their bytes.  The
campaigns of a seed share each log's layout (where junk bytes fall
between frames, and which), so a log has the same byte length in each,
and differ in the frames (CLK, RSS, baseline positions).  Everything comes
from ``numpy.random`` seeded by (seed, log) for the layout and (seed,
campaign, log) for the frames, so the same seed gives the same bytes.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from portbench.traffic.synthetic import _JUNK, synthetic_session_bytes

HEAD = 2           # the generator's leading non-frame bytes


class LogShape(NamedTuple):
    n_groups: int
    frames: int          # valid frames the log holds (the generator writes exactly these)


def _entropy(seed: int) -> int:
    return int(seed) & ((1 << 64) - 1)


def log_seed(seed: int, campaign: int, log: int) -> int:
    """The generator seed of one log's frames in one campaign."""
    ss = np.random.SeedSequence([_entropy(seed), 0x5EED, int(campaign), int(log)])
    return int(ss.generate_state(1, np.uint32)[0])


def layout_seed(seed: int, log: int) -> int:
    """The seed of one log's junk layout, shared by the seed's campaigns."""
    ss = np.random.SeedSequence([_entropy(seed), 0x1A70, int(log)])
    return int(ss.generate_state(1, np.uint32)[0])


def frames_of(cfg: dict, n_groups: int) -> int:
    return 64 * (-(-cfg["big_group_frames"] // 64) + (n_groups - 1) * cfg["frames_per_beam"])


def log_shapes(cfg: dict, seed: int) -> List[LogShape]:
    """The configuration's fixed per-log frame counts (``log_frames``,
    whole sweep groups) in an order drawn from ``seed``: every seed replays
    the same sizes, so a seed changes the bytes and the order, not the
    amount of work."""
    per_group = 64 * cfg["frames_per_beam"]
    out = []
    for frames in cfg["log_frames"]:
        g = (frames - frames_of(cfg, 1)) // per_group + 1
        if frames_of(cfg, g) != frames or not cfg["frames_min"] <= frames <= cfg["frames_max"]:
            raise ValueError(f"{frames} frames is no whole number of sweep groups in range")
        out.append(LogShape(int(g), int(frames)))
    order = np.random.default_rng(np.random.SeedSequence([_entropy(seed), 0x5123])).permutation(
        len(out))
    return [out[i] for i in order]


def make_log(cfg: dict, shape: LogShape, seed: int, layout: int) -> np.ndarray:
    """One log: the generator's frames of ``seed`` (written without junk),
    laid out with the junk that ``layout`` draws by the generator's rule
    (after each frame, with probability ``junk_frac``, 1-12 bytes that are
    never a flag byte)."""
    raw = synthetic_session_bytes(
        n_groups=shape.n_groups, frames_per_beam=cfg["frames_per_beam"],
        baselines_per_group=cfg["baselines_per_group"], junk_frac=0.0,
        big_group=cfg["big_group_frames"], seed=seed, n_paths=cfg["n_paths"])
    frames = raw[HEAD:].reshape(-1, 11)
    n = len(frames)
    rng = np.random.default_rng(layout)
    junk = np.where(rng.random(n) < cfg["junk_frac"], rng.integers(1, 13, n), 0)
    offsets = HEAD + np.concatenate([[0], np.cumsum(11 + junk)[:-1]])
    out = rng.choice(_JUNK, int(HEAD + 11 * n + junk.sum()))
    out[offsets[:, None] + np.arange(11)] = frames
    return out


def make_campaign(cfg: dict, shapes: List[LogShape], seed: int, campaign: int) -> list:
    """The logs of one campaign, uint8 byte arrays in log order."""
    return [make_log(cfg, s, log_seed(seed, campaign, i), layout_seed(seed, i))
            for i, s in enumerate(shapes)]
