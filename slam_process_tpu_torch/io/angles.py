"""Beam-ID -> physical-angle mapping (a copy of
``slam_process_tpu/io/angles.py``).

The testbed's 64 beams map to angles -43.6 deg .. +45.0 deg (~1.4 deg
pitch) through a two-column (BeamID, Angle) xlsx table, with or without a
header row.  The dense artifact is a float32 LUT of length ``n_beams``
(NaN = unmapped).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

import numpy as np

from slam_process_tpu_torch.io.xlsx import read_xlsx_table


def load_angle_map(path: Union[str, Path]) -> Dict[int, float]:
    """Load BeamID -> angle (deg) as a dict, with or without a header row."""
    _, data = read_xlsx_table(path, header=False)
    if data.shape[1] < 2:
        raise ValueError(f"angle map needs >=2 columns, got {data.shape[1]}")
    mapping: Dict[int, float] = {}
    for bid, ang in data[:, :2]:
        if np.isnan(bid) or np.isnan(ang):
            continue  # a header row or junk parses as NaN
        mapping[int(round(bid))] = float(ang)
    if not mapping:
        raise ValueError(f"no numeric (BeamID, Angle) rows in {path}")
    return mapping


def angle_lut(mapping: Dict[int, float], n_beams: int = 64) -> np.ndarray:
    """Dense float32 LUT: lut[beam_id] = angle, NaN where unmapped."""
    lut = np.full(n_beams, np.nan, dtype=np.float32)
    for bid, ang in mapping.items():
        if 0 <= bid < n_beams:
            lut[bid] = ang
    return lut


def load_angle_lut(path: Union[str, Path], n_beams: int = 64) -> np.ndarray:
    return angle_lut(load_angle_map(path), n_beams)
