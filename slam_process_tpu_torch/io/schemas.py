"""Frame-table schemas and tolerant readers of the legacy xlsx artifacts.

A copy of ``slam_process_tpu/io/schemas.py``.  The pipeline's layouts:

    frames[F, 5] int64 with columns (FLAG, UE, BS, RSS, CLK)      (decoded)
    filtered[F, 4] int64 with columns (UE, BS, RSS, CLK)          (corrected)

On disk, Parsed files carry the v3 headers (``PARSED_COLUMNS``); filtered
files come in several header and column-order variants
(``UE_Beam, BS_Beam, RSS值, CLK值[, CLK差值]``, ``UE_Beam, BS_Beam, CLK值,
RSS`` ...).  One tolerant reader per table matches columns by name, falls
back to position, and normalises all of them; the writers emit one schema.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from slam_process_tpu_torch.io.xlsx import read_xlsx_table, write_xlsx_table

# The v3 Parsed schema.
PARSED_COLUMNS: List[str] = [
    "FLAG",
    "UE_Beam[5:0]十进制",
    "BS_Beam[5:0]十进制",
    "RSS十进制",
    "CLK十进制",
]

# The filtered schema.
FILTERED_COLUMNS: List[str] = ["UE_Beam", "BS_Beam", "RSS值", "CLK值"]


def _match_column(names: List[str], *keys: str) -> int:
    """Index of the first column whose name contains any key (by key
    order), or -1."""
    upper = [str(n).upper() for n in names]
    for key in keys:
        for i, n in enumerate(upper):
            if key.upper() in n:
                return i
    return -1


def read_parsed_table(path: Union[str, Path], sheet: int = 0) -> np.ndarray:
    """Read a Parsed xlsx -> frames[F, 5] int64 (flag, ue, bs, rss, clk);
    the first five columns where a name is not found."""
    names, data = read_xlsx_table(path, sheet=sheet)
    idx = [_match_column(names, key) for key in ("FLAG", "UE_Beam", "BS_Beam", "RSS", "CLK")]
    if any(i < 0 for i in idx):
        idx = list(range(5))
    return _to_int_rows(data[:, idx], nan_flag_to_zero=True)


def read_filtered_table(path: Union[str, Path], sheet: int = 0) -> np.ndarray:
    """Read any filtered xlsx variant -> filtered[F, 4] int64 (ue, bs, rss,
    clk): names first ("CLK差值", the CLK difference, is never the CLK
    column), positions last; CLK 0 where the file has none."""
    names, data = read_xlsx_table(path, sheet=sheet)
    upper = [str(n).upper() for n in names]
    ue = _match_column(names, "UE_BEAM", "UE")
    bs = _match_column(names, "BS_BEAM", "BS")
    rss = _match_column(names, "RSS值", "RSS", "POWER")
    clk = next((i for i, n in enumerate(upper) if "CLK" in n and "差" not in str(names[i])),
               -1)
    if min(ue, bs, rss) < 0:
        ue, bs, rss = 0, 1, 2
        clk = 3 if data.shape[1] > 3 else -1
    out = data[:, [ue, bs, rss] + ([clk] if clk >= 0 else [])]
    if clk < 0:
        out = np.concatenate([out, np.zeros((out.shape[0], 1))], axis=1)
    return _to_int_rows(out)


def _to_int_rows(out: np.ndarray, nan_flag_to_zero: bool = False) -> np.ndarray:
    """NaN cells of legacy files before the int cast: a NaN FLAG counts as
    0, a NaN anywhere else drops the row (an unparseable CLK row is
    skipped); the rest is rounded to int64."""
    out = np.asarray(out, dtype=np.float64)
    if nan_flag_to_zero and out.shape[1] >= 1:
        out[np.isnan(out[:, 0]), 0] = 0.0
    good = ~np.isnan(out).any(axis=1)
    return np.rint(out[good]).astype(np.int64)


def write_parsed_table(path: Union[str, Path], frames: np.ndarray) -> Path:
    """Write frames[F, 5] in the v3 Parsed schema."""
    return write_xlsx_table(path, PARSED_COLUMNS, np.asarray(frames), "Parsed")


def write_filtered_table(path: Union[str, Path], filtered: np.ndarray) -> Path:
    """Write filtered[F, 4] in the filtered schema."""
    return write_xlsx_table(path, FILTERED_COLUMNS, np.asarray(filtered), "Sheet1")


def split_frames(frames: np.ndarray) -> Tuple[np.ndarray, ...]:
    """frames[F, 5] -> (flag, ue, bs, rss, clk) column views."""
    f = np.asarray(frames)
    return f[:, 0], f[:, 1], f[:, 2], f[:, 3], f[:, 4]
