"""The plain reference of a log's pipeline: decode, correct, grid, raster.

Plain NumPy and PyTorch, written from the wire format and the
reference scripts' semantics (the JAX package's float64 oracles
``decode_frames_np``, ``correct_frames_np``, ``intensity_grid_np``,
``blur_nan_aware_np`` and ``shifted_log_norm``, copied without JAX).
It imports nothing of the program and takes nothing the program made:
the colormap is its own copy of matplotlib's 256-entry viridis table.

The integer stages (decode, correct, counts) are exact.  The float
stages take a ``dtype``: float64 is the reference; a lower one
(bfloat16) is the control that ``portbench/control.py`` runs in the
program's place.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

FLAG_TRUE, FLAG_FALSE = 0xCC, 0x33
FRAME_LEN = 11
# Tag classes (the top two bits) of frame offsets 1..10: UE, BS, CLK x5, RSS x3.
_OFFSET_TAGS = (0b00, 0b11, 0b01, 0b01, 0b01, 0b01, 0b01, 0b10, 0b10, 0b10)
LUT = np.load(Path(__file__).with_name("viridis_256.npy")).astype(np.float64)


class Frames(NamedTuple):
    starts: np.ndarray    # [F] int64 byte offset of each frame
    flag: np.ndarray      # [F] int64 (1: baseline marker 0xCC)
    ue: np.ndarray
    bs: np.ndarray
    rss: np.ndarray
    clk: np.ndarray       # 30-bit counter


def decode(b: np.ndarray) -> Frames:
    """Every position that starts a fully valid 11-byte window is a frame
    (two valid starts are never closer than 11 bytes, so this equals the
    reference's greedy cursor)."""
    b = np.asarray(b, dtype=np.uint8)
    n = b.shape[0]
    ok = (b == FLAG_TRUE) | (b == FLAG_FALSE)
    top = b >> 6
    for d, tag in enumerate(_OFFSET_TAGS, start=1):
        shifted = np.zeros(n, dtype=bool)
        m = max(n - d, 0)
        shifted[:m] = top[d:d + m] == tag
        ok &= shifted
    starts = np.nonzero(ok)[0]
    w = b[starts[:, None] + np.arange(FRAME_LEN)].astype(np.int64)
    clk = np.zeros(len(starts), dtype=np.int64)
    for k in range(5):
        clk |= (w[:, 3 + k] & 0x3F) << (6 * k)
    rss = (w[:, 8] & 0x3F) | ((w[:, 9] & 0x3F) << 6) | ((w[:, 10] & 0x3F) << 12)
    return Frames(starts.astype(np.int64), (w[:, 0] == FLAG_TRUE).astype(np.int64),
                  w[:, 1] & 0x3F, w[:, 2] & 0x3F, rss, clk)


def groups_of(ue: np.ndarray) -> np.ndarray:
    """Sweep group id per row: a UE decrease starts a group."""
    boundary = np.ones(len(ue), dtype=bool)
    if len(ue) > 1:
        boundary[1:] = ue[:-1] > ue[1:]
    return np.cumsum(boundary) - 1


class Corrected(NamedTuple):
    corrected: np.ndarray     # [F] int64 corrected BS (raw BS where none)
    keep: np.ndarray          # [F] bool: a FLAG=0 row with an accepted baseline
    n_groups: int
    n_baselines: int
    max_baselines: int        # most baselines in one group
    candidates: np.ndarray    # [F] baselines of the row's group within tol (K2's work)
    group_baselines: np.ndarray   # [F] baselines of the row's group


def correct(fr: Frames, cycle: int = 61_000, tol: int = 500, mod: int = 64,
            device="cpu", rows_per_block: int = 1 << 15) -> Corrected:
    """The CLK-based BS-beam correction: baselines are FLAG 0->1 rows whose
    RSS equals the previous row's in the same group, anchored at the
    previous row's CLK; a FLAG=0 row takes the min-residual baseline of its
    group within ``tol`` of a whole number of cycles (first baseline on a
    tie), corrected = (bs_b + k) % mod.  Integer arithmetic, in blocks of
    rows on ``device``."""
    n = len(fr.ue)
    gid = groups_of(fr.ue)
    n_groups = int(gid[-1]) + 1 if n else 0
    mask = np.zeros(n, dtype=bool)
    if n > 1:
        mask[1:] = ((fr.flag[1:] == 1) & (fr.flag[:-1] == 0) & (fr.rss[1:] == fr.rss[:-1])
                    & (gid[1:] == gid[:-1]))
    idx = np.nonzero(mask)[0]
    b_gid, b_clk, b_bs = gid[idx], fr.clk[idx - 1], fr.bs[idx]
    counts = np.bincount(b_gid, minlength=n_groups) if n_groups else np.zeros(0, np.int64)
    corrected = fr.bs.copy()
    keep = np.zeros(n, dtype=bool)
    cand = np.zeros(n, dtype=np.int64)
    per_row_b = counts[gid] if n else np.zeros(0, np.int64)
    if b_gid.size:
        bmax = int(counts.max())
        offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(len(b_gid)) - offs[b_gid]
        tbl_clk = np.zeros((n_groups, bmax), dtype=np.int64)
        tbl_bs = np.zeros((n_groups, bmax), dtype=np.int64)
        tbl_ok = np.zeros((n_groups, bmax), dtype=bool)
        tbl_clk[b_gid, rank] = b_clk
        tbl_bs[b_gid, rank] = b_bs
        tbl_ok[b_gid, rank] = True
        dev = torch.device(device)
        t_clk, t_bs, t_ok = (torch.from_numpy(x).to(dev) for x in (tbl_clk, tbl_bs, tbl_ok))
        col = torch.arange(bmax, device=dev)
        for lo in range(0, n, rows_per_block):
            hi = min(lo + rows_per_block, n)
            g = torch.from_numpy(gid[lo:hi]).to(dev)
            c = torch.from_numpy(fr.clk[lo:hi]).to(dev)
            d = c[:, None] - t_clk[g]
            k = torch.div(d + cycle // 2, cycle, rounding_mode="floor")
            resid = (d - k * cycle).abs()
            accept = (resid <= tol) & t_ok[g]
            score = torch.where(accept, resid * (bmax + 1) + col, torch.tensor(1 << 60, device=dev))
            best = score.argmin(dim=1)
            rows = torch.arange(hi - lo, device=dev)
            has = accept[rows, best]
            cand_bs = (t_bs[g, best] + k[rows, best]) % mod
            normal = torch.from_numpy(fr.flag[lo:hi] == 0).to(dev)
            ok = (normal & has).cpu().numpy()
            corrected[lo:hi] = np.where(ok, cand_bs.cpu().numpy(), corrected[lo:hi])
            keep[lo:hi] = ok
            cand[lo:hi] = accept.sum(dim=1).cpu().numpy()
        max_b = bmax
    else:
        max_b = 0
    return Corrected(corrected, keep, n_groups, int(b_gid.size), max_b, cand, per_row_b)


def cell_sums(ue, bs, rss, n_beams: int = 64):
    """(sums [n, n] int64, counts [n, n] int64) of RSS per (UE, BS) cell."""
    cell = np.asarray(ue, np.int64) * n_beams + np.asarray(bs, np.int64)
    counts = np.bincount(cell, minlength=n_beams * n_beams).astype(np.int64)
    sums = np.zeros(n_beams * n_beams, np.int64)
    np.add.at(sums, cell, np.asarray(rss, np.int64))
    return sums.reshape(n_beams, n_beams), counts.reshape(n_beams, n_beams)


def gaussian_taps(sigma: float) -> np.ndarray:
    """2-D Gaussian kernel, size max(3, ceil(6 sigma)) forced odd, sum 1."""
    if sigma <= 0:
        return np.ones((1, 1))
    size = int(max(3, math.ceil(6 * sigma)))
    size += size % 2 == 0
    c = size // 2
    y, x = np.ogrid[-c:c + 1, -c:c + 1]
    k = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    return k / k.sum()


def raster(mean: torch.Tensor, sigma: float, dtype=torch.float64):
    """[L, H, W] mean tiles (NaN empty) -> (rgba [L, H, W, 4], norm_t,
    blurred), every float step in ``dtype``: the NaN-aware blur with edge
    replication (sum(x k m) / sum(k m), NaN where the weight is ~0), the
    shifted log norm (x - min + 1e-6 over its range, clipped to [0, 1]) and
    the colormap with matplotlib's index rule (NaN: transparent)."""
    x = mean.to(dtype)
    taps = torch.as_tensor(gaussian_taps(sigma), dtype=dtype, device=x.device)
    kh, kw = taps.shape
    h, w = x.shape[-2:]
    finite = torch.isfinite(x)
    rows = torch.arange(-(kh // 2), h + kh // 2, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-(kw // 2), w + kw // 2, device=x.device).clamp(0, w - 1)
    pv = torch.where(finite, x, torch.zeros((), dtype=dtype, device=x.device))[..., rows, :][..., cols]
    pm = finite.to(dtype)[..., rows, :][..., cols]
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for dy in range(kh):
        for dx in range(kw):
            num = num + taps[dy, dx] * pv[..., dy:dy + h, dx:dx + w]
            den = den + taps[dy, dx] * pm[..., dy:dy + h, dx:dx + w]
    nan = torch.tensor(float("nan"), dtype=dtype, device=x.device)
    blurred = torch.where(den > 1e-12, num / den.clamp(min=1e-30), nan)
    fin = torch.isfinite(blurred)
    mn = torch.where(fin, blurred, float("inf")).amin(dim=(-2, -1), keepdim=True)
    mx = torch.where(fin, blurred, float("-inf")).amax(dim=(-2, -1), keepdim=True)
    eps = torch.tensor(1e-6, dtype=dtype, device=x.device)
    log_lo = torch.log(eps)
    log_hi = torch.log((mx - mn + eps).clamp(min=1e-30))
    t = (torch.log((blurred - mn + eps).clamp(min=1e-30)) - log_lo) / (log_hi - log_lo).clamp(min=1e-30)
    norm_t = torch.where(fin, t.clamp(0.0, 1.0), nan)
    lut = torch.as_tensor(LUT, device=x.device)
    n = lut.shape[0]
    idx = (torch.where(fin, norm_t, 0.0).double() * n).to(torch.int64).clamp(0, n - 1)
    rgba = torch.where(fin[..., None], lut[idx], 0.0)
    return rgba, norm_t, blurred


class LogRef(NamedTuple):
    """What the reference says of one log."""

    n_bytes: int
    n_flags: int              # bytes that are a flag value (K1's work)
    frames: Frames
    corr: Corrected
    sums: np.ndarray          # [64, 64] int64 over the kept rows
    counts: np.ndarray        # [64, 64] int64
    overflow: bool            # the corrector's bounds exceeded

    @property
    def n_frames(self) -> int:
        return len(self.frames.ue)

    @property
    def n_kept(self) -> int:
        return int(self.corr.keep.sum())


def log_reference(raw: np.ndarray, cfg: dict, device="cpu") -> LogRef:
    """Decode, correct and grid one log; ``cfg`` is the configuration."""
    b = np.asarray(raw, np.uint8)
    fr = decode(b)
    corr = correct(fr, cfg["cycle_ticks"], cfg["correct_tol_ticks"], 64, device)
    k = corr.keep
    sums, counts = cell_sums(fr.ue[k], corr.corrected[k], fr.rss[k])
    bounds = cfg["bounds"]
    overflow = (corr.n_groups > bounds["max_groups"]
                or corr.max_baselines > bounds["max_baselines_per_group"])
    return LogRef(len(b), int(((b == FLAG_TRUE) | (b == FLAG_FALSE)).sum()), fr, corr,
                  sums, counts, bool(overflow))


def mean_grid(sums: np.ndarray, counts: np.ndarray, dtype=torch.float64) -> torch.Tensor:
    """Cell means (NaN where a cell has no row), computed in ``dtype``."""
    s = torch.as_tensor(sums).to(dtype)
    c = torch.as_tensor(counts).to(dtype)
    return torch.where(torch.as_tensor(counts) > 0, s / c.clamp(min=1),
                       torch.tensor(float("nan"), dtype=dtype))
