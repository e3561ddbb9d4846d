"""Seeded synthetic capture sessions in the 11-byte v3 wire format.

The logic follows the JAX package's ``__graft_entry__._synthetic_log_bytes``
(copied, not imported): sweep groups of 64 UE beams, FLAG=0 frames with
the BS=0x3F placeholder, CLK advancing one beam cycle (61,000 ticks, with
jitter) per frame, and FLAG=1 baseline frames that repeat the previous
row's RSS and carry the true BS beam.  Beyond that generator it adds:

  * junk bytes between frames (never a flag byte 0xCC/0x33, so the set of
    valid frames is exactly the set written), exercising the resync;
  * an exact count of baselines per group;
  * one oversized group (``big_group`` frames, e.g. > 4,096);
  * optionally (``n_paths`` > 0), RSS from a seeded multipath scene
    instead of uniform noise: a few Gaussian-beam paths over the 64-beam
    angle table, drifting slowly across sweeps, plus noise;
  * ``to_hex_text``, the serial-log text form that ``read_hex_log`` reads
    (the shipped logs' stride-3 layout, or lines of 16 tokens),
    and ``write_angle_table``, the beam -> angle xlsx table (optionally
    with unmapped beams);
  * ``with_flag_junk``: bursts of bytes dense in flag bytes spliced into a
    stream, so the decoder discards (and ``legacy_stream_bytes``, streams
    in the older v1 / v2 wire formats);
  * the kernels' edge cases (``verdict_edge_cases``, ``decode_edge_cases``,
    ``sweep_sums_edge_cases``, ``nnls_edge_cases``) and their stream axes'
    (``decode_stream_cases``, ``track_stream_cases``).

All randomness comes from ``numpy.random.default_rng(seed)`` (the
multipath scene from a second stream of the same seed, so the default
output does not depend on it).
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

CYCLE = 61_000
ANGLES = np.linspace(-43.6, 45.0, 64)   # the testbed's beam -> angle table (deg)
_JUNK = np.setdiff1d(np.arange(256), [0x33, 0xCC]).astype(np.uint8)


def synthetic_session_bytes(n_groups: int = 4, frames_per_beam: int = 2,
                            baselines_per_group: int = 4,
                            junk_frac: float = 0.05, big_group: int = 0,
                            seed: int = 0, n_paths: int = 0) -> np.ndarray:
    """One session as a uint8 byte stream.

    ``n_groups`` sweep groups of 64 beams x ``frames_per_beam`` frames;
    when ``big_group`` > 0 the first group instead holds 64 x
    ceil(big_group / 64) frames.  Every group holds exactly
    ``baselines_per_group`` baseline frames, at odd in-group positions so
    each follows a FLAG=0 row of its own group.  After each frame, with
    probability ``junk_frac``, 1-12 junk bytes follow.  With ``n_paths``
    > 0 the RSS comes from ``multipath_rss`` over the beam the corrector
    reconstructs for each frame.
    """
    rng = np.random.default_rng(seed)
    per_beam = np.full(n_groups, frames_per_beam, dtype=np.int64)
    if big_group > 0:
        per_beam[0] = -(-big_group // 64)
    sizes = 64 * per_beam
    if baselines_per_group > int(sizes.min()) // 2:
        raise ValueError(f"{baselines_per_group} baselines do not fit a group "
                         f"of {int(sizes.min())} frames")

    ue = np.concatenate([np.repeat(np.arange(64), k) for k in per_beam])
    n = ue.size
    flag = np.zeros(n, dtype=bool)
    start = 0
    for size in sizes:
        odd = np.arange(1, size, 2)
        flag[start + rng.choice(odd, baselines_per_group, replace=False)] = True
        start += size

    clk = 1_000_000 + np.cumsum(CYCLE + rng.integers(-200, 200, n))
    rss = rng.integers(1, 1 << 18, n)
    if n_paths > 0:
        group = np.repeat(np.arange(n_groups), sizes)
        rss = multipath_rss(ue, (8 + clk // CYCLE) % 64, group, n_paths, seed)
    rss[flag] = rss[np.nonzero(flag)[0] - 1]          # baseline repeats RSS
    bs = np.where(flag, (7 + clk // CYCLE) % 64, 0x3F)

    frames = np.empty((n, 11), dtype=np.uint8)
    frames[:, 0] = np.where(flag, 0xCC, 0x33)
    frames[:, 1] = ue & 0x3F
    frames[:, 2] = 0xC0 | (bs & 0x3F)
    for k in range(5):
        frames[:, 3 + k] = 0x40 | ((clk >> (6 * k)) & 0x3F)
    for k in range(3):
        frames[:, 8 + k] = 0x80 | ((rss >> (6 * k)) & 0x3F)

    junk = np.where(rng.random(n) < junk_frac, rng.integers(1, 13, n), 0)
    head = 2                                          # a leading non-frame marker
    offsets = head + np.concatenate([[0], np.cumsum(11 + junk)[:-1]])
    out = rng.choice(_JUNK, int(head + 11 * n + junk.sum()))
    out[offsets[:, None] + np.arange(11)] = frames
    return out


def multipath_rss(ue: np.ndarray, bs: np.ndarray, sweep: np.ndarray, n_paths: int,
                  seed: int = 0) -> np.ndarray:
    """Integer RSS in [1, 2^18) of frames (ue, bs, sweep) in a scene of
    ``n_paths`` Gaussian-beam paths (FWHM 1.4 deg, the estimator's beam
    width, over ``ANGLES``): each path's (AoA, AoD) drifts up to 0.1 deg
    per sweep, power 1 for the first path and 0.2-0.8 for the others, a
    floor of 0.02, Gaussian noise of 0.01; scaled by 2^17."""
    rng = np.random.default_rng([seed, 1])
    start = rng.uniform(-35.0, 35.0, (2, n_paths))
    drift = rng.uniform(-0.1, 0.1, (2, n_paths))
    power = np.concatenate([[1.0], rng.uniform(0.2, 0.8, n_paths - 1)])
    aoa = start[0] + drift[0] * sweep[:, None]                 # [F, P]
    aod = start[1] + drift[1] * sweep[:, None]
    sigma2 = 2.0 * (1.4 / 2.355) ** 2
    gain = (power * np.exp(-(ANGLES[ue][:, None] - aoa) ** 2 / sigma2)
            * np.exp(-(ANGLES[bs][:, None] - aod) ** 2 / sigma2)).sum(axis=1)
    level = 0.02 + gain + rng.normal(0.0, 0.01, len(ue))
    return np.clip(np.rint(level * (1 << 17)), 1, (1 << 18) - 1).astype(np.int64)


def write_angle_table(path: Union[str, Path], unmapped=()) -> Path:
    """Write the (BeamID, Angle) table of ``ANGLES`` as xlsx, one row per
    beam except the ``unmapped`` beam ids."""
    from slam_process_tpu_torch.io.xlsx import write_xlsx_table

    ids = np.setdiff1d(np.arange(len(ANGLES)), np.asarray(unmapped, dtype=np.int64))
    return write_xlsx_table(path, ["BeamID", "Angle"], np.stack([ids, ANGLES[ids]], axis=1))


def with_flag_junk(raw: np.ndarray, n_bursts: int = 20, cut: int = 5, seed: int = 0,
                   flags=(0xCC, 0x33)) -> np.ndarray:
    """``raw`` with ``n_bursts`` bursts of 1-30 bytes spliced in at random
    offsets (frames cut in two included), each byte a flag byte with
    probability 1/2 and otherwise a byte of any tag class, and the last
    ``cut`` bytes dropped (a truncated tail): input on which the decoder
    discards flag bytes."""
    rng = np.random.default_rng(seed)
    raw = np.asarray(raw, dtype=np.uint8)
    at = np.sort(rng.integers(0, len(raw) + 1, n_bursts))
    parts, prev = [], 0
    for a in at:
        n = int(rng.integers(1, 31))
        burst = np.where(rng.random(n) < 0.5, rng.choice(np.asarray(flags, np.uint8), n),
                         rng.integers(0, 256, n)).astype(np.uint8)
        parts += [raw[prev:a], burst]
        prev = a
    out = np.concatenate(parts + [raw[prev:]])
    return out[:max(len(out) - cut, 0)]


def legacy_stream_bytes(fmt: str, n_frames: int = 300, junk_frac: float = 0.3,
                        seed: int = 0) -> np.ndarray:
    """A seeded byte stream of the older wire formats: ``"v1"`` 5-byte
    frames [UE 01][BS 00, or 11 (the sentinel)][RSS x3 10], ``"v2"`` 6-byte
    frames [FLAG 0xCC / 0x33][UE 01][BS 0xFF or 00][RSS x3 10]; after each
    frame, with probability ``junk_frac``, 1-8 bytes of any value."""
    rng = np.random.default_rng(seed)
    n = n_frames
    ue = 0x40 | rng.integers(0, 64, n)
    if fmt == "v1":
        bs = np.where(rng.random(n) < 0.1, 0xC0 | rng.integers(0, 64, n), rng.integers(0, 64, n))
        head = [ue, bs]
    elif fmt == "v2":
        flag = np.where(rng.random(n) < 0.2, 0xCC, 0x33)
        bs = np.where(rng.random(n) < 0.1, 0xFF, rng.integers(0, 64, n))
        head = [flag, ue, bs]
    else:
        raise ValueError(f"unknown legacy format {fmt!r}; use 'v1' or 'v2'")
    frames = np.stack(head + [0x80 | rng.integers(0, 64, n) for _ in range(3)], axis=1)
    junk = np.where(rng.random(n) < junk_frac, rng.integers(1, 9, n), 0)
    parts = []
    for f, j in zip(frames.astype(np.uint8), junk):
        parts += [f, rng.integers(0, 256, j).astype(np.uint8)]
    return np.concatenate(parts)


def to_hex_text(b: np.ndarray, layout: str = "crlf") -> bytes:
    """Serial-log text of the bytes ``b``: upper-case hex pairs behind a
    leading non-token marker ("\u00ab ").

    ``layout="shipped"`` writes one ``"XX "`` stream with no line break,
    the stride-3 layout of the shipped logs (the one the card's tokenizer
    and the native scanner's block path take).  ``layout="crlf"`` (the
    default) adds CRLF after every 16 tokens; every line break breaks the
    stride, so this layout always takes the host tokenizer's scalar path.
    """
    if layout not in ("crlf", "shipped"):
        raise ValueError(f"unknown layout {layout!r}; use 'crlf' or 'shipped'")
    b = np.asarray(b, dtype=np.uint8)
    digits = np.frombuffer(b"0123456789ABCDEF", dtype=np.uint8)
    tok = np.empty((b.size, 3), dtype=np.uint8)
    tok[:, 0] = digits[b >> 4]
    tok[:, 1] = digits[b & 0xF]
    tok[:, 2] = ord(" ")
    if layout == "shipped":
        return "\u00ab ".encode() + tok.tobytes()
    lines = []
    for i in range(0, b.size, 16):
        lines.append(tok[i:i + 16].tobytes() + b"\r\n")
    return "\u00ab ".encode() + b"".join(lines)


def pack_verdict_table(r: np.ndarray, e: np.ndarray, n: np.ndarray, bmax: int) -> np.ndarray:
    """The corrector's residue-form table [G, W] f32 (W = 3 bmax + 1 rounded
    up to 128, the TPU kernel's layout): r as two 8-bit limbs, e, n."""
    g = len(n)
    packed = np.zeros((g, -(-(3 * bmax + 1) // 128) * 128), np.float32)
    packed[:, :bmax] = r >> 8
    packed[:, bmax:2 * bmax] = r & 0xFF
    packed[:, 2 * bmax:3 * bmax] = e
    packed[:, 3 * bmax] = n
    return packed


def verdict_edge_cases(seed: int = 0) -> dict:
    """Inputs of the corrector's per-row verdicts at the edges a windowed
    search over sorted residues can get wrong: {case: (gid [F] i32, clk [F]
    i32, packed [G, W] f32, dict(bmax, cycle, tol))}, all from
    ``default_rng(seed)``.  Rows sit near a baseline of their group (within
    tol + 200 of a whole number of cycles) or anywhere."""
    rng = np.random.default_rng(seed)

    def table(g, bmax, cycle, n_lo=0, n_hi=None):
        n = rng.integers(n_lo, (bmax if n_hi is None else n_hi) + 1, g)
        r = rng.integers(0, cycle, (g, bmax))
        e = rng.integers(0, 64, (g, bmax))
        return r, e, n

    def rows(gid, r, n, cycle, tol, near=0.7):
        """clk near a live baseline of the row's group for a share `near`
        of the rows with a group and a baseline, else uniform."""
        f = len(gid)
        clk = rng.integers(0, 1 << 30, f)
        g_ok = (gid >= 0) & (gid < len(n))
        gg = np.clip(gid, 0, len(n) - 1)
        live = g_ok & (n[gg] > 0) & (rng.random(f) < near)
        col = (rng.random(f) * np.maximum(n[gg], 1)).astype(np.int64)
        k = rng.integers(1, (1 << 30) // cycle - 1, f)
        noise = rng.integers(-tol - 200, tol + 201, f)
        clk = np.where(live, r[gg, col] + k * cycle + noise, clk)
        return clk.astype(np.int32)

    def sorted_gid(f, g, mean_len):
        return np.minimum(np.cumsum(rng.random(f) < 1.0 / mean_len), g - 1).astype(np.int32)

    def case(gid, clk, r, e, n, bmax, cycle, tol):
        return (gid.astype(np.int32), clk.astype(np.int32), pack_verdict_table(r, e, n, bmax),
                dict(bmax=bmax, cycle=cycle, tol=tol))

    out = {}
    cyc, tol = 61_000, 500
    # Blocks of 256 rows over 3-4 groups, and over more groups than a
    # block stages.
    for name, mean_len in (("three_groups_in_a_block", 90), ("many_groups_in_a_block", 25)):
        r, e, n = table(32, 96, cyc, n_lo=40)
        gid = sorted_gid(2048, 32, mean_len)
        out[name] = case(gid, rows(gid, r, n, cyc, tol), r, e, n, 96, cyc, tol)
    # Groups with no baseline, and a negative count.
    r, e, n = table(16, 96, cyc)
    n[[2, 5, 6, 9]] = 0
    n[11] = -3
    gid = sorted_gid(2048, 16, 120)
    out["empty_groups"] = case(gid, rows(gid, r, n, cyc, tol), r, e, n, 96, cyc, tol)
    # gid outside [0, G) (negative, G and past it), unsorted; negative clk.
    r, e, n = table(16, 96, cyc)
    gid = rng.integers(-3, 20, 2048)
    clk = rows(gid, r, n, cyc, tol).astype(np.int64)
    clk[rng.random(2048) < 0.5] -= 1 << 30
    out["gid_out_of_range_negative_clk"] = case(gid, clk, r, e, n, 96, cyc, tol)
    # Residues that straddle 0 / cycle, and rows there: the arc wraps.
    r, e, n = table(8, 96, cyc, n_lo=90)
    r = np.where(rng.random(r.shape) < 0.5, rng.integers(0, 700, r.shape),
                 rng.integers(cyc - 700, cyc, r.shape))
    gid = sorted_gid(2048, 8, 256)
    k = rng.integers(1, 17_000, 2048) * cyc
    clk = k + np.where(rng.random(2048) < 0.5, rng.integers(0, 700, 2048),
                       rng.integers(cyc - 700, cyc, 2048))
    out["arc_wrap"] = case(gid, clk, r, e, n, 96, cyc, tol)
    # Ties at equal resid: duplicated residues, and pairs r_f - d / r_f + d.
    r, e, n = table(8, 96, cyc, n_lo=60)
    r[:, 1::3] = r[:, 0::3][:, :r[:, 1::3].shape[1]]
    gid = sorted_gid(2048, 8, 256)
    clk = rows(gid, r, n, cyc, tol, near=1.0)
    rf = clk.astype(np.int64) % cyc
    for g in range(8):
        first = np.nonzero(gid == g)[0]
        if len(first):
            d = 123 + g
            r[g, 2], r[g, 5] = (rf[first[0]] - d) % cyc, (rf[first[0]] + d) % cyc
    out["ties"] = case(gid, clk, r, e, n, 96, cyc, tol)
    # Baselines at exactly tol and tol + 1 on both sides, also across the
    # wrap (row residues 100 and cycle - 100).
    r, e, n = table(4, 96, cyc, n_lo=96)
    gid = np.repeat(np.arange(4), 64).astype(np.int32)
    rf = np.array([30_000, 100, cyc - 100, 250])
    clk = (rng.integers(1, 17_000, 256) * cyc + rf[gid]).astype(np.int32)
    for g in range(4):
        r[g, 10:14] = (rf[g] + np.array([tol, tol + 1, -tol, -(tol + 1)])) % cyc
    out["resid_eq_tol"] = case(gid, clk, r, e, n, 96, cyc, tol)
    # The same at the edges of 64 equal residue buckets of the circle
    # (width ceil(cycle / 64)): group 0 holds every other edge, group 1 the
    # residue just below each; 2 x 954 apart, so a row sees one at most.
    bw = -(-cyc // 64)
    edges = np.arange(0, 64, 2) * bw
    r = np.stack([edges, (edges - 1) % cyc])
    e, n = rng.integers(0, 64, (2, 32)), np.array([32, 32])
    offs = np.array([tol, -tol, tol + 1, -(tol + 1)])
    rf = (r[:, :, None] + offs).reshape(2, -1) % cyc
    gid = np.repeat(np.arange(2), rf.shape[1])
    clk = rng.integers(1, 17_000, gid.shape) * cyc + rf.reshape(-1)
    out["resid_eq_tol_bucket_edges"] = case(gid, clk, r, e, n, 32, cyc, tol)
    # Another cycle and tolerance, and the table's width at its ends.
    for name, bmax, c, t, g_n, mean_len in (
            ("cycle_60000_tol_300", 96, 60_000, 300, 16, 128),
            ("bmax_4", 4, cyc, tol, 16, 128),
            ("bmax_256", 256, cyc, tol, 8, 256)):
        r, e, n = table(g_n, bmax, c, n_lo=bmax // 2)
        n[0] = bmax
        gid = sorted_gid(2048, g_n, mean_len)
        out[name] = case(gid, rows(gid, r, n, c, t), r, e, n, bmax, c, t)
    # Past the default bounds, as the overflow rerun sizes them: 257
    # groups, 300 baselines (groups of more than 256 live baselines).
    r, e, n = table(257, 300, cyc, n_lo=1, n_hi=40)
    n[rng.choice(257, 12, replace=False)] = 300
    n[0] = 300
    gid = sorted_gid(8192, 257, 32)
    out["groups_257_bmax_300"] = case(gid, rows(gid, r, n, cyc, tol), r, e, n, 300, cyc, tol)
    # Residues at or past cycle (r_hi8 up to 255): the table a windowed
    # search must not trust.
    r, e, n = table(8, 96, cyc, n_lo=60)
    r[::2, ::5] = rng.integers(cyc, 1 << 16, r[::2, ::5].shape)
    gid = sorted_gid(2048, 8, 256)
    clk = rows(gid, r, n, cyc, tol)
    clk[::7] = (rng.integers(1, 16_000, len(clk[::7])) * cyc + rng.integers(
        cyc - 600, cyc, len(clk[::7]))).astype(np.int32)
    out["residues_past_cycle"] = case(gid, clk, r, e, n, 96, cyc, tol)
    # 2 tol + 1 = cycle (every column scanned) and one tick more cycle.
    for name, c in (("tol_half_cycle", 1001), ("tol_just_under_half_cycle", 1002)):
        r, e, n = table(8, 96, c, n_lo=10)
        gid = sorted_gid(2048, 8, 256)
        out[name] = case(gid, rows(gid, r, n, c, tol), r, e, n, 96, c, tol)
    return out


def decode_edge_cases(seed: int = 0) -> dict:
    """Inputs of the frame decode at its edges: {case: (bytes uint8 [N],
    n_valid or None)}, from ``default_rng(seed)``.  Every byte a flag
    (0xCC); frames back to back behind 0-10 junk bytes (a start at every
    offset mod 11); a frame ending exactly at ``n_valid`` and one byte past
    it; session bytes with junk cut to N = 0, 1, 10, 11, 12, 5,119, 5,120,
    5,121, 11 x 256 +- 1 and 11 x 1,024 +- 1 (the edges of blocks of 256
    and 1,024 rows)."""
    rng = np.random.default_rng(seed)
    out = {"all_flags_0xCC": (np.full(4096, 0xCC, np.uint8), None)}
    frames = synthetic_session_bytes(n_groups=1, frames_per_beam=2, baselines_per_group=8,
                                     junk_frac=0.0, seed=seed)[2:]       # back to back
    for off in range(11):
        out[f"back_to_back_offset_{off}"] = (
            np.concatenate([rng.choice(_JUNK, off), frames]).astype(np.uint8), None)
    lead = rng.choice(_JUNK, 3)
    stream = np.concatenate([lead, frames]).astype(np.uint8)
    end = 3 + 11 * 21                                    # frame 20 ends here
    out["frame_ends_at_n_valid"] = (stream, end)
    out["frame_one_byte_past_n_valid"] = (stream, end - 1)
    raw = synthetic_session_bytes(n_groups=3, frames_per_beam=5, baselines_per_group=4,
                                  junk_frac=0.3, seed=seed)
    for n in (0, 1, 10, 11, 12, 5119, 5120, 5121, 11 * 256 - 1, 11 * 256 + 1,
              11 * 1024 - 1, 11 * 1024 + 1):
        out[f"n_{n}"] = (raw[:n].copy(), None)
    return out


def sweep_sums_edge_cases(seed: int = 0) -> dict:
    """Inputs of the per-sweep sums at their edges: {case: (p, bs, val int32
    [F], max_sweeps, n_beams)}, from ``default_rng(seed)``.  One cell fed by
    20,000 rows (many 1,024-row tiles; its sum stays below 2^24); sorted p
    with long runs of -1 inside and a -1 tail (the stream's paths buffer);
    S = 1 with ids out of range; one cell summing to exactly 2^24 - 1; and
    n_beams of 32, 100 and 1,500 (a sweep's UE row wider than 1,024 cells)."""
    rng = np.random.default_rng(seed)

    def case(p, bs, val, s, nb=64):
        return tuple(np.ascontiguousarray(x, dtype=np.int32) for x in (p, bs, val)) + (s, nb)

    out = {}
    f = 20_000
    out["one_cell_20000_rows"] = case(np.full(f, 2 * 64 + 5), np.full(f, 7),
                                      rng.integers(0, 800, f), 4)
    f, s = 24_000, 12
    p = np.sort(rng.integers(0, s * 64, f))
    for lo, hi in ((3_000, 6_500), (11_000, 11_100), (15_000, 17_000)):
        p[lo:hi] = -1
    p[20_000:] = -1
    out["sorted_minus1_runs_and_tail"] = case(p, rng.integers(0, 64, f),
                                              rng.integers(0, 1 << 18, f), s)
    f = 5_000
    out["S1_ids_out_of_range"] = case(rng.integers(-2, 66, f), rng.integers(-1, 65, f),
                                      rng.integers(0, 1 << 18, f), 1)
    out["one_cell_2^24-1"] = case(np.full(255, 3 * 64 + 17), np.full(255, 40),
                                  np.full(255, 65_793), 4)          # 255 x 65,793 = 2^24 - 1
    for nb, s in ((32, 5), (100, 3), (1500, 1)):
        f = 30_000
        out[f"n_beams_{nb}_S{s}"] = case(np.sort(rng.integers(-1, s * nb + 2, f)),
                                         rng.integers(-1, nb + 1, f),
                                         rng.integers(0, 1 << 18, f), s, nb)
    return out


def nnls_edge_cases(k: int, lanes: int = 65, seed: int = 0):
    """Inputs of the batched NNLS at its edges: (G [lanes, k, k] f32, b
    [lanes, k] f32, x0 [lanes, k] f32, P0 [lanes, k] bool), from
    ``default_rng(seed)``.  A quarter of the lanes are cold starts on Gram
    systems A^T A, A^T y with half the planted coefficients negative (atoms
    drop); a quarter are warm-started from the previous step of the OMP
    refit (the last atom's column zero there), solved by the plain version;
    a quarter hold two near-collinear atoms (columns 1e-6 apart); the rest
    are all-zero dead lanes (the stream's empty sweep lanes) but, for k >=
    2, the last: G = I, b = e_1 warm-started from P0 = {0}, x0 = 0, whose
    first step-back ratio is 0/0."""
    import torch

    from slam_process_tpu_torch.ops.nnls import nnls_gram_plain

    rng = np.random.default_rng(seed)
    q, m = lanes // 4, 4 * k + 8
    A = np.abs(rng.normal(size=(lanes, m, k))) + 0.01
    y = (np.einsum("smk,sk->sm", A, rng.normal(size=(lanes, k)))
         + 0.1 * rng.normal(size=(lanes, m)))
    if k >= 2:
        A[2 * q:3 * q, :, 1] = A[2 * q:3 * q, :, 0] * (1 + 1e-6 * rng.normal(size=(q, m)))
    G = np.einsum("smk,sml->skl", A, A).astype(np.float32)
    b = np.einsum("smk,sm->sk", A, y).astype(np.float32)
    x0 = np.zeros((lanes, k), np.float32)
    P0 = np.zeros((lanes, k), bool)
    prev = A[q:2 * q].copy()
    prev[:, :, -1] = 0.0
    xw, pw = nnls_gram_plain(
        torch.from_numpy(np.einsum("smk,sml->skl", prev, prev).astype(np.float32)),
        torch.from_numpy(np.einsum("smk,sm->sk", prev, y[q:2 * q]).astype(np.float32)))
    x0[q:2 * q], P0[q:2 * q] = xw.numpy(), pw.numpy()
    G[3 * q:], b[3 * q:] = 0.0, 0.0
    if k >= 2:
        G[-1], b[-1, 1], P0[-1, 0] = np.eye(k, dtype=np.float32), 1.0, True
    return G, b, x0, P0


def decode_stream_cases(n_streams: int = 19, width: int = 1 << 20, seed: int = 0) -> dict:
    """Inputs of the stream-axis frame decode, {case: (bytes uint8 [S, n],
    limits int64 [S] or None)}, from ``default_rng(seed)``; at the default
    sizes (the 19 streams' 1 MiB round) their grids take more than one
    resident wave of the card.  The S streams are one run of session bytes
    (junk between copies of a short session cut at every offset mod 11)
    cut into rows of n, so each stream starts at its own phase.

    ``ragged_limits``: stream s's limit is, by s mod 6, 0, five bytes into
    a frame (mid-frame), exactly a frame's end, exactly n, past n, or a
    random byte; ``no_limits``; ``width_not_multiple_of_16``: n = width -
    5 (a multiple of neither 11 nor 16, so most streams start unaligned),
    the same kinds of limit; ``one_stream``: the S streams end to end as
    one stream (S = 1), its limit mid-frame."""
    from slam_process_tpu_torch.ops.decode import frame_start_mask

    rng = np.random.default_rng(seed)
    unit = synthetic_session_bytes(n_groups=2, frames_per_beam=3, baselines_per_group=6,
                                   junk_frac=0.3, seed=seed)
    pieces, total = [], 0
    while total < n_streams * width:
        cut = int(rng.integers(0, 11))
        junk = rng.choice(_JUNK, int(rng.integers(0, 24)))
        pieces += [junk, unit[cut:]]
        total += len(junk) + len(unit) - cut
    flat = np.concatenate(pieces).astype(np.uint8)[:n_streams * width]

    def limits(b):
        n = b.shape[1]
        out = []
        for s in range(b.shape[0]):
            starts = np.flatnonzero(frame_start_mask(b[s]))
            p = int(starts[len(starts) // 2]) if len(starts) else 0
            out.append((0, p + 5, p + 11, n, n + 1000, int(rng.integers(0, n + 1)))[s % 6])
        return np.asarray(out, np.int64)

    b = flat.reshape(n_streams, width)
    short = np.ascontiguousarray(b[:, :width - 5])
    one = flat.reshape(1, -1)
    starts = np.flatnonzero(frame_start_mask(one[0]))
    return {"ragged_limits": (b, limits(b)), "no_limits": (b, None),
            "width_not_multiple_of_16": (short, limits(short)),
            "one_stream": (one, np.asarray([int(starts[-len(starts) // 3]) + 5], np.int64))}


def track_stream_cases(seed: int = 0) -> dict:
    """Inputs of the stream-axis tracker block, {case: (aoa, aod, power f32
    [S, s1, K], valid bool [S, s1, K], m_eff int32 [S], pos f32 [S, T, 2],
    created bool [S, T], count int32 [S], gate_deg)}, from
    ``default_rng(seed)``.  Each stream starts from a carry of ``count``
    created tracks at random positions.

    ``long_chains_K3``: 700 lanes of K = 3, T = 8, m_eff 700, 613 and 0
    (chains over several staging tiles of the kernel); ``long_chains_T16_K20``:
    130 lanes of K = 20, T = 16, on an integer grid (exact cost ties
    across the kernel's threads), m_eff 130 and 100; ``T16_K20_m_eff_edges``:
    40 lanes, m_eff 0, s1 - 1, s1 and past s1; ``planted_ties_and_nan``: the
    planted ties at the gate of ``tests/test_torch_tracker.py`` (T = 4, K =
    3, gate 5), and the same lanes with one valid path's AoA NaN in lane 1
    (its costs NaN: no round assigns, the NaN path opens a track, and later
    lanes' costs against that track are NaN)."""
    rng = np.random.default_rng(seed)

    def streams(s1, k_n, t_n, m_eff, counts, gate, grid=False):
        s_n = len(m_eff)
        if grid:
            ang = [rng.integers(-4, 5, (s_n, s1, k_n)).astype(np.float32) for _ in range(2)]
        else:
            ang = [rng.uniform(-45, 45, (s_n, s1, k_n)).astype(np.float32) for _ in range(2)]
        pw = rng.uniform(0, 1, (s_n, s1, k_n)).astype(np.float32)
        counts = np.asarray(counts, np.int32)
        pos = rng.uniform(-45, 45, (s_n, t_n, 2)).astype(np.float32)
        return (*ang, pw, rng.random((s_n, s1, k_n)) < 0.7, np.asarray(m_eff, np.int32), pos,
                np.arange(t_n)[None] < counts[:, None], counts, gate)

    f32 = np.float32
    aoa = np.array([[0, 10, 0], [5, 3, 13], [8, 2, 5], [0, 0, 0]], f32)
    aod = np.array([[0, 0, 0], [0, 4.0001, 4], [4, -4, 5], [0, 0, 0]], f32)
    pw = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [0, 0, 0]], f32)
    val = np.array([[1, 1, 0], [1, 1, 1], [1, 1, 1], [0, 0, 0]], bool)
    aoa_nan = aoa.copy()
    aoa_nan[1, 1] = np.nan
    planted = (np.stack([aoa, aoa_nan]), np.stack([aod, aod]), np.stack([pw, pw]),
               np.stack([val, val]), np.asarray([3, 4], np.int32),
               np.zeros((2, 4, 2), f32), np.zeros((2, 4), bool), np.zeros(2, np.int32), 5.0)
    return {"long_chains_K3": streams(700, 3, 8, [700, 613, 0], [3, 0, 5], 10.0),
            "long_chains_T16_K20": streams(130, 20, 16, [130, 100], [0, 7], 6.0, grid=True),
            "T16_K20_m_eff_edges": streams(40, 20, 16, [0, 39, 40, 57], [5, 0, 16, 2], 15.0),
            "planted_ties_and_nan": planted}
