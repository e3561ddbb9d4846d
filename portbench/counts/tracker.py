"""K6, the tracker's association (``track_block_kernel``): per closed
sweep (a live lane) its K paths read (13 bytes each) and its T track
columns written (13 bytes each), the tracker's carry both ways; 6 float32
operations per (track, path) pair and assignment round (``k6_bytes`` of
``chip_smoke.py``, a frozen copy, with the closed sweeps as both the live
lanes and the lanes written)."""


def k6_bytes(live: int, s1: int, k_n: int, t_n: int) -> int:
    """Inputs of the live lanes only, every output column, the carry both
    ways and m_eff."""
    return live * k_n * 13 + s1 * t_n * 13 + 2 * (t_n * 9 + 4) + 4


def work(s: dict):
    n = s.get("sweeps")
    if not n:
        return None
    k, t = s["max_paths"], s["max_tracks"]
    return k6_bytes(n, n, k, t), {"f32": 6 * n * k * k * t}
