"""The table of peaks of one NVIDIA H100 SXM (80 GB HBM3, 700 W) and the
least time of a piece of work.

Published (NVIDIA's data sheet, dense, no sparsity): HBM3 at 3.35 TB/s,
67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside the tensor cores.
Integer work has no published peak: ``int32`` is the repository's own
figure, 128 integer instructions per SM per clock (four schedulers, one
32-lane warp instruction each) x 132 SMs x 1.98 GHz = 33.45 T op/s, which
its ``tools/int32_rate.py`` measured as not exceeded on the card (101 add
/ xor and 63.6 IMAD instructions per SM per clock, NVIDIA H100 80GB HBM3
at 700 W).  A share of it is a share of a measured rate, not of a
published peak.
"""

BYTES_PER_S = 3.35e12
PEAKS = {
    "f32": 67e12,
    "f64": 34e12,
    "int32": 132 * 128 * 1.98e9,   # measured by the repository, not published
}


def least_seconds(n_bytes: float, ops: dict) -> float:
    """The larger of the bytes at the memory rate and each kind of
    operation at its peak."""
    t = n_bytes / BYTES_PER_S
    for kind, n in ops.items():
        t = max(t, n / PEAKS[kind])
    return t
