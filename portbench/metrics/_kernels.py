"""The program's hand-written CUDA kernels by the names the profiler
gives their launches (``slam_process_tpu_torch/csrc/*.cu``), and the share
of a kernel's least time (``portbench/counts``) in its device time."""

HAND_KERNELS = {
    "decode": ("decode_rows_kernel",),
    "correct": ("correct_verdicts_kernel",),
    "raster": ("raster_kernel",),
    "sweep_sums": ("sweep_sums_kernel",),
    "compact": ("compact_kernel", "compact_chunks_kernel"),
    "tracker": ("track_block_kernel",),
    "nnls": ("nnls_kernel", "nnls_wide_kernel"),
}
COPIES = ("Memcpy", "Memset", "memcpy", "memset")


def roofline_pct(ctx, kernel: str):
    """100 x the kernel's least time for the traced window's traffic over
    its device time there; None where the window ran none of it or fed it
    nothing."""
    seconds, _ = ctx.trace.seconds_of(HAND_KERNELS[kernel])
    bound = ctx.bound_s.get(kernel)
    if not seconds or bound is None:
        return None
    return 100.0 * bound / seconds
