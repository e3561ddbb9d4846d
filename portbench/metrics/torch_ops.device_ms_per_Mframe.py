"""torch_ops.device_ms_per_Mframe: device milliseconds of every activity
that is neither a hand-written kernel nor a copy or set (the PyTorch
operations between the kernels), per million frames the window fed."""

from portbench.metrics._kernels import COPIES, HAND_KERNELS


def read(ctx):
    frames = ctx.stats.get("frames")
    if not frames:
        return None
    pats = tuple(p for v in HAND_KERNELS.values() for p in v) + COPIES
    t = sum(a.end - a.start for a in ctx.trace.activities
            if not any(p in a.name for p in pats))
    return 1e3 * t / (frames / 1e6)
