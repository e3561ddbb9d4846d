"""stream.idle_ms_per_round: card idle milliseconds inside the benchmark's
``pb.feed`` spans (one window round each), per round."""


def read(ctx):
    idle, n = ctx.trace.span_idle("pb.feed")
    return 1e3 * idle / n if n else None
