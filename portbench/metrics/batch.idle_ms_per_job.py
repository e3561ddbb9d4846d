"""batch.idle_ms_per_job: card idle milliseconds inside the benchmark's
``pb.job`` spans (one ``run_dataset`` call each), per job."""


def read(ctx):
    idle, n = ctx.trace.span_idle("pb.job")
    return 1e3 * idle / n if n else None
