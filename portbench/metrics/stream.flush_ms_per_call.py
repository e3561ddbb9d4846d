"""stream.flush_ms_per_call: host milliseconds of the end-of-log step
(``finalize_streams``, the reads, ``reset_streams``: the benchmark's
``pb.flush`` span), per call, in the traced run's untraced window (the
profiler's cost per operation is not in it)."""


def read(ctx):
    s = ctx.host_spans.seconds.get("pb.flush", [])
    return 1e3 * sum(s) / len(s) if s else None
