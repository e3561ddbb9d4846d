"""device.idle_pct: the share of the traced window in which no kernel,
copy or set ran on the card."""


def read(ctx):
    w = ctx.trace.window_s
    if w <= 0:
        return None
    return 100.0 * (w - ctx.trace.busy_s) / w
