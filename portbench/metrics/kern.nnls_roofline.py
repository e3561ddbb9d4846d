"""kern.nnls_roofline: the nnls kernel's share of its roofline in the traced
window (``_kernels.roofline_pct``)."""

from portbench.metrics._kernels import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "nnls")
