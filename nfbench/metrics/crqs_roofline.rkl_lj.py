"""The circular RQS forward kernel's share of its roofline while training,
in %: the frozen byte count (nfbench/crqs_yardstick.py) of one step's
calls, counted on the reference's spline inputs for a few of the step's
draws and scaled to the batch, at 3.35 TB/s, over the device time of the
kernels named by PATTERN (trace)."""

from nfbench.crqs_yardstick import crqs_roofline_pct

PATTERN = "rqs_circular_fwd"


def read(ctx):
    return crqs_roofline_pct(ctx, PATTERN, vjp=False)
