"""The RQS VJP kernel's share of its roofline, in %: chip_smoke.py's frozen
VJP byte count (yardstick.rqs_bytes_ops) of a step's calls, on the
reference's inputs for one window batch, at 3.35 TB/s, over the device
time of the kernels named by PATTERN (trace)."""

from nfbench.readers import rqs_roofline_pct

PATTERN = "rqs_vjp"


def read(ctx):
    return rqs_roofline_pct(ctx, "rqs_vjp_calls", PATTERN, vjp=True)
