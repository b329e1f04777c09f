"""The HMC accept kernel's share of its roofline, in %: chip_smoke.py's
frozen byte count (yardstick.fused_bound_bytes_ops) on each traced
transition's accepted chains at 3.35 TB/s, over the device time of the
kernels named by PATTERN (trace)."""

from nfbench import yardstick

PATTERN = "hmc_accept_kernel"


def read(ctx):
    t = ctx.trace
    accepted = ctx.layer.get("accepted")
    if t is None or not accepted or ctx.hbm is None:
        return None
    seconds, count = t.kernel_seconds(PATTERN)
    if count != len(accepted):
        return None
    n, d = ctx.layer["chains"], ctx.layer["dim"]
    bound = sum(yardstick.bound_ms(*yardstick.fused_bound_bytes_ops(n, d, a),
                                   ctx.hbm) for a in accepted)
    return 100.0 * bound / 1e3 / seconds
