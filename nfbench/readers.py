"""Arithmetic shared by the per-layer metrics' readers (nfbench/metrics/):
each reader is `read(ctx) -> value or None`, ctx a run.Context; None where
the traced window holds nothing to read."""

from __future__ import annotations

from nfbench import yardstick


def per_unit_launches(ctx):
    t = ctx.trace
    if t is None or not t.units:
        return None
    return t.launches / t.units


def idle_pct(ctx):
    t = ctx.trace
    if t is None:
        return None
    return 100.0 * yardstick.idle_share(t.busy_s, t.window_s)


def mfu_pct(ctx):
    """The whole step's share of the card's fp32 peak: the configuration's
    shape-counted FLOPs of the traced units over the traced window."""
    t = ctx.trace
    if t is None or not t.units or ctx.peak_fp32 is None:
        return None
    flops = ctx.layer["flops_per_unit"] * t.units
    return 100.0 * flops / t.window_s / ctx.peak_fp32


def rqs_roofline_pct(ctx, calls_key, pattern, vjp, scale=1.0):
    """A RQS kernel's share of its roofline: the frozen byte count of one
    unit's calls (`ctx.layer[calls_key]`, each scaled by `scale`), times
    the kernels the trace holds over the calls a unit makes, over their
    device time."""
    t, calls = ctx.trace, ctx.layer.get(calls_key)
    if t is None or not calls or ctx.hbm is None:
        return None
    seconds, count = t.kernel_seconds(pattern)
    if not count:
        return None
    bound = 0.0
    for x, w, h, inverse, bounds in calls:
        fwd, back = yardstick.rqs_bytes_ops(x, w, h, inverse, bounds)
        nbytes, ops = back if vjp else fwd
        bound += yardstick.bound_ms(nbytes * scale, ops * scale, ctx.hbm)
    bound *= count / len(calls)
    return 100.0 * bound / 1e3 / seconds
