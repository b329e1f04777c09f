"""Attention's share of the card's fp32 peak (66.9 TFLOP/s, 700 W), in %:
the Q K^T and P V FLOPs of a step's forward pass, counted from the
configuration's shapes, of the traced steps, over the device time of the
kernels launched while the program's `tcl.sdpa` span (its call of
scaled_dot_product_attention) was open on the host (trace: ranges and
kernel records)."""


def read(ctx):
    t = ctx.trace
    flops = ctx.layer.get("attention_flops_per_unit")
    if t is None or not t.units or not flops or ctx.peak_fp32 is None:
        return None
    seconds = t.seconds_launched_in("tcl.sdpa")
    if not seconds:
        return None
    return 100.0 * flops * t.units / seconds / ctx.peak_fp32
