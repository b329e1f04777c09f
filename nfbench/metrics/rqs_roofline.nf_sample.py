"""The RQS kernel's share of its roofline while sampling, in %:
chip_smoke.py's frozen forward byte count (yardstick.rqs_bytes_ops) of one
batch's calls, counted on the reference's inputs for its first rows and
scaled to the batch, at 3.35 TB/s, over the device time of the kernels
named by PATTERN (trace)."""

from nfbench.readers import rqs_roofline_pct

PATTERN = "rqs_fwd"


def read(ctx):
    calls = ctx.layer.get("rqs_calls")
    if not calls:
        return None
    scale = ctx.layer["rows_per_unit"] / calls[0][0].shape[0]
    return rqs_roofline_pct(ctx, "rqs_calls", PATTERN, vjp=False,
                            scale=scale)
