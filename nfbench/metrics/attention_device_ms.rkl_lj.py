"""Device ms a step of the kernels launched while the program's
`tcl.attention` span was open on the host: each coupling block's QKV
projection, attention, output projection and residual, in the forward pass
(trace: ranges and kernel records)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.units:
        return None
    seconds = t.seconds_launched_in("tcl.attention")
    if seconds is None:
        return None
    return 1e3 * seconds / t.units
