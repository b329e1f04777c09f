"""Device ms a batch of the kernels launched while the program's
`spline_ar.restack` span was open on the host: the SplineAR inverse's
re-stacking of the decoded columns at each dim step (trace: ranges and
kernel records)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.units:
        return None
    seconds = t.seconds_launched_in("spline_ar.restack")
    if seconds is None:
        return None
    return 1e3 * seconds / t.units
