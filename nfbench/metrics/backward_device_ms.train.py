"""Device ms a step of the kernels launched while the program's
`train.backward` span was open on the host: `loss.backward()` (trace:
ranges and kernel records)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.units:
        return None
    seconds = t.seconds_launched_in("train.backward")
    if seconds is None:
        return None
    return 1e3 * seconds / t.units
