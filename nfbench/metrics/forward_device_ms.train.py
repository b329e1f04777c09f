"""Device ms a step of the kernels launched while the program's
`train.loss` span was open on the host: the loss's forward pass (trace:
ranges and kernel records)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.units:
        return None
    seconds = t.seconds_launched_in("train.loss")
    if seconds is None:
        return None
    return 1e3 * seconds / t.units
