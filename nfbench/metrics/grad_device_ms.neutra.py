"""Device ms a transition of the kernels launched while the program's
`hmc.grad` span was open on the host: its L gradient evaluations of the
pullback, the flow's pass, the funnel and autograd's backward (trace:
ranges and kernel records)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.units:
        return None
    seconds = t.seconds_launched_in("hmc.grad")
    if seconds is None:
        return None
    return 1e3 * seconds / t.units
