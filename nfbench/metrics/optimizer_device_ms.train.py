"""Device ms a step of the kernels launched while torch.optim's
`Optimizer.step#...` range was open on the host: Adam's share of a step
(trace: ranges and kernel records)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.units:
        return None
    seconds = t.seconds_launched_in("Optimizer.step#")
    if not seconds:
        return None
    return 1e3 * seconds / t.units
