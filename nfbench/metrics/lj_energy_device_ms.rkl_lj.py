"""Device ms a step of the kernels launched while the program's `lj.energy`
span was open on the host: the LJ energy of the step's samples, its forward
(trace: ranges and kernel records)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.units:
        return None
    seconds = t.seconds_launched_in("lj.energy")
    if seconds is None:
        return None
    return 1e3 * seconds / t.units
