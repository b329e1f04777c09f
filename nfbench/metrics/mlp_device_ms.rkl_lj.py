"""Device ms a step of the kernels launched while the program's `tcl.mlp` span
was open on the host: each coupling layer's wrap and Fourier embedding, its
blocks' MLPs and residuals and its output projection, in the forward pass
(trace: ranges and kernel records)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.units:
        return None
    seconds = t.seconds_launched_in("tcl.mlp")
    if seconds is None:
        return None
    return 1e3 * seconds / t.units
