"""Share of the profiled stretch in which no device operation ran, %."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
