"""Kernels the card ran in the profiled stretch, a step."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels:
        return None
    return len(t.kernels) / t.units
