"""Host ms a step spends in next() on the port's prefetching iterator
(`BatchLoader` + `prefetch_to_device`), over the untraced part of the window."""


def read(ctx):
    h = ctx.host
    return sum(h["loader_wait_s"]) / h["units"] * 1e3
