"""Host ms a call that `sample_raw` costs the host itself, from its start until
it returns its device tensors: its wall time less the time its CUDA calls
spent waiting for the card, over the traced run's CUDA-API stretch
(`harness.trace.host_cost`)."""


def read(ctx):
    c = ctx.extra.get("host_cost")
    if c is None:
        return None
    return c["own_s"] / c["units"] * 1e3
