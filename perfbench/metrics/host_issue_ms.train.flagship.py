"""Host ms a step that the training step's call costs the host itself: its
wall time less the time its CUDA calls spent waiting for the card (a full
launch queue, a synchronisation), over the traced run's CUDA-API stretch
(`harness.trace.host_cost`). A full queue cannot inflate it, so it reads the
host's work whichever side paces the loop."""


def read(ctx):
    c = ctx.extra.get("host_cost")
    if c is None:
        return None
    return c["own_s"] / c["units"] * 1e3
