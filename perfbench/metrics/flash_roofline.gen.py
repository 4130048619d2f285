"""Flash attention's share of its roofline in the eval forward, %: the least
time for a call's forwards at the flash path's resolutions (`counts.
kernels`) over the device time of the kernels named below, a call."""

from perfbench.counts import kernels, model

PATTERN = r"\bflash_fwd_kernel\b"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    busy = t.kernel_seconds(PATTERN)
    if busy <= 0.0:
        return None
    g = ctx.config["train_config"]["generator"]
    need = sum(kernels.bound_s(*kernels.flash_fwd(B, H, T, D))
               for _, B, H, T, D in model.flash_shapes(g, ctx.host["batch"]))
    return 100.0 * need * t.units / busy
