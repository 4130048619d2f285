"""Flash attention's share of its roofline in the training step, %.

Numerator: the least time for the work a step's shapes need (`counts.
kernels`), per resolution the flash path takes: two forwards (the D
phase's fake, the G phase's) and one backward. Denominator: device time of
the kernels named below in the profiled stretch, a step. A renamed kernel
leaves the metric unread.
"""

from perfbench.counts import kernels, model

PATTERN = r"\bflash_(fwd|bwd_prep|bwd_dkdv|bwd_dq)_kernel\b"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    busy = t.kernel_seconds(PATTERN)
    if busy <= 0.0:
        return None
    g = ctx.config["train_config"]["generator"]
    need = sum(2 * kernels.bound_s(*kernels.flash_fwd(B, H, T, D))
               + kernels.bound_s(*kernels.flash_bwd(B, H, T, D))
               for _, B, H, T, D in model.flash_shapes(g, ctx.host["batch"]))
    return 100.0 * need * t.units / busy
