"""The fused MoE's share of its roofline in the eval forward, %.

Numerator: the least time for the profiled calls' own routing (`counts.
kernels.moe_fwd` under hard routing): each token's selected experts (a
token tied between experts counts each), the router, and the weights of
the experts some token used. Denominator: device time of the kernels named
below in the profiled stretch.
"""

from perfbench.counts import kernels, model

PATTERN = r"\bmoe_(fwd|split_sum)_kernel\b"


def read(ctx):
    t = ctx.trace
    sel = ctx.extra.get("selections")
    if t is None or not sel:
        return None
    busy = t.kernel_seconds(PATTERN)
    if busy <= 0.0:
        return None
    g = ctx.config["train_config"]["generator"]
    shapes = model.moe_shapes(g, ctx.host["batch"])
    need = sum(kernels.bound_s(*kernels.moe_fwd(T, C, F, E, h, selections=s, used=u))
               for call in sel for (_, T, C, F, E, h), (s, u) in zip(shapes, call))
    return 100.0 * need / busy
