"""The fused MoE's share of its roofline in the training step, %.

Numerator: the least time for the work a step's shapes need (`counts.
kernels`), per block: two soft forwards (router and every expert on every
token) and one backward with the forward's routing given. Denominator:
device time of the kernels named below in the profiled stretch, a step.
"""

from perfbench.counts import kernels, model

PATTERN = r"\bmoe_(fwd|split_sum|bwd_token|wgrad|wgrad_gemm|sum)_kernel\b"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    busy = t.kernel_seconds(PATTERN)
    if busy <= 0.0:
        return None
    g = ctx.config["train_config"]["generator"]
    need = sum(2 * kernels.bound_s(*kernels.moe_fwd(T, C, F, E, h))
               + kernels.bound_s(*kernels.moe_bwd(T, C, F, E))
               for _, T, C, F, E, h in model.moe_shapes(g, ctx.host["batch"]))
    return 100.0 * need * t.units / busy
