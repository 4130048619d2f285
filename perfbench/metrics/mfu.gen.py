"""Model FLOPs of the generator calls completed in the untraced part of the
window, a second, as a share of the card's dense bf16 peak, %
(`counts.model.generate_call`: one hard-routed eval forward)."""

from perfbench.counts import kernels, model


def read(ctx):
    h = ctx.host
    flops = model.generate_call(ctx.config, h["batch"]) * h["units"]
    return 100.0 * flops / h["seconds"] / kernels.PEAK_BF16_FLOPS
