"""Model FLOPs of the training steps completed in the untraced part of the
window, a second, as a share of the card's dense bf16 peak, %
(`counts.model.train_step`: 4 soft generator forwards and 14 discriminator
forwards a step, no recomputation)."""

from perfbench.counts import kernels, model


def read(ctx):
    h = ctx.host
    flops = model.train_step(ctx.config, h["batch"]) * h["units"]
    return 100.0 * flops / h["seconds"] / kernels.PEAK_BF16_FLOPS
