"""The x2 bilinear upsample's share of its roofline in the eval forward, %.

Numerator: the least time for the work of every `moegan.g.r{r}.upsample`
span the program recorded in the traced stretches (`harness.spans`): per
span, its bf16 input [batch, r/2, r/2, channels[r/2]] read once and its bf16
output written once, 10 bytes x batch x (r/2)^2 x channels[r/2], over the
HBM bandwidth; each occurrence counts its own work (one a block a call).
Denominator: those spans' device time. The bound treats the upsampled
tensor as materialised in bf16: a change that fuses the upsample into its
consumer moves the span so that it covers the fused op.
"""

from perfbench.harness import spans


def read(ctx):
    return spans.upsample_roofline(spans.recorded(), ctx.config["train_config"]["generator"],
                                   ctx.host["batch"])
