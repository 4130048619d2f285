"""Modulated convolution (counterpart of moegan_tpu/core/modconv.py:102-186).

Input/output scaling form, as in the JAX package:

    style  = w @ mod_kernel + mod_bias             (no +1, reference parity)
    demod  = rsqrt(sum_{hw,i} W^2 * style_i^2 + 1e-8)
    out    = conv(x * style, W) * demod

The convolution runs in the compute dtype. NHWC at the public interface;
the weight is OIHW (the converter permutes the JAX HWIO kernel). The
off-by-default `MOEGAN_S2D_CONV` and `MOEGAN_1X1_MATMUL` paths are not
ported, nor the `upsample` option, which no caller in the generator sets.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from moegan_tpu_torch.core import inits


class ModulatedConv(nn.Module):
    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        latent_dim: int = 512,
        demodulate: bool = True,
        compute_dtype: torch.dtype = torch.bfloat16,
        gen: torch.Generator | None = None,
    ):
        super().__init__()
        gen = inits.default_generator(gen)
        k = kernel_size
        self.kernel_size = k
        self.demodulate = demodulate
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(
            inits.hwio_to_oihw(inits.kaiming_normal_leaky((k, k, in_channels, out_channels), gen))
        )
        self.mod_kernel = nn.Parameter(inits.normal((latent_dim, in_channels), gen, 0.02))
        self.mod_bias = nn.Parameter(torch.zeros(in_channels))

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, Cin]; w: [B, latent] -> [B, H, W, Cout] in the compute dtype."""
        cd = self.compute_dtype
        style = w.float() @ self.mod_kernel + self.mod_bias  # [B, Cin]
        xs = x.to(cd) * style[:, None, None, :].to(cd)
        out = F.conv2d(
            xs.permute(0, 3, 1, 2), self.weight.to(cd), padding=self.kernel_size // 2
        ).permute(0, 2, 3, 1)
        if self.demodulate:
            w2 = self.weight.square().sum(dim=(2, 3))  # [Cout, Cin]
            demod = torch.rsqrt(style.square() @ w2.t() + 1e-8)  # [B, Cout]
            out = out * demod[:, None, None, :].to(out.dtype)
        return out.to(cd)
