"""Text-conditional discriminator with weight-normalised convolutions
(counterpart of moegan_tpu/models/discriminator.py).

Stride-2 4x4 convolutions down to 4x4 (`DiscriminatorConfig.channel_plan`),
each followed by LeakyReLU(0.2); a weight-normalised text projection
(fp32) + LeakyReLU tiled over the final h x h map and concatenated; an h x h
output convolution to one logit per image. NHWC at the interface.

Weight normalisation is written out as the JAX package writes it,
w = g / sqrt(sum v^2 + 1e-12) * v per output unit, with g initialised to
||v|| (no eps). `torch.nn.utils.weight_norm` has no eps, so it is not used.
Parameter names follow the flax tree: conv_{i}, text_projection and
output_conv, each with v, g and b; conv kernels v are OIHW here and HWIO
there (`convert.py` permutes them). A forward is the span `moegan.d`
(`utils.profiling`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from moegan_tpu_torch.config import DiscriminatorConfig
from moegan_tpu_torch.core import inits
from moegan_tpu_torch.utils.profiling import span

SPAN = "moegan.d"


class WNConv(nn.Module):
    """Conv2d under weight normalisation; the convolution runs in `compute_dtype`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, compute_dtype: torch.dtype = torch.bfloat16,
                 gen: torch.Generator | None = None):
        super().__init__()
        gen = inits.default_generator(gen)
        k = kernel_size
        self.stride, self.padding, self.compute_dtype = stride, padding, compute_dtype
        v = inits.hwio_to_oihw(inits.torch_conv_kernel((k, k, in_channels, out_channels), gen))
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(torch.sqrt(torch.sum(v.square(), dim=(1, 2, 3))))
        self.b = nn.Parameter(inits.torch_linear_bias((out_channels,), gen, k * k * in_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, Cin] -> [B, H', W', Cout] in the compute dtype."""
        cd = self.compute_dtype
        norm = torch.sqrt(torch.sum(self.v.square(), dim=(1, 2, 3), keepdim=True) + 1e-12)
        w = (self.g[:, None, None, None] / norm) * self.v
        out = F.conv2d(x.to(cd).permute(0, 3, 1, 2), w.to(cd), stride=self.stride,
                       padding=self.padding).permute(0, 2, 3, 1)
        return out + self.b.to(out.dtype)


class WNDense(nn.Module):
    """Linear under weight normalisation; v is [in, out], used as x @ w."""

    def __init__(self, in_features: int, out_features: int, gen: torch.Generator | None = None):
        super().__init__()
        gen = inits.default_generator(gen)
        v = inits.torch_linear_kernel((in_features, out_features), gen)
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(torch.sqrt(torch.sum(v.square(), dim=0)))
        self.b = nn.Parameter(inits.torch_linear_bias((out_features,), gen, in_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(self.v.square(), dim=0, keepdim=True) + 1e-12)
        return x @ ((self.g[None, :] / norm) * self.v) + self.b


class AuroraDiscriminator(nn.Module):
    def __init__(self, config: DiscriminatorConfig = DiscriminatorConfig(),
                 gen: torch.Generator | None = None):
        super().__init__()
        gen = inits.default_generator(gen)
        cfg = self.config = config
        cd = self.compute_dtype = getattr(torch, cfg.compute_dtype)
        plan = cfg.channel_plan()
        in_ch = 3
        for i, ch in enumerate(plan):
            self.add_module(f"conv_{i}", WNConv(in_ch, ch, 4, 2, 1, cd, gen))
            in_ch = ch
        self.text_projection = WNDense(cfg.text_embedding_dim, cfg.text_features, gen)
        self.final_size = cfg.max_resolution >> len(plan)
        self.output_conv = WNConv(in_ch + cfg.text_features, 1, self.final_size, 1, 0, cd, gen)

    def forward(self, img: torch.Tensor, text_embedding: torch.Tensor) -> torch.Tensor:
        """img [B, R, R, 3] in [-1, 1]; text [B, text_dim] -> logits [B] (fp32)."""
        with span(SPAN):
            return self._forward(img, text_embedding)

    def _forward(self, img: torch.Tensor, text_embedding: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = img.to(self.compute_dtype)
        for i in range(len(cfg.channel_plan())):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), 0.2)
        tfeat = F.leaky_relu(self.text_projection(text_embedding.float()), 0.2).to(x.dtype)
        B, h = x.shape[0], x.shape[1]
        tmap = tfeat[:, None, None, :].expand(B, h, h, cfg.text_features)
        out = self.output_conv(torch.cat([x, tmap], dim=-1))
        return out.reshape(img.shape[0]).float()
