"""Modulated Transformation Module (counterpart of moegan_tpu/core/mtm.py).

An optional offset field (3x3 conv in the compute dtype -> LeakyReLU(0.2)
-> 3x3 conv in float32) deforms the features by bilinear grid sampling:
base grid from linspace(-1, 1) in (x, y) order, offsets x0.05, clamped to
[-1, 1]. Then a modulated 3x3 conv and LeakyReLU(0.2). The offset net runs
only at resolutions <= 16 (the generator sets `use_offset`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from moegan_tpu_torch.core import inits
from moegan_tpu_torch.core.modconv import ModulatedConv
from moegan_tpu_torch.ops.grid_sample import bilinear_grid_sample


def _offset_conv(in_ch: int, out_ch: int, gen: torch.Generator) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(inits.hwio_to_oihw(inits.torch_conv_kernel((3, 3, in_ch, out_ch), gen)))
        conv.bias.copy_(inits.torch_linear_bias((out_ch,), gen, in_ch * 9))
    return conv


class ModulatedTransformationModule(nn.Module):
    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        use_offset: bool = False,
        latent_dim: int = 512,
        compute_dtype: torch.dtype = torch.bfloat16,
        gen: torch.Generator | None = None,
    ):
        super().__init__()
        gen = inits.default_generator(gen)
        self.use_offset = use_offset
        self.compute_dtype = compute_dtype
        if use_offset:
            self.offset_conv1 = _offset_conv(in_channels, 32, gen)
            self.offset_conv2 = _offset_conv(32, 2, gen)
        self.modulated_conv = ModulatedConv(
            in_channels, out_channels, kernel_size, latent_dim,
            compute_dtype=compute_dtype, gen=gen,
        )

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, C]; w: [B, latent]."""
        if self.use_offset:
            B, H, W, _ = x.shape
            cd = self.compute_dtype
            c1 = self.offset_conv1
            h = F.conv2d(x.permute(0, 3, 1, 2).to(cd), c1.weight.to(cd), c1.bias.to(cd), padding=1)
            h = F.leaky_relu(h, 0.2)
            offsets = self.offset_conv2(h.float()).permute(0, 2, 3, 1)  # [B, H, W, 2] fp32
            ys = torch.linspace(-1.0, 1.0, H, device=x.device)
            xs = torch.linspace(-1.0, 1.0, W, device=x.device)
            grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
            grid = torch.stack([grid_x, grid_y], dim=-1)[None]  # [1, H, W, 2]
            grid = torch.clamp(grid + offsets * 0.05, -1.0, 1.0)
            x = bilinear_grid_sample(x, grid)
        return F.leaky_relu(self.modulated_conv(x, w), 0.2)
