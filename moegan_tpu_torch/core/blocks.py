"""Convolution and generative blocks (counterpart of moegan_tpu/core/blocks.py).

ConvolutionBlock = two MTMs plus a skip (1x1 modulated conv when the channel
count changes). GenerativeBlock = optional x2 bilinear upsample ->
ConvolutionBlock -> AttentionBlock; with `use_pallas=False` the upsample is
the plain version, as every other part of the block. A generative block's spans
(`utils.profiling`) are `<span_name>.upsample` and `<span_name>.conv`, then the
attention block's, under the generator's `moegan.g.r{r}`.
"""

from __future__ import annotations

import torch
from torch import nn

from moegan_tpu_torch.core import inits
from moegan_tpu_torch.core.attention import AttentionBlock
from moegan_tpu_torch.core.modconv import ModulatedConv
from moegan_tpu_torch.core.mtm import ModulatedTransformationModule
from moegan_tpu_torch.core.upsample import upsample2x_bilinear
from moegan_tpu_torch.ops.upsample import upsample2x_reference
from moegan_tpu_torch.utils.profiling import span


class ConvolutionBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, use_offset: bool = False,
                 latent_dim: int = 512, compute_dtype=torch.bfloat16,
                 gen: torch.Generator | None = None):
        super().__init__()
        gen = inits.default_generator(gen)
        cd = compute_dtype
        self.mtm1 = ModulatedTransformationModule(
            in_channels, out_channels, 3, use_offset, latent_dim, cd, gen)
        self.mtm2 = ModulatedTransformationModule(
            out_channels, out_channels, 3, use_offset, latent_dim, cd, gen)
        self.skip_proj = (
            ModulatedConv(in_channels, out_channels, 1, latent_dim, compute_dtype=cd, gen=gen)
            if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        out = self.mtm2(self.mtm1(x, w), w)
        identity = self.skip_proj(x, w) if self.skip_proj is not None else x
        return out + identity


class GenerativeBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, text_dim: int = 512,
                 latent_dim: int = 512, upsample: bool = False, use_offset: bool = False,
                 heads: int = 8, num_experts: int = 4, router_hidden: int = 128,
                 compute_dtype=torch.bfloat16, gen: torch.Generator | None = None,
                 use_pallas: bool = True, span_name: str = "moegan.g.block"):
        super().__init__()
        gen = inits.default_generator(gen)
        self.upsample = upsample
        self.use_pallas = use_pallas
        self._span = {"upsample": f"{span_name}.upsample", "conv": f"{span_name}.conv"}
        self.conv_block = ConvolutionBlock(
            in_channels, out_channels, use_offset, latent_dim, compute_dtype, gen)
        self.attn_block = AttentionBlock(
            out_channels, text_dim, latent_dim, heads, num_experts, router_hidden,
            compute_dtype, gen, use_pallas, span_name=span_name)

    def forward(self, x: torch.Tensor, w: torch.Tensor, text_seq: torch.Tensor,
                training: bool = False, annealing_factor: float | torch.Tensor = 1.0,
                eps=None):
        """Returns (x [B, H, W, C], router KL, routing probs [B, T, E])."""
        if self.upsample:
            with span(self._span["upsample"]):
                x = upsample2x_bilinear(x) if self.use_pallas else upsample2x_reference(x)
        with span(self._span["conv"]):
            x = self.conv_block(x, w)
        return self.attn_block(x, w, text_seq, training, annealing_factor, eps)
