"""Aurora generator (counterpart of moegan_tpu/models/generator.py).

text_proj MLP (Linear -> LayerNorm(1e-5, fp32) -> LeakyReLU(0.2) -> Linear)
gives the length-1 text sequence; a 4-layer mapping network maps
[z || text] to the style w; truncation moves w toward mapping(zeros) with a
per-sample psi; the learned [1, 4, 4, C4] constant runs through the
generative blocks; RGB taps (1x1 modulated conv, fp32 out) at every
resolution >= rgb_min_resolution. Parameter names follow the flax tree, so
`convert.py` maps one onto the other name for name.

Eval (serving) uses the mean router weights and hard routing, and its KL is
0. Training (`training=True`) samples every router's weights, routes soft,
anneals the router temperature by `annealing_factor`, and returns the sum of
the blocks' router KLs (generator.py:44-152).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from moegan_tpu_torch.config import GeneratorConfig
from moegan_tpu_torch.core import inits
from moegan_tpu_torch.core.blocks import GenerativeBlock
from moegan_tpu_torch.core.modconv import ModulatedConv
from moegan_tpu_torch.ops.layernorm import LayerNorm


class GeneratorOutput(NamedTuple):
    image: torch.Tensor  # [B, R, R, 3] fp32 at max_resolution
    intermediates: dict  # {resolution: [B, r, r, 3]} RGB taps, final included
    kl: torch.Tensor  # sum of the blocks' router KLs (0 at eval)
    routing: tuple  # per-block routing probs [B, T_r, E]


def _linear(in_dim: int, out_dim: int, gen: torch.Generator) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        layer.weight.copy_(inits.torch_linear_kernel((in_dim, out_dim), gen).t())
        layer.bias.copy_(inits.torch_linear_bias((out_dim,), gen, in_dim))
    return layer


class AuroraGenerator(nn.Module):
    def __init__(self, config: GeneratorConfig = GeneratorConfig(),
                 gen: torch.Generator | None = None):
        super().__init__()
        gen = inits.default_generator(gen)
        cfg = self.config = config
        cd = self.compute_dtype = getattr(torch, cfg.compute_dtype)
        td = cfg.text_embedding_dim
        self.text_proj_1 = _linear(td, td, gen)
        self.text_proj_ln = LayerNorm(td)
        self.text_proj_2 = _linear(td, td, gen)
        in_dim = cfg.latent_dim + td
        for i in range(cfg.mapping_layers):
            self.add_module(f"mapping_{i}", _linear(in_dim, cfg.mapping_width, gen))
            in_dim = cfg.mapping_width
        self.constant = nn.Parameter(torch.randn((1, 4, 4, cfg.channels[4]), generator=gen))
        in_ch = cfg.channels[4]
        for r in cfg.resolutions():
            out_ch = cfg.channels[r]
            self.add_module(f"gen_block_{r}", GenerativeBlock(
                in_ch, out_ch, td, cfg.mapping_width, upsample=r > 4,
                use_offset=r <= cfg.offset_max_resolution, heads=cfg.heads_for(out_ch),
                num_experts=cfg.num_experts, router_hidden=cfg.router_hidden,
                compute_dtype=cd, gen=gen,
            ))
            if r >= cfg.rgb_min_resolution:
                self.add_module(f"to_rgb_{r}", ModulatedConv(
                    out_ch, 3, 1, cfg.mapping_width, compute_dtype=cd, gen=gen))
            in_ch = out_ch

    def mapping(self, v: torch.Tensor) -> torch.Tensor:
        n = self.config.mapping_layers
        for i in range(n):
            v = getattr(self, f"mapping_{i}")(v)
            if i < n - 1:
                v = F.leaky_relu(v, 0.2)
        return v

    def forward(self, z: torch.Tensor, text_embeddings: torch.Tensor,
                truncation_psi: float | torch.Tensor = 1.0, training: bool = False,
                annealing_factor: float | torch.Tensor = 1.0,
                router_eps=None) -> GeneratorOutput:
        """z [B, latent]; text_embeddings [B or 1, text_dim]; psi a float or a per-sample [B] tensor.

        In training each block's router noise is `router_eps[resolution]`
        (see `BayesianRouter.sample_weights`; `train.step.draw_noise` draws it).
        """
        cfg = self.config
        if training and router_eps is None:
            raise ValueError("a training forward needs router_eps")
        B = z.shape[0]
        te = text_embeddings.float()
        if te.shape[0] == 1 and B != 1:
            te = te.expand(B, te.shape[-1])
        text_seq = self.text_proj_2(
            F.leaky_relu(self.text_proj_ln(self.text_proj_1(te)), 0.2))[:, None, :]
        w = self.mapping(torch.cat([z.float(), te], dim=-1))
        if torch.is_tensor(truncation_psi) or truncation_psi < 1.0:
            zeros = torch.zeros((1, cfg.latent_dim + cfg.text_embedding_dim), device=w.device)
            mean_latent = self.mapping(zeros).detach()
            psi = torch.as_tensor(truncation_psi, dtype=torch.float32, device=w.device)
            if psi.dim() == 1:
                psi = psi[:, None]
            w = mean_latent + psi * (w - mean_latent)

        x = self.constant.expand(B, 4, 4, cfg.channels[4]).to(self.compute_dtype)
        kls, routings, rgbs = [], [], {}
        for r in cfg.resolutions():
            eps = router_eps[r] if training else None
            x, kl, probs = getattr(self, f"gen_block_{r}")(
                x, w, text_seq, training, annealing_factor, eps)
            kls.append(kl)
            routings.append(probs)
            if r >= cfg.rgb_min_resolution:
                rgbs[r] = getattr(self, f"to_rgb_{r}")(x, w).float()
        return GeneratorOutput(rgbs[cfg.max_resolution], rgbs, torch.stack(kls).sum(),
                               tuple(routings))
