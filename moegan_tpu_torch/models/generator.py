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

`config.use_pallas` goes to every block (False: no kernel anywhere). With
`config.remat_blocks`, a training forward with grad enabled runs each
generative block under `torch.utils.checkpoint` (JAX `nn.remat`,
generator.py:122-124): the backward runs the block's forward again, with
the same router noise, which is an argument; nothing in a block draws
random numbers.

Spans (`utils.profiling`): `moegan.g` around a forward, `moegan.g.mapping`
(text projection, mapping, truncation), then `moegan.g.r{r}` a block with
its RGB tap (`.to_rgb`); the block's own spans are in `core/blocks.py` and
`core/attention.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from moegan_tpu_torch.config import GeneratorConfig
from moegan_tpu_torch.core import inits
from moegan_tpu_torch.core.blocks import GenerativeBlock
from moegan_tpu_torch.core.modconv import ModulatedConv
from moegan_tpu_torch.ops.layernorm import LayerNorm
from moegan_tpu_torch.utils.profiling import span


class GeneratorOutput(NamedTuple):
    image: torch.Tensor  # [B, R, R, 3] fp32 at max_resolution
    intermediates: dict  # {resolution: [B, r, r, 3]} RGB taps, final included
    kl: torch.Tensor  # sum of the blocks' router KLs (0 at eval)
    routing: tuple  # per-block routing probs [B, T_r, E]


class AuroraGenerator(nn.Module):
    def __init__(self, config: GeneratorConfig = GeneratorConfig(),
                 gen: torch.Generator | None = None):
        super().__init__()
        gen = inits.default_generator(gen)
        cfg = self.config = config
        cd = self.compute_dtype = getattr(torch, cfg.compute_dtype)
        td = cfg.text_embedding_dim
        self.text_proj_1 = inits.torch_linear(td, td, gen)
        self.text_proj_ln = LayerNorm(td)
        self.text_proj_2 = inits.torch_linear(td, td, gen)
        in_dim = cfg.latent_dim + td
        for i in range(cfg.mapping_layers):
            self.add_module(f"mapping_{i}", inits.torch_linear(in_dim, cfg.mapping_width, gen))
            in_dim = cfg.mapping_width
        self.constant = nn.Parameter(torch.randn((1, 4, 4, cfg.channels[4]), generator=gen))
        in_ch = cfg.channels[4]
        self._span = {"g": "moegan.g", "mapping": "moegan.g.mapping"}
        for r in cfg.resolutions():
            out_ch = cfg.channels[r]
            self._span[r] = f"moegan.g.r{r}"
            self._span["to_rgb", r] = f"moegan.g.r{r}.to_rgb"
            self.add_module(f"gen_block_{r}", GenerativeBlock(
                in_ch, out_ch, td, cfg.mapping_width, upsample=r > 4,
                use_offset=r <= cfg.offset_max_resolution, heads=cfg.heads_for(out_ch),
                num_experts=cfg.num_experts, router_hidden=cfg.router_hidden,
                compute_dtype=cd, gen=gen, use_pallas=cfg.use_pallas, span_name=self._span[r],
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
        if training and router_eps is None:
            raise ValueError("a training forward needs router_eps")
        with span(self._span["g"]):
            return self._forward(z, text_embeddings, truncation_psi, training, annealing_factor,
                                 router_eps)

    def _forward(self, z, text_embeddings, truncation_psi, training, annealing_factor,
                 router_eps) -> GeneratorOutput:
        cfg = self.config
        B = z.shape[0]
        with span(self._span["mapping"]):
            te = text_embeddings.float()
            if te.shape[0] == 1 and B != 1:
                te = te.expand(B, te.shape[-1])
            text_seq = self.text_proj_2(
                F.leaky_relu(self.text_proj_ln(self.text_proj_1(te)), 0.2))[:, None, :]
            w = self.mapping(torch.cat([z.float(), te], dim=-1))
            if torch.is_tensor(truncation_psi) or truncation_psi < 1.0:
                zeros = torch.zeros((1, cfg.latent_dim + cfg.text_embedding_dim),
                                    device=w.device)
                mean_latent = self.mapping(zeros).detach()
                psi = torch.as_tensor(truncation_psi, dtype=torch.float32, device=w.device)
                if psi.dim() == 1:
                    psi = psi[:, None]
                w = mean_latent + psi * (w - mean_latent)

        x = self.constant.expand(B, 4, 4, cfg.channels[4]).to(self.compute_dtype)
        remat = cfg.remat_blocks and training and torch.is_grad_enabled()
        kls, routings, rgbs = [], [], {}
        for r in cfg.resolutions():
            eps = router_eps[r] if training else None
            block = getattr(self, f"gen_block_{r}")
            with span(self._span[r]):
                if remat:
                    x, kl, probs = checkpoint(block, x, w, text_seq, training, annealing_factor,
                                              eps, use_reentrant=False)
                else:
                    x, kl, probs = block(x, w, text_seq, training, annealing_factor, eps)
                kls.append(kl)
                routings.append(probs)
                if r >= cfg.rgb_min_resolution:
                    with span(self._span["to_rgb", r]):
                        rgbs[r] = getattr(self, f"to_rgb_{r}")(x, w).float()
        return GeneratorOutput(rgbs[cfg.max_resolution], rgbs, torch.stack(kls).sum(),
                               tuple(routings))
