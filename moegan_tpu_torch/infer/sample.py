"""Sampling (counterpart of moegan_tpu/infer/sample.py).

`Sampler` wraps a generator for eval: mean router weights, hard routing,
truncation, images clipped to [-1, 1]. z for a seed comes from a CPU
`torch.Generator`, so it differs from `jax.random`'s z for the same seed; a
caller that needs the JAX package's images passes z to `sample_raw`.
String prompts are encoded by the tower pack's text tower (`encode_text`):
the CLIP towers of `models.clip.load_clip_params` unless another pack (a
toy pack) is given. `sample_aurora_gan` is the functional form over a
generator file's flat parameters.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from moegan_tpu_torch import resolve_device
from moegan_tpu_torch.config import GeneratorConfig
from moegan_tpu_torch.models.generator import AuroraGenerator


def is_string_prompt(prompt) -> bool:
    return isinstance(prompt, str) or (
        isinstance(prompt, (list, tuple)) and len(prompt) > 0 and isinstance(prompt[0], str)
    )


class Sampler:
    """Eval-mode sampling around a generator's weights, on one device."""

    def __init__(self, cfg: GeneratorConfig, state_dict, device="cuda", clip_params=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.gen = AuroraGenerator(cfg).eval()
        self.gen.load_state_dict(state_dict)
        self.gen.to(self.device)
        self.clip_params = clip_params

    @torch.inference_mode()
    def encode_text(self, prompt) -> torch.Tensor:
        """Prompt(s) -> [N, 512] float32 text embeddings on the sampler's device
        (the CLIP towers are loaded at the first call when none were given)."""
        if self.clip_params is None:
            from moegan_tpu_torch.models.clip import load_clip_params

            self.clip_params = load_clip_params(device=self.device)
        towers = self.clip_params
        if isinstance(towers, dict) and "toy" in towers:
            towers = towers["toy"]
        return towers.encode_text(prompt).float()

    @torch.inference_mode()
    def sample_raw(self, z, text_emb, psi):
        """One dispatch over a pre-assembled batch: z [N, latent], text_emb [N, emb],
        psi [N] -> (images [N, R, R, 3] in [-1, 1], routing tuple of [N, T_r, E])."""
        dev = self.device
        z = torch.as_tensor(np.asarray(z, np.float32)).to(dev)
        text_emb = torch.as_tensor(np.asarray(text_emb, np.float32)).to(dev)
        psi = torch.as_tensor(np.asarray(psi, np.float32)).to(dev)
        out = self.gen(z, text_emb, truncation_psi=psi)
        return out.image.clamp(-1.0, 1.0), out.routing

    @torch.inference_mode()
    def __call__(self, prompt, num_samples: int = 1, truncation_psi: float = 0.7,
                 seed: int = 0, return_stats: bool = False):
        if is_string_prompt(prompt):
            text_emb = self.encode_text(prompt)
        else:
            text_emb = torch.as_tensor(np.asarray(prompt, np.float32)).to(self.device)
            if text_emb.dim() == 1:
                text_emb = text_emb[None]
        if text_emb.shape[0] == 1 and num_samples > 1:
            text_emb = text_emb.expand(num_samples, text_emb.shape[-1])
        z = torch.randn((num_samples, self.cfg.latent_dim),
                        generator=torch.Generator().manual_seed(seed)).to(self.device)
        out = self.gen(z, text_emb, truncation_psi=truncation_psi)
        images = out.image.clamp(-1.0, 1.0)
        if not return_stats:
            return images
        return images, expert_utilization_stats(out.routing)


def expert_utilization_stats(routing) -> dict:
    """Per-block mean routing probability and top-1 expert fractions."""
    out = {}
    for i, probs in enumerate(routing):
        p = np.asarray(torch.as_tensor(probs).float().cpu()).reshape(-1, probs.shape[-1])
        counts = np.bincount(p.argmax(-1), minlength=p.shape[-1])
        out[f"block_{i}"] = {
            "mean_prob": p.mean(0).tolist(),
            "top1_fraction": (counts / len(p)).tolist(),
        }
    return out


def sample_aurora_gan(generator_params, text_prompt, num_samples: int = 1,
                      truncation_psi: float = 0.7, *, cfg: Optional[GeneratorConfig] = None,
                      clip_params=None, seed: int = 0, device="cuda") -> torch.Tensor:
    """Functional mirror of the JAX package's `sample_aurora_gan`: images
    [N, R, R, 3] in [-1, 1] on `device`. `generator_params` is the flat JAX
    layout that `utils.checkpoint.load_generator_params` returns; with
    cfg=None the architecture is recovered from its shapes."""
    from moegan_tpu_torch.convert import jax_to_torch
    from moegan_tpu_torch.utils.checkpoint import infer_generator_config

    if cfg is None:
        cfg = infer_generator_config(generator_params)
    sampler = Sampler(cfg, jax_to_torch(generator_params), device=device, clip_params=clip_params)
    return sampler(text_prompt, num_samples, truncation_psi, seed)
