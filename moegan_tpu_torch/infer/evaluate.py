"""FID and CLIPScore of a generator over a dataset (counterpart of
moegan_tpu/infer/evaluate.py).

N samples conditioned on the dataset's text embeddings, in batches on the
card (the generator's eval forward: mean router weights, hard routing);
FID of their features against the real images' (InceptionV3 pool-2048 by
default, or CLIP), and CLIPScore of the CLIP image features against the
conditioning text. z for batch i comes from `batch_noise`, a CPU
`torch.Generator`, not `jax.random`: the same seed gives other samples
than the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from moegan_tpu_torch.config import GeneratorConfig
from moegan_tpu_torch.infer.fid import (
    clip_feature_extractor,
    frechet_distance,
    gaussian_stats,
    inception_feature_extractor,
)
from moegan_tpu_torch.infer.sample import Sampler


def batch_noise(seed: int, index: int, batch_size: int, latent_dim: int) -> torch.Tensor:
    """z [batch_size, latent_dim] of the batch that starts at sample `index`."""
    gen = torch.Generator().manual_seed((seed << 32) | index)
    return torch.randn((batch_size, latent_dim), generator=gen)


def evaluate_fid_clipscore(g_params, dataset, clip_params, *,
                           cfg: GeneratorConfig = GeneratorConfig(),
                           num_samples: int = 10_000, batch_size: int = 64,
                           truncation_psi: float = 1.0, seed: int = 0,
                           feature_source: str = "inception", inception_params=None,
                           device="cuda") -> dict:
    """{'fid', 'fid_feature_source', 'clip_score', 'num_samples',
    'expert_utilization'} of the generator with state dict `g_params`.

    `clip_params` is the CLIP towers (`models/clip.py::load_clip_params`);
    CLIPScore (100 x the mean clipped cosine of image and text features) is
    computed when their image features have the text embeddings' width.
    `expert_utilization` is the last block's mean routing probability.
    """
    n = min(num_samples, len(dataset))
    n = (n // batch_size) * batch_size
    if n == 0:
        raise ValueError(f"dataset ({len(dataset)}) smaller than batch {batch_size}")
    sampler = Sampler(cfg, g_params, device=device)

    clip_extract = clip_feature_extractor(clip_params, batch_size=min(batch_size, 32))
    if feature_source == "inception":
        fid_extract = inception_feature_extractor(
            inception_params, batch_size=min(batch_size, 32), device=sampler.device)
    elif feature_source == "clip":
        fid_extract = clip_extract
    else:
        raise ValueError(f"unknown feature_source {feature_source!r}")

    fake_feats, real_feats, sims, utils_ = [], [], [], []
    for i in range(0, n, batch_size):
        text = np.asarray(dataset.text_embeddings[i:i + batch_size], np.float32)
        z = batch_noise(seed, i, batch_size, cfg.latent_dim)
        with torch.inference_mode():
            out = sampler.gen(z.to(sampler.device), torch.from_numpy(text).to(sampler.device),
                              truncation_psi=truncation_psi)
        fake = out.image.clamp(-1.0, 1.0)
        utils_.append(out.routing[-1].reshape(-1, cfg.num_experts).float().mean(0).cpu().numpy())

        real = np.asarray(dataset.images[i:i + batch_size], np.float32)
        fake_feats.append(fid_extract(fake))
        real_feats.append(fid_extract(real))

        cf = clip_extract(fake) if fid_extract is not clip_extract else fake_feats[-1]
        if cf.shape[-1] == text.shape[-1]:  # CLIP embedding space only
            fn = cf / (np.linalg.norm(cf, axis=-1, keepdims=True) + 1e-8)
            tn = text / (np.linalg.norm(text, axis=-1, keepdims=True) + 1e-8)
            sims.append(np.clip((fn * tn).sum(-1), 0, None))

    mu_f, sig_f = gaussian_stats(np.concatenate(fake_feats))
    mu_r, sig_r = gaussian_stats(np.concatenate(real_feats))
    return {
        "fid": frechet_distance(mu_f, sig_f, mu_r, sig_r),
        "fid_feature_source": feature_source,
        "clip_score": float(100.0 * np.concatenate(sims).mean()) if sims else None,
        "num_samples": n,
        "expert_utilization": np.mean(utils_, axis=0).tolist(),
    }
