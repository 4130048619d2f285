"""The multi-level CLIP loss and CLIPScore (counterpart of moegan_tpu/losses/clip_loss.py).

Each RGB tap is clamped to [-1, 1], resized to the tower's input (224 for
CLIP), encoded, and scored as 1 - the mean cosine similarity against the
text embeddings. All taps go through ONE batched tower pass: they are
concatenated along the batch. With `stop_gradient` (the default, as the
reference computes its image features under no_grad) the features are
computed under `torch.no_grad()` and the loss moves no weight; without it
the tower runs under `torch.utils.checkpoint`, recomputed in the backward
instead of storing twelve layers of activations, as `jax.checkpoint` does.

A tower pack is a `models.clip.CLIP` or {"toy": `models.toy_clip.ToyCLIP`}.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from moegan_tpu_torch.models.clip import preprocess_for_clip


def _towers(clip_params):
    """(preprocess, image features of preprocessed input) of a tower pack."""
    if isinstance(clip_params, dict) and "toy" in clip_params:
        toy = clip_params["toy"]
        return toy.preprocess, toy.image_features_preprocessed
    return preprocess_for_clip, clip_params.image_features_preprocessed


def _cosine(feats: torch.Tensor, text_embeddings: torch.Tensor) -> torch.Tensor:
    feats = feats.float()
    feats = feats / (feats.norm(dim=-1, keepdim=True) + 1e-8)
    text = text_embeddings.float()
    text = text / (text.norm(dim=-1, keepdim=True) + 1e-8)
    return (feats * text).sum(dim=-1)


def _cosine_loss(feats: torch.Tensor, text_embeddings: torch.Tensor) -> torch.Tensor:
    return 1.0 - torch.nan_to_num(_cosine(feats, text_embeddings)).mean()


def clip_loss(clip_params, images_m11: torch.Tensor, text_embeddings: torch.Tensor, *,
              stop_gradient: bool = True) -> torch.Tensor:
    """1 - mean cosine similarity between the image features and the text embeddings."""
    pre, features = _towers(clip_params)
    with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_gradient):
        feats = features(pre(images_m11))
    return _cosine_loss(feats, text_embeddings)


def multi_level_clip_loss(clip_params, images_by_res: dict, text_embeddings: torch.Tensor, *,
                          stop_gradient: bool = True) -> dict:
    """{resolution: scalar loss} of every tap in `images_by_res`, from one tower pass."""
    resolutions = sorted(images_by_res)
    if not resolutions:
        return {}
    pre, features = _towers(clip_params)
    if stop_gradient:
        with torch.no_grad():
            feats = features(torch.cat([pre(images_by_res[r]) for r in resolutions]))
    else:
        x = torch.cat([pre(images_by_res[r]) for r in resolutions])
        feats = torch.utils.checkpoint.checkpoint(features, x, use_reentrant=False)
    B = text_embeddings.shape[0]
    return {r: _cosine_loss(feats[i * B:(i + 1) * B], text_embeddings)
            for i, r in enumerate(resolutions)}


@torch.no_grad()
def clip_score(clip_params, images_m11: torch.Tensor, text_embeddings: torch.Tensor):
    """CLIPScore = 100 * mean(max(0, cosine similarity))."""
    pre, features = _towers(clip_params)
    return 100.0 * _cosine(features(pre(images_m11)), text_embeddings).clamp_min(0.0).mean()
