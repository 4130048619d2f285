"""CLIP ViT-B/32, image and text towers (counterpart of moegan_tpu/models/clip_jax.py).

- `CLIPImageTower`: [B, 224, 224, 3] CLIP-normalised images (NHWC) -> [B, 512]:
  a 32x32 stride-32 patch convolution without bias, the class token,
  positional embeddings, 12 pre-LN residual blocks of width 768 with 12
  heads, LayerNorm of the class token, projection to 512.
- `CLIPTextTower`: token ids [B, 77] -> [B, 512]: token and positional
  embeddings, 12 causal blocks of width 512 with 8 heads, the final
  LayerNorm, the features at the EOS token (the largest id), projection.
- `CLIP` holds both (`image`, `text`); `load_clip_params` reads a user's
  converted `.npz` (`CLIP_WEIGHTS_PATH`, the JAX layout that
  scripts/convert_clip.py writes) or draws a random init from a
  `torch.Generator` seeded with `seed`. The random init has the JAX
  package's distributions, not its numbers.
- `tokenize`: CLIP's BPE (`models/bpe.py`) when a merges file is on disk,
  else the JAX package's byte-level fallback into the same id space
  (BOS 49406, bytes as 256 + b, EOS 49407). The `transformers` route of the
  JAX tokenizer is not ported.

Numerics, as the JAX towers compute them: the residual stream, the
LayerNorms (eps 1e-5), the softmax and the final projections are float32;
every dense layer's input is rounded to `compute_dtype`. The JAX dense
layers then multiply in float32 (flax promotes the bf16 input against the
float32 kernel); with compute_dtype bfloat16 the port multiplies in bf16
with float32 accumulation, its output rounded to bf16, as the tensor cores
do it. The image tower adds the class and positional embeddings in
compute_dtype, the text tower in float32. The attention is
`F.scaled_dot_product_attention` (causal in the text tower; the JAX mask
is -1e9, whose probabilities are exactly 0 in float32 as well). With
compute_dtype float32 the towers agree with the JAX package's to float32
rounding; with bfloat16 to a cosine of 0.999 (tests/test_torch_clip.py).
These are plain PyTorch: the JAX towers reach no Pallas kernel.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

IMAGE_RESOLUTION = 224
PATCH_SIZE = 32
VISION_WIDTH = 768
VISION_LAYERS = 12
VISION_HEADS = 12
EMBED_DIM = 512
TEXT_WIDTH = 512
TEXT_LAYERS = 12
TEXT_HEADS = 8
CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
LN_EPS = 1e-5
CLIP_WEIGHTS_ENV = "CLIP_WEIGHTS_PATH"

# CLIP's preprocessing constants (OpenAI).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _dtype(d) -> torch.dtype:
    return getattr(torch, d) if isinstance(d, str) else d


def _dense(layer: nn.Linear, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """The layer on x rounded to cd, in cd (float32 accumulation)."""
    return F.linear(x.to(cd), layer.weight.to(cd), layer.bias.to(cd))


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, LN_EPS)


class ResidualAttentionBlock(nn.Module):
    """x + attn(ln_1(x)), then + mlp_proj(QuickGELU(mlp_fc(ln_2(x)))); x float32."""

    def __init__(self, width: int, heads: int, causal: bool = False,
                 compute_dtype="bfloat16"):
        super().__init__()
        self.width, self.heads, self.causal = width, heads, causal
        self.compute_dtype = _dtype(compute_dtype)
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.qkv = nn.Linear(width, 3 * width)
        self.out = nn.Linear(width, width)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        B, T, W = x.shape
        H = self.heads
        qkv = _dense(self.qkv, _layer_norm(self.ln_1, x), cd)
        q, k, v = (t.reshape(B, T, H, W // H).transpose(1, 2) for t in qkv.split(W, dim=-1))
        o = F.scaled_dot_product_attention(q, k, v, is_causal=self.causal)
        x = x + _dense(self.out, o.transpose(1, 2).reshape(B, T, W), cd).float()
        h = _dense(self.mlp_fc, _layer_norm(self.ln_2, x), cd).float()
        h = h * torch.sigmoid(1.702 * h)  # QuickGELU
        return x + _dense(self.mlp_proj, h, cd).float()


class CLIPImageTower(nn.Module):
    """ViT-B/32 visual encoder: [B, 224, 224, 3] (CLIP-normalised, NHWC) -> [B, 512]."""

    def __init__(self, compute_dtype="bfloat16"):
        super().__init__()
        self.compute_dtype = _dtype(compute_dtype)
        grid = IMAGE_RESOLUTION // PATCH_SIZE
        self.patch_embed = nn.Conv2d(3, VISION_WIDTH, PATCH_SIZE, stride=PATCH_SIZE, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(VISION_WIDTH))
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, VISION_WIDTH))
        self.ln_pre = nn.LayerNorm(VISION_WIDTH, eps=LN_EPS)
        for i in range(VISION_LAYERS):
            self.add_module(f"block_{i}", ResidualAttentionBlock(
                VISION_WIDTH, VISION_HEADS, compute_dtype=self.compute_dtype))
        self.ln_post = nn.LayerNorm(VISION_WIDTH, eps=LN_EPS)
        self.proj = nn.Parameter(torch.zeros(VISION_WIDTH, EMBED_DIM))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = F.conv2d(x.permute(0, 3, 1, 2).to(cd), self.patch_embed.weight.to(cd),
                     stride=PATCH_SIZE)
        x = x.flatten(2).transpose(1, 2)  # [B, grid*grid, W], row-major over the grid
        cls = self.class_embedding.to(cd).expand(x.shape[0], 1, VISION_WIDTH)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(cd)
        x = _layer_norm(self.ln_pre, x)
        for i in range(VISION_LAYERS):
            x = getattr(self, f"block_{i}")(x)
        return _layer_norm(self.ln_post, x[:, 0]) @ self.proj


class CLIPTextTower(nn.Module):
    """CLIP text encoder: token ids [B, 77] -> [B, 512]."""

    def __init__(self, compute_dtype="bfloat16"):
        super().__init__()
        self.compute_dtype = _dtype(compute_dtype)
        self.token_embedding = nn.Parameter(torch.zeros(VOCAB_SIZE, TEXT_WIDTH))
        self.positional_embedding = nn.Parameter(torch.zeros(CONTEXT_LENGTH, TEXT_WIDTH))
        for i in range(TEXT_LAYERS):
            self.add_module(f"block_{i}", ResidualAttentionBlock(
                TEXT_WIDTH, TEXT_HEADS, causal=True, compute_dtype=self.compute_dtype))
        self.ln_final = nn.LayerNorm(TEXT_WIDTH, eps=LN_EPS)
        self.text_projection = nn.Parameter(torch.zeros(TEXT_WIDTH, EMBED_DIM))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long()
        x = self.token_embedding[tokens] + self.positional_embedding
        for i in range(TEXT_LAYERS):
            x = getattr(self, f"block_{i}")(x)
        x = _layer_norm(self.ln_final, x)
        eos = tokens.argmax(dim=-1)  # the EOS token has the largest id
        return x[torch.arange(x.shape[0], device=x.device), eos] @ self.text_projection


def preprocess_for_clip(images_m11: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images [B, H, W, 3] -> CLIP-normalised [B, 224, 224, 3] (bilinear,
    half-pixel centres, as `jax.image.resize`)."""
    x = resize_nhwc(images_m11.float().clamp(-1.0, 1.0), IMAGE_RESOLUTION)
    mean = x.new_tensor(CLIP_MEAN)
    std = x.new_tensor(CLIP_STD)
    return ((x + 1.0) * 0.5 - mean) / std


def resize_nhwc(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of square NHWC images to size x size: `jax.image.resize`
    (half-pixel centres, edge weights renormalised, antialiased when shrinking)."""
    if x.shape[1] == size:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=size < x.shape[1])
    return y.permute(0, 2, 3, 1)


def tokenize(texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """Prompt(s) -> [N, 77] int32 CLIP token ids: the BPE when a merges file with
    CLIP's full vocab is on disk (`models/bpe.py::default_tokenizer`), else the
    byte-level fallback (BOS, 256 + each UTF-8 byte, EOS, zero padding)."""
    from moegan_tpu_torch.models.bpe import default_tokenizer

    if isinstance(texts, str):
        texts = [texts]
    bpe = default_tokenizer()
    if bpe is not None and bpe.vocab_size == VOCAB_SIZE:
        return bpe.tokenize(list(texts), context_length)
    out = np.zeros((len(texts), context_length), np.int32)
    for i, t in enumerate(texts):
        ids = [49406] + [b + 256 for b in t.encode("utf-8")][: context_length - 2] + [49407]
        out[i, : len(ids)] = ids
    return out


class CLIP(nn.Module):
    """The two towers; parameters named as the JAX tree {"image": ..., "text": ...}."""

    def __init__(self, compute_dtype="bfloat16"):
        super().__init__()
        self.image = CLIPImageTower(compute_dtype)
        self.text = CLIPTextTower(compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.text.token_embedding.device

    def image_features_preprocessed(self, x: torch.Tensor) -> torch.Tensor:
        return self.image(x)

    def image_features(self, images_m11: torch.Tensor) -> torch.Tensor:
        return self.image(preprocess_for_clip(images_m11))

    def text_features(self, tokens) -> torch.Tensor:
        return self.text(torch.as_tensor(tokens, device=self.device))

    def encode_text(self, texts) -> torch.Tensor:
        """Prompt(s) -> [N, 512] float32 embeddings (not normalised)."""
        return self.text_features(tokenize(texts))


def _init_(module: CLIP, gen: torch.Generator) -> None:
    """The JAX init's distributions: dense and conv kernels N(0, 1/fan_in),
    zero biases, unit LayerNorms; class 0.02, positional 0.01, token 0.02;
    projections N(0, 1/width)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias":
                p.zero_()
            elif leaf == "weight" and p.dim() == 1:
                p.fill_(1.0)
            elif leaf == "weight":
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p[0].numel()))
            else:
                std = {"class_embedding": 0.02, "token_embedding": 0.02,
                       "positional_embedding": 0.01}.get(leaf, p.shape[0] ** -0.5)
                p.copy_(torch.randn(p.shape, generator=gen) * std)


def init_clip_params(seed: int = 0, compute_dtype="bfloat16") -> CLIP:
    """Random-weight towers on the CPU. Each tower draws from its own generator,
    seeded from `seed`, so either tower's weights do not depend on the other."""
    model = CLIP(compute_dtype)
    for i, tower in enumerate((model.image, model.text)):
        _init_(tower, torch.Generator().manual_seed(2 * seed + i))
    return model


def load_clip_params(path: Optional[str] = None, seed: int = 0, device="cuda",
                     compute_dtype="bfloat16") -> CLIP:
    """The towers from `path` or CLIP_WEIGHTS_PATH (an `.npz` of "/"-joined JAX
    names, scripts/convert_clip.py's output) when it exists, else the random
    init; in eval mode, frozen, on `device` (raises without a card unless
    device="cpu")."""
    from moegan_tpu_torch import resolve_device
    from moegan_tpu_torch.convert import jax_to_torch

    dev = resolve_device(device)
    path = path or os.environ.get(CLIP_WEIGHTS_ENV)
    if path and os.path.exists(path):
        model = CLIP(compute_dtype)
        with np.load(path) as data:
            model.load_state_dict(jax_to_torch({k: data[k] for k in data.files}))
    else:
        model = init_clip_params(seed, compute_dtype)
    return model.requires_grad_(False).eval().to(dev)
