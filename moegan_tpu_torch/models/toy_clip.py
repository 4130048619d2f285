"""The small from-scratch text/image embedding pair (counterpart of
moegan_tpu/models/toy_clip.py): a stand-in for CLIP with 512-dim embeddings.

`ToyCLIP` holds the two towers and the logit scale, float32 throughout:

- image: three 3x3 stride-2 convolutions (32/64/128 channels, SAME padding
  as flax pads it, tanh-approximated GELU), flatten in NHWC order, Dense(256),
  GELU, Dense(512);
- text: a word embedding over a fixed template vocabulary, mean-pooled over
  the non-pad tokens, Dense(256), GELU, Dense(512).

A tower pack of the form {"toy": ToyCLIP} is recognised by
`losses/clip_loss.py` and the `Sampler` in place of the CLIP towers
(`as_tower_pack`). `train_toy_clip` and `retrieval_accuracy` are not ported
yet: they need the shapes dataset.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from moegan_tpu_torch.models.clip import resize_nhwc

EMBED_DIM = 512
MAX_WORDS = 12

# Every word the shapes captions can emit, plus <pad>=0 and <unk>=1.
_WORDS = (
    "a", "the", "one", "on", "in", "dark", "background", "picture",
    "red", "green", "blue", "yellow", "magenta", "cyan", "orange", "white",
    "circle", "square", "triangle", "cross",
)
VOCAB = {w: i + 2 for i, w in enumerate(_WORDS)}
VOCAB_SIZE = len(VOCAB) + 2


def tokenize(texts, max_words: int = MAX_WORDS) -> np.ndarray:
    """Captions -> [N, max_words] int32 ids (0 = pad, 1 = unk)."""
    if isinstance(texts, str):
        texts = [texts]
    out = np.zeros((len(texts), max_words), np.int32)
    for i, t in enumerate(texts):
        words = str(t).lower().replace(".", " ").replace(",", " ").split()
        for j, w in enumerate(words[:max_words]):
            out[i, j] = VOCAB.get(w, 1)
    return out


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Pad NCHW x as flax's padding="SAME" does for kernel k, stride s (more after)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ToyImageTower(nn.Module):
    """[-1, 1] NHWC images at the native resolution -> [B, 512]."""

    def __init__(self, resolution: int = 16):
        super().__init__()
        cin = 3
        for i, ch in enumerate((32, 64, 128)):
            self.add_module(f"conv_{i}", nn.Conv2d(cin, ch, 3, stride=2))
            cin = ch
        self.fc = nn.Linear(128 * math.ceil(resolution / 8) ** 2, 256)
        self.head = nn.Linear(256, EMBED_DIM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)
        for i in range(3):
            x = _gelu(getattr(self, f"conv_{i}")(_same_pad(x, 3, 2)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.head(_gelu(self.fc(x)))


class ToyTextTower(nn.Module):
    """Token ids [B, T] -> [B, 512] (mean-pooled bag of words + MLP)."""

    def __init__(self):
        super().__init__()
        self.token_embedding = nn.Parameter(torch.zeros(VOCAB_SIZE, 64))
        self.fc = nn.Linear(64, 256)
        self.head = nn.Linear(256, EMBED_DIM)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long()
        mask = (tokens > 0).float()[..., None]
        x = (self.token_embedding[tokens] * mask).sum(1) / mask.sum(1).clamp_min(1.0)
        return self.head(_gelu(self.fc(x)))


class ToyCLIP(nn.Module):
    """The toy towers and CLIP's learnable logit scale."""

    def __init__(self, resolution: int = 16):
        super().__init__()
        self.image = ToyImageTower(resolution)
        self.text = ToyTextTower()
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    @property
    def native_resolution(self) -> int:
        """The image tower's training resolution, from its fc width 128 * (R/8)^2."""
        return int(8 * round(math.sqrt(self.image.fc.in_features / 128.0)))

    def preprocess(self, images_m11: torch.Tensor) -> torch.Tensor:
        """[-1, 1] images -> the tower's native resolution (bilinear, as
        `jax.image.resize`)."""
        return resize_nhwc(images_m11.float().clamp(-1.0, 1.0), self.native_resolution)

    def image_features_preprocessed(self, x: torch.Tensor) -> torch.Tensor:
        return self.image(x)

    def image_features(self, images_m11: torch.Tensor) -> torch.Tensor:
        return self.image(self.preprocess(images_m11))

    def text_features(self, tokens) -> torch.Tensor:
        return self.text(torch.as_tensor(tokens, device=self.device))

    def encode_text(self, texts) -> torch.Tensor:
        """Prompt(s) -> [N, 512] L2-normalised embeddings."""
        feats = self.text_features(tokenize(texts))
        return feats / (feats.norm(dim=-1, keepdim=True) + 1e-8)


def init_toy_params(resolution: int = 16, seed: int = 0) -> ToyCLIP:
    """Random toy towers (flax's initialisers' distributions: N(0, 1/fan_in)
    kernels, zero biases, N(0, 0.02) word embeddings; CLIP's logit scale)."""
    gen = torch.Generator().manual_seed(seed)
    model = ToyCLIP(resolution)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p[0].numel()))
            elif name.endswith("token_embedding"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model


def as_tower_pack(toy: ToyCLIP) -> dict:
    """The structural-dispatch form the CLIP loss and the Sampler recognise."""
    return {"toy": toy}


def save_toy_params(path: str, toy: ToyCLIP) -> None:
    """An `.npz` of "/"-joined JAX names, as the JAX package's save_toy_params writes."""
    from moegan_tpu_torch.convert import torch_to_jax

    np.savez(path, **torch_to_jax(toy.state_dict()))


def load_toy_params(path: str) -> ToyCLIP:
    from moegan_tpu_torch.convert import jax_to_torch

    with np.load(path) as data:
        sd = jax_to_torch({k: data[k] for k in data.files})
    in_feat = sd["image.fc.weight"].shape[1]
    model = ToyCLIP(int(8 * round(math.sqrt(in_feat / 128.0))))
    model.load_state_dict(sd)
    return model
