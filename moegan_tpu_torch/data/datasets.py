"""In-memory datasets (the port's copy of part of moegan_tpu/data/datasets.py).

`ImageTextDataset` holds what the training loop reads of the JAX package's
`ProcessedMSCOCODataset`: images NHWC float32 in [-1, 1] and text
embeddings [N, 512] in host memory (captions wait for the CLIP slice). `synthetic_dataset` is the JAX package's
tiny fixture (datasets.py:240-260), the same numbers from the same seed.
The COCO loaders (the reference's npy artifacts) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ImageTextDataset:
    images: np.ndarray  # [N, H, W, 3] float32 in [-1, 1] (NHWC)
    text_embeddings: np.ndarray  # [N, 512] float32

    def __len__(self) -> int:
        return len(self.images)


def synthetic_dataset(n: int = 64, resolution: int = 16, seed: int = 0,
                      text_dim: int = 512) -> ImageTextDataset:
    """Smooth colour fields weakly tied to their text embeddings, so that a few
    training steps have signal."""
    rng = np.random.default_rng(seed)
    embeds = rng.normal(size=(n, text_dim)).astype(np.float32)
    ys, xs = np.mgrid[0:resolution, 0:resolution] / resolution
    images = np.zeros((n, resolution, resolution, 3), np.float32)
    for i in range(n):
        phase = embeds[i, :3]
        images[i, ..., 0] = np.sin(2 * np.pi * (xs + phase[0]))
        images[i, ..., 1] = np.sin(2 * np.pi * (ys + phase[1]))
        images[i, ..., 2] = np.sin(2 * np.pi * (xs * ys + phase[2]))
    images += 0.05 * rng.normal(size=images.shape).astype(np.float32)
    return ImageTextDataset(np.clip(images, -1, 1).astype(np.float32), embeds)
