"""Datasets (the port's copy of part of moegan_tpu/data/datasets.py), numpy only.

`ImageTextDataset` holds what the training loop reads: images NHWC float32
in [-1, 1] and text embeddings [N, 512] in host memory.
`ProcessedMSCOCODataset` adds the captions and reads and writes the
reference pipeline's npy artifacts (`mscoco_{split}[_augmented]_images.npy`
CHW, `_text_embeddings.npy`, `_captions.npy`), as the JAX package's
(:22-110). `synthetic_dataset` is the JAX package's tiny fixture
(datasets.py:240-260), the same numbers from the same seed. The
augmentation, the processing pipeline and `process_data` are not ported yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class ImageTextDataset:
    images: np.ndarray  # [N, H, W, 3] float32 in [-1, 1] (NHWC)
    text_embeddings: np.ndarray  # [N, 512] float32

    def __len__(self) -> int:
        return len(self.images)


def _prefix(split: str, augmented: bool) -> str:
    return f"mscoco_{split}_augmented" if augmented else f"mscoco_{split}"


@dataclass
class ProcessedMSCOCODataset(ImageTextDataset):
    """The reference's processed COCO split (npy artifacts), with its captions."""

    captions: Optional[np.ndarray] = None

    @classmethod
    def load(cls, data_dir: str, split: str = "train", *, augmented: bool = False,
             use_percentage: float = 1.0,
             return_captions: bool = False) -> "ProcessedMSCOCODataset":
        """Load `mscoco_{split}_*.npy` (or the `_augmented_` variants): the images
        memory-mapped, the first `use_percentage` of the split copied out as
        float32 NHWC. Captions (an object array, unpickled) only when asked."""
        prefix = os.path.join(data_dir, _prefix(split, augmented))
        images = np.load(f"{prefix}_images.npy", mmap_mode="r")
        embeds = np.load(f"{prefix}_text_embeddings.npy")
        captions = None
        if return_captions and os.path.exists(f"{prefix}_captions.npy"):
            captions = np.load(f"{prefix}_captions.npy", allow_pickle=True)
        n = len(images)
        if use_percentage < 1.0:
            n = max(1, int(n * use_percentage))
        images = np.asarray(images[:n], np.float32)
        embeds = np.asarray(embeds[:n], np.float32)
        if captions is not None:
            captions = captions[:n]
        if images.ndim == 4 and images.shape[1] == 3 and images.shape[-1] != 3:
            images = np.transpose(images, (0, 2, 3, 1))  # the reference stores CHW
        return cls(np.ascontiguousarray(images), embeds, captions)

    def __getitem__(self, idx):
        if self.captions is not None:
            return self.images[idx], self.text_embeddings[idx], self.captions[idx]
        return self.images[idx], self.text_embeddings[idx]

    def save(self, data_dir: str, split: str = "train", *, augmented: bool = False) -> None:
        """Write the split as the reference's artifacts (images CHW float32)."""
        os.makedirs(data_dir, exist_ok=True)
        prefix = os.path.join(data_dir, _prefix(split, augmented))
        np.save(f"{prefix}_images.npy", np.transpose(self.images, (0, 3, 1, 2)).astype(np.float32))
        np.save(f"{prefix}_text_embeddings.npy", self.text_embeddings.astype(np.float32))
        if self.captions is not None:
            np.save(f"{prefix}_captions.npy", np.asarray(self.captions, object))


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
