"""Datasets (the port's copy of part of moegan_tpu/data/datasets.py), numpy only.

`ImageTextDataset` holds what the training loop reads: images NHWC float32
in [-1, 1] and text embeddings [N, 512] in host memory.
`ProcessedMSCOCODataset` adds the captions and reads and writes the
reference pipeline's npy artifacts (`mscoco_{split}[_augmented]_images.npy`
CHW, `_text_embeddings.npy`, `_captions.npy`), as the JAX package's
(:22-110). `synthetic_dataset` is the JAX package's tiny fixture
(datasets.py:240-260), and `shapes_dataset` its coloured-shapes corpus
(datasets.py:157-237), each the same numbers from the same seed. The
processing pipeline that writes the artifacts is `data/pipeline.py`, its
augmentation `data/augment.py`. `EnhancedMSCOCODataset` (datasets.py:91)
adds k-means pseudo-labels for the prototype router (`prototype/training.py`).
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


@dataclass
class EnhancedMSCOCODataset:
    """A processed dataset with per-sample k-means expert pseudo-labels (and
    optional cluster descriptions), serving (image, text_embedding,
    cluster_label) (datasets.py:91-155)."""

    base: ImageTextDataset  # a ProcessedMSCOCODataset carries captions
    cluster_labels: np.ndarray  # [N] int
    cluster_descriptions: Optional[list] = None

    def __post_init__(self):
        if len(self.cluster_labels) != len(self.base):
            raise ValueError(f"{len(self.cluster_labels)} labels for {len(self.base)} samples")
        self.cluster_labels = np.asarray(self.cluster_labels, np.int32)

    @classmethod
    def from_dataset(cls, base: ImageTextDataset, n_clusters: int = 5, seed: int = 42,
                     clip_params=None) -> "EnhancedMSCOCODataset":
        """Cluster the text embeddings into pseudo-labels and name the clusters
        (by a CLIP pack's theme words when given, else by captions)."""
        from moegan_tpu_torch.prototype.training import analyze_clusters, cluster_text_embeddings

        labels, _ = cluster_text_embeddings(base.text_embeddings, n_clusters, seed)
        descriptions = analyze_clusters(base.text_embeddings, labels, clip_params=clip_params,
                                        captions=getattr(base, "captions", None))
        return cls(base, labels, descriptions)

    @property
    def images(self) -> np.ndarray:
        return self.base.images

    @property
    def text_embeddings(self) -> np.ndarray:
        return self.base.text_embeddings

    @property
    def captions(self):
        return getattr(self.base, "captions", None)

    @property
    def num_clusters(self) -> int:
        return int(self.cluster_labels.max()) + 1 if len(self.cluster_labels) else 0

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, idx):
        return self.images[idx], self.text_embeddings[idx], self.cluster_labels[idx]


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


# The coloured-shapes corpus: class = (colour, shape), templated captions, so
# that a from-scratch text/image pair (models/toy_clip.py) learns the alignment.
SHAPE_COLORS = {
    "red": (1.0, 0.1, 0.1),
    "green": (0.1, 0.9, 0.1),
    "blue": (0.15, 0.3, 1.0),
    "yellow": (1.0, 0.95, 0.1),
    "magenta": (1.0, 0.1, 0.9),
    "cyan": (0.1, 0.9, 0.9),
    "orange": (1.0, 0.55, 0.05),
    "white": (0.95, 0.95, 0.95),
}
SHAPE_KINDS = ("circle", "square", "triangle", "cross")
_CAPTION_TEMPLATES = (
    "a {color} {shape}",
    "the {color} {shape}",
    "a {color} {shape} on a dark background",
    "one {color} {shape} in the picture",
)


def shape_class_names() -> list:
    """Every (colour, shape) class caption in label order (colour-major)."""
    return [f"a {color} {shape}" for color in SHAPE_COLORS for shape in SHAPE_KINDS]


def _render_shape(kind: str, cx, cy, r, res: int, ss: int = 4) -> np.ndarray:
    """Antialiased [res, res] coverage of one shape, by ss x ss supersampling."""
    n = res * ss
    ys, xs = (np.mgrid[0:n, 0:n] + 0.5) / n
    if kind == "circle":
        mask = (xs - cx) ** 2 + (ys - cy) ** 2 <= r**2
    elif kind == "square":
        mask = (np.abs(xs - cx) <= r * 0.9) & (np.abs(ys - cy) <= r * 0.9)
    elif kind == "triangle":  # upright, inscribed in the radius
        mask = (ys <= cy + r * 0.8) & (
            np.abs(xs - cx) <= ((ys - (cy - r)) / (2 * r * 0.9 + 1e-9)) * r)
    elif kind == "cross":
        arm = r * 0.35
        mask = ((np.abs(xs - cx) <= arm) & (np.abs(ys - cy) <= r)) | (
            (np.abs(ys - cy) <= arm) & (np.abs(xs - cx) <= r))
    else:
        raise ValueError(kind)
    return mask.astype(np.float32).reshape(res, ss, res, ss).mean((1, 3))


def shapes_dataset(n: int = 4096, resolution: int = 16,
                   seed: int = 0) -> tuple[ProcessedMSCOCODataset, np.ndarray]:
    """(dataset, class labels): coloured shapes on a dark noisy background,
    [-1, 1] NHWC, with template captions and zero text embeddings (fill them
    with a trained text tower); labels index `shape_class_names()`."""
    rng = np.random.default_rng(seed)
    colors = list(SHAPE_COLORS)
    images = np.zeros((n, resolution, resolution, 3), np.float32)
    captions = np.empty(n, object)
    labels = np.zeros(n, np.int32)
    for i in range(n):
        ci = rng.integers(len(colors))
        si = rng.integers(len(SHAPE_KINDS))
        color, shape = colors[ci], SHAPE_KINDS[si]
        labels[i] = ci * len(SHAPE_KINDS) + si
        cx, cy = rng.uniform(0.35, 0.65, 2)
        r = rng.uniform(0.22, 0.34)
        mask = _render_shape(shape, cx, cy, r, resolution)
        bg = rng.uniform(0.03, 0.10) + 0.02 * rng.normal(size=(resolution, resolution, 1))
        rgb = np.asarray(SHAPE_COLORS[color], np.float32) * rng.uniform(0.85, 1.0)
        img01 = bg + mask[..., None] * (rgb - bg)
        images[i] = np.clip(img01 * 2.0 - 1.0, -1.0, 1.0)
        tmpl = _CAPTION_TEMPLATES[rng.integers(len(_CAPTION_TEMPLATES))]
        captions[i] = tmpl.format(color=color, shape=shape)
    embeds = np.zeros((n, 512), np.float32)
    return ProcessedMSCOCODataset(images, embeds, captions), labels
