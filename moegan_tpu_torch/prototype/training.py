"""Prototype router training: k-means pseudo-labels and supervised router
training (counterpart of moegan_tpu/prototype/training.py).

`kmeans` is Lloyd's algorithm with k-means++ seeding in numpy, the JAX
module's fallback route, and the port's only one: the card's machine has no
scikit-learn, so the port never imports it. `analyze_clusters` names each
cluster by the port's CLIP text tower (`models/clip.py`). The router trains
with cross-entropy + kl_weight * KL + balance_weight * KL(usage || uniform)
under AdamW (optax's defaults: weight decay 1e-4), its weight noise drawn
from a `torch.Generator` on the device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from moegan_tpu_torch.prototype.gating import BayesianMoEGatingNetwork

CLUSTER_THEMES = [
    "landscape", "nature", "mountains", "ocean", "beach",
    "person", "portrait", "people", "crowd", "family",
    "urban", "city", "street", "building", "architecture",
    "animal", "wildlife", "pet", "dog", "cat",
    "food", "meal", "cooking", "kitchen", "dining",
    "abstract", "concept", "idea", "emotion", "feeling",
    "sports", "activity", "game", "playing", "exercise",
    "vehicle", "car", "transportation", "travel", "journey",
    "weather", "sky", "clouds", "rain", "sunset",
    "indoor", "room", "furniture", "home", "interior",
]
ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


def kmeans(embeddings: np.ndarray, n_clusters: int, seed: int = 42, n_init: int = 10,
           max_iter: int = 300):
    """(labels [N], centres [k, D]): the best of `n_init` runs of Lloyd's
    algorithm from k-means++ seeds drawn with `default_rng(seed)`, in numpy
    (the JAX module's numpy route, training.py:50-73)."""
    rng = np.random.default_rng(seed)
    best_labels, best_centers, best_inertia = None, None, np.inf
    for _ in range(n_init):
        centers = [embeddings[rng.integers(len(embeddings))]]
        for _ in range(n_clusters - 1):
            d2 = np.min(((embeddings[:, None] - np.asarray(centers)[None]) ** 2).sum(-1), axis=1)
            centers.append(embeddings[rng.choice(len(embeddings), p=d2 / d2.sum())])
        centers = np.asarray(centers)
        for _ in range(max_iter):
            d = ((embeddings[:, None] - centers[None]) ** 2).sum(-1)
            labels = d.argmin(1)
            new_centers = np.stack([
                embeddings[labels == k].mean(0) if (labels == k).any() else centers[k]
                for k in range(n_clusters)
            ])
            if np.allclose(new_centers, centers):
                break
            centers = new_centers
        inertia = float(((embeddings - centers[labels]) ** 2).sum())
        if inertia < best_inertia:
            best_labels, best_centers, best_inertia = labels, centers, inertia
    return best_labels, best_centers


def cluster_text_embeddings(text_embeddings: np.ndarray, n_clusters: int = 5, seed: int = 42):
    """Cluster text embeddings into expert pseudo-labels: (labels, centres)."""
    return kmeans(np.asarray(text_embeddings, np.float32), n_clusters, seed)


def analyze_clusters(text_embeddings: np.ndarray, cluster_labels: np.ndarray, clip_params=None,
                     captions=None, top_k: int = 3) -> list[str]:
    """Name each cluster: with a CLIP pack (`models.clip.CLIP`) by its centroid's
    cosine against the 50 theme words, else by up to `top_k` of its captions."""
    n_clusters = int(np.max(cluster_labels)) + 1
    theme_embs = None
    if clip_params is not None:
        with torch.no_grad():
            theme_embs = clip_params.encode_text(CLUSTER_THEMES).float().cpu().numpy()
        theme_embs /= np.linalg.norm(theme_embs, axis=-1, keepdims=True) + 1e-8

    descriptions = []
    for c in range(n_clusters):
        idx = np.where(cluster_labels == c)[0]
        desc = f"Cluster {c} ({len(idx)} samples)"
        if theme_embs is not None and len(idx):
            centroid = np.mean(np.asarray(text_embeddings)[idx], axis=0)
            centroid /= np.linalg.norm(centroid) + 1e-8
            top = np.argsort(theme_embs @ centroid)[::-1][:top_k]
            desc += ": " + ", ".join(CLUSTER_THEMES[t] for t in top)
        elif captions is not None and len(idx):
            desc += ": e.g. " + "; ".join(str(captions[i]) for i in idx[:top_k])
        descriptions.append(desc)
    return descriptions


def balance_loss_uniform(probs: torch.Tensor) -> torch.Tensor:
    """KL(mean expert usage || uniform)."""
    usage = probs.mean(dim=0)
    n = probs.shape[-1]
    return torch.sum(usage * (torch.log(usage + 1e-10) - math.log(1.0 / n)))


def cluster_loss(gating: BayesianMoEGatingNetwork, x: torch.Tensor, y: torch.Tensor, eps,
                 kl_weight: float = 1e-5, balance_weight: float = 0.001):
    """(loss, cross-entropy) of one sampled forward with the network noise eps."""
    probs, kl, logits = gating(x, sample=True, eps=eps)
    ce = F.cross_entropy(logits, y)
    return ce + kl_weight * kl + balance_weight * balance_loss_uniform(probs), ce


def train_moe_with_clusters(text_embeddings, cluster_labels: Optional[np.ndarray] = None, *,
                            hidden_dim: int = 256, num_experts: Optional[int] = None,
                            epochs: int = 10, batch_size: int = 64, lr: float = 1e-3,
                            kl_weight: float = 1e-5, balance_weight: float = 0.001,
                            val_fraction: float = 0.2, seed: int = 0, device="cuda"):
    """Supervised router training against cluster labels (training.py:137-209).

    Takes (text_embeddings, cluster_labels) arrays or an `EnhancedMSCOCODataset`.
    The first `val_fraction` of the samples validate; each epoch shuffles the
    rest with `default_rng(seed)`. Returns (gating, history): history has each
    epoch's mean train loss and the validation accuracy of the mean weights."""
    from moegan_tpu_torch import resolve_device

    if cluster_labels is None and hasattr(text_embeddings, "cluster_labels"):
        ds = text_embeddings
        text_embeddings, cluster_labels = ds.text_embeddings, ds.cluster_labels
    if cluster_labels is None:
        raise ValueError("need cluster_labels or an EnhancedMSCOCODataset")
    dev = resolve_device(device)
    emb = torch.as_tensor(np.asarray(text_embeddings, np.float32), device=dev)
    labels = torch.as_tensor(np.asarray(cluster_labels, np.int64), device=dev)
    num_experts = num_experts or int(labels.max()) + 1

    n_val = max(1, int(len(emb) * val_fraction))
    val_emb, val_lab = emb[:n_val], labels[:n_val]
    tr_emb, tr_lab = emb[n_val:], labels[n_val:]

    gating = BayesianMoEGatingNetwork(emb.shape[-1], hidden_dim, num_experts,
                                      gen=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.AdamW(gating.parameters(), lr, weight_decay=ADAMW_WEIGHT_DECAY)
    noise = torch.Generator(device=dev).manual_seed(seed)
    rng_np = np.random.default_rng(seed)
    history = {"train_loss": [], "val_accuracy": []}
    n_batches = max(1, len(tr_emb) // batch_size)
    for _ in range(epochs):
        order = torch.as_tensor(rng_np.permutation(len(tr_emb)), device=dev)
        losses = []
        for b in range(n_batches):
            idx = order[b * batch_size:(b + 1) * batch_size]
            loss, _ = cluster_loss(gating, tr_emb[idx], tr_lab[idx], gating.draw_noise(noise),
                                   kl_weight, balance_weight)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        with torch.no_grad():
            _, _, logits = gating(val_emb, sample=False)
            acc = (logits.argmax(-1) == val_lab).float().mean()
        history["train_loss"].append(float(torch.stack(losses).mean()))
        history["val_accuracy"].append(float(acc))
    return gating, history


def train_bayesian_moe_gating(text_embeddings: np.ndarray, *, num_experts: int = 4,
                              hidden_dim: int = 128, epochs: int = 5, seed: int = 0, **kw):
    """The pseudo-label bring-up run: random expert labels from `default_rng(seed)`."""
    labels = np.random.default_rng(seed).integers(0, num_experts, size=len(text_embeddings))
    return train_moe_with_clusters(text_embeddings, labels, num_experts=num_experts,
                                   hidden_dim=hidden_dim, epochs=epochs, seed=seed, **kw)
