"""FID (counterpart of moegan_tpu/infer/fid.py).

Features come from a batched extractor on the card; the Gaussian fit and
the Fréchet distance are numpy and scipy on the host, the JAX package's
code: scipy `sqrtm` (one 2048x2048 product takes seconds on the host), a
symmetric eigendecomposition when it gives a non-finite result, and the
μ=0, Σ=I 2048-d fallback when `reference_stats.npz` is missing. Extractors:

- `inception_feature_extractor` (default): the InceptionV3 pool-2048 tower
  (`models/inception.py`), random init unless INCEPTION_WEIGHTS_PATH names
  converted weights;
- `clip_feature_extractor`: the CLIP image tower (512-d, CLIP-FID);
- any callable images [-1, 1] NHWC -> [N, D] numpy features.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Optional

import numpy as np
import torch


def gaussian_stats(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of a feature matrix [N, D]."""
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _psd_sqrtm(mat: np.ndarray) -> np.ndarray:
    """Matrix square root: scipy `sqrtm`, its warnings silenced; a non-finite
    result (or a failed call) falls through to the symmetric eigendecomposition."""
    try:
        from scipy import linalg

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = linalg.sqrtm(mat)
        res = res[0] if isinstance(res, tuple) else res
        if np.isfinite(res).all():
            return res
    except (ImportError, ValueError, np.linalg.LinAlgError):
        pass
    w, v = np.linalg.eigh((mat + mat.T) / 2)
    w = np.clip(w, 0, None)
    return (v * np.sqrt(w)) @ v.T


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    covmean = _psd_sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _psd_sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def batched_extractor(feats_fn: Callable, batch_size: int, device) -> Callable:
    """images [N, H, W, 3] in [-1, 1] (numpy or a tensor) -> numpy features
    [N, D], `feats_fn` applied on `device` to chunks of `batch_size`. Each
    image's features depend on that image alone, so the last chunk runs as it
    is (the JAX package pads it to one compiled shape)."""

    @torch.inference_mode()
    def extract(images_m11) -> np.ndarray:
        out = []
        for i in range(0, len(images_m11), batch_size):
            chunk = torch.as_tensor(images_m11[i:i + batch_size]).to(device, torch.float32)
            out.append(feats_fn(chunk).float().cpu().numpy())
        return np.concatenate(out, axis=0)

    return extract


def clip_feature_extractor(clip, batch_size: int = 8) -> Callable:
    """The CLIP image tower (`models/clip.py::CLIP`, on its device) as the
    feature source (CLIP-FID)."""
    return batched_extractor(clip.image_features, batch_size, clip.device)


def inception_feature_extractor(inception_params=None, batch_size: int = 8,
                                variant: str = "torchvision", device="cuda") -> Callable:
    """InceptionV3 pool-2048 features in bf16 on `device`, from `inception_params`
    (the `.npz` layout; default `load_inception_params()`: INCEPTION_WEIGHTS_PATH,
    else the random init)."""
    from moegan_tpu_torch import resolve_device
    from moegan_tpu_torch.models.inception import inception_model

    dev = resolve_device(device)
    model = inception_model(inception_params, device=dev)
    return batched_extractor(lambda x: model.features(x, variant), batch_size, dev)


class FIDEvaluator:
    """FID against reference statistics, with the μ=0, Σ=I fallback.

    The default extractor is InceptionV3 on `device`. Statistics files are
    `np.savez(mu=, sigma=)`, read and written alike by both packages."""

    def __init__(self, extractor: Optional[Callable] = None,
                 reference_stats_path: Optional[str] = None, feature_dim: int = 2048,
                 device="cuda"):
        if extractor is None:
            extractor = inception_feature_extractor(device=device)
        self.extractor = extractor
        self.feature_dim = feature_dim
        self.ref_mu: Optional[np.ndarray] = None
        self.ref_sigma: Optional[np.ndarray] = None
        if reference_stats_path:
            self.load_reference_stats(reference_stats_path)

    def load_reference_stats(self, path: str):
        """The file's (mu, sigma) (a relative path is read from the working
        directory), else the fallback μ=0, Σ=I of `feature_dim`."""
        if os.path.exists(path):
            with np.load(path) as data:
                self.ref_mu, self.ref_sigma = data["mu"], data["sigma"]
        else:
            self.ref_mu = np.zeros(self.feature_dim)
            self.ref_sigma = np.eye(self.feature_dim)

    def set_reference_images(self, images_m11):
        feats = self.extractor(images_m11)
        self.ref_mu, self.ref_sigma = gaussian_stats(feats)
        self.feature_dim = feats.shape[-1]

    def save_reference_stats(self, path: str):
        np.savez(path, mu=self.ref_mu, sigma=self.ref_sigma)

    def __call__(self, images_m11) -> float:
        if self.ref_mu is None:
            self.load_reference_stats("reference_stats.npz")
        feats = self.extractor(images_m11)
        mu, sigma = gaussian_stats(feats)
        return frechet_distance(mu, sigma, self.ref_mu, self.ref_sigma)
