"""Offline dataset augmentation (counterpart of moegan_tpu/data/augment.py).

Each augmented copy of an image is one of three kinds, as in the JAX
package: a horizontal flip, a colour jitter (brightness, contrast,
saturation, each x U(0.8, 1.2)) or a random affine map (rotation within
5 degrees, translation within 5 % of the side, scale 0.95-1.05, bilinear
with zero fill), over [-1, 1] NHWC images.

The parameters are drawn on the host in the JAX function's order, from one
`np.random.default_rng(seed)`: for each of `aug_factor` rounds and each
image, `integers(3)` picks the kind, then the colour jitter draws its three
uniforms or the affine map its four (the flip draws nothing). So a seed
gives the same kinds and parameters as the JAX package's, image for image.
They are then applied on `device`, each kind to all its images at once.
The affine map's source coordinates are float64, as NumPy 2's promotion
makes them in the JAX function (a float64 cosine times the float32 grid).
"""

from __future__ import annotations

import numpy as np
import torch

KINDS = ("hflip", "color_jitter", "random_affine")
BRIGHTNESS = CONTRAST = SATURATION = 0.2
MAX_DEG, MAX_TRANSLATE, SCALE_RANGE = 5.0, 0.05, (0.95, 1.05)


def draw_params(kind: int, rng: np.random.Generator, height: int, width: int) -> tuple:
    """The parameters one image of `kind` draws from `rng`, in the JAX order:
    () for the flip, (b, c, s) for the jitter, (theta in radians, tx, ty,
    scale) for the affine map."""
    if kind == 1:
        return (rng.uniform(1 - BRIGHTNESS, 1 + BRIGHTNESS),
                rng.uniform(1 - CONTRAST, 1 + CONTRAST),
                rng.uniform(1 - SATURATION, 1 + SATURATION))
    if kind == 2:
        theta = float(np.deg2rad(rng.uniform(-MAX_DEG, MAX_DEG)))
        tx = rng.uniform(-MAX_TRANSLATE, MAX_TRANSLATE) * width
        ty = rng.uniform(-MAX_TRANSLATE, MAX_TRANSLATE) * height
        return theta, tx, ty, rng.uniform(*SCALE_RANGE)
    return ()


def hflip(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] images mirrored left to right."""
    return x.flip(2)


def color_jitter(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] in [-1, 1], params [N, 3] (brightness, contrast,
    saturation factors): the mean for contrast is over the whole image, the
    grey for saturation over the channels of each pixel."""
    b, c, s = (params[:, i, None, None, None].to(x.dtype) for i in range(3))
    x = (x + 1.0) * 0.5 * b
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    x = (x - mean) * c + mean
    gray = x.mean(dim=-1, keepdim=True)
    x = (x - gray) * s + gray
    return (x.clamp(0.0, 1.0) * 2.0 - 1.0).clamp(-1.0, 1.0)


def random_affine(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] float32, params [N, 4] float64 (theta, tx, ty, scale):
    each output pixel reads its inverse-mapped source bilinearly, taps
    outside the image reading 0."""
    n, H, W, C = x.shape
    theta, tx, ty, s = (params[:, i, None, None].double() for i in range(4))
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    cos, sin = torch.cos(theta) / s, torch.sin(theta) / s
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=x.device),
                            torch.arange(W, dtype=torch.float32, device=x.device), indexing="ij")
    # The JAX function subtracts in float32, then multiplies by float64 scalars.
    x0 = ((xs - cx)[None] - tx.float()).double()
    y0 = ((ys - cy)[None] - ty.float()).double()
    src_x = cos * x0 + sin * y0 + cx
    src_y = -sin * x0 + cos * y0 + cy
    x0i, y0i = src_x.floor().long(), src_y.floor().long()
    fx, fy = src_x - x0i, src_y - y0i
    flat = x.reshape(n, H * W, C)
    out = torch.zeros((n, H, W, C), dtype=torch.float64, device=x.device)
    for dy, dx, w in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                      (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yi, xi = y0i + dy, x0i + dx
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(n, H * W, 1)
        tap = flat.gather(1, idx.expand(n, H * W, C)).reshape(n, H, W, C)
        out += tap * (w * valid)[..., None]
    return out.clamp(-1.0, 1.0).float()


def apply_augmentations(images: torch.Tensor, kinds: np.ndarray, params: list) -> torch.Tensor:
    """Each image of `images` [N, H, W, C] augmented by its kind (`kinds`
    [N], indices into KINDS) with its drawn `params`, kind by kind."""
    out = torch.empty_like(images)
    for k, fn in enumerate((hflip, color_jitter, random_affine)):
        sel = np.flatnonzero(kinds == k)
        if not len(sel):
            continue
        idx = torch.as_tensor(sel, device=images.device)
        if k == 0:
            out[idx] = fn(images[idx])
        else:
            p = torch.as_tensor(np.array([params[i] for i in sel], np.float64),
                                device=images.device)
            out[idx] = fn(images[idx], p)
    return out


def create_augmentations(images: np.ndarray, text_embeddings: np.ndarray, captions=None, *,
                         aug_factor: int = 2, seed: int = 0, device="cuda"):
    """(aug_images, aug_embeddings, aug_captions): the originals followed by
    `aug_factor` augmented copies of every image, the embeddings and
    captions repeated with them. Images [N, H, W, 3] float32 in [-1, 1]; the
    augmentations run on `device` (raises without a card unless "cpu")."""
    from moegan_tpu_torch import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n, H, W = images.shape[:3]
    x = torch.as_tensor(np.ascontiguousarray(images, np.float32), device=dev)
    out_imgs = [images]
    for _ in range(aug_factor):
        kinds = np.empty(n, np.int64)
        params = []
        for i in range(n):
            kinds[i] = rng.integers(len(KINDS))
            params.append(draw_params(int(kinds[i]), rng, H, W))
        out_imgs.append(apply_augmentations(x, kinds, params).cpu().numpy())
    images_aug = np.concatenate(out_imgs, axis=0)
    embs_aug = np.concatenate([text_embeddings] * (aug_factor + 1), axis=0)
    caps_aug = (np.concatenate([captions] * (aug_factor + 1), axis=0)
                if captions is not None else None)
    return images_aug, embs_aug, caps_aug
