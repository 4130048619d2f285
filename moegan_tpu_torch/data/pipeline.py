"""Offline data processing: images + captions -> the trainer's npy artifacts
(counterpart of moegan_tpu/data/pipeline.py).

`run_pipeline` writes what the JAX package's writes, file for file:
`mscoco_{split}_images.npy` (float32 CHW in [-1, 1]), `_text_embeddings.npy`
(float32 [N, 512], CLIP ViT-B/32), `_captions.npy`, `mscoco_train_metadata.pkl`
(every one of the N samples, written before the split, as the JAX pipeline
leaves it), the validation split of min(max(1000, N // 5), N // 2) samples,
`mscoco_train_augmented_*`, `dataset_statistics.json` and `sample_grid.png`.

Where the port differs, for want of PIL and matplotlib on the card's machine:

- `resize_center_crop` resizes the short side with `F.interpolate`
  (bilinear, antialiased), rounds to 8 bits as PIL's bilinear resize does,
  then crops the centre: within one 8-bit step of PIL on every value. The
  images are resized on `device`, all images of one shape at once.
- Image files are read as `.npy` or PNG (`infer/png.py`); any other file,
  JPEG included, raises a ValueError that names it.
- `visualize_dataset` writes the sample grid as tiles without captions; the
  caption-length histogram is drawn only where matplotlib imports.
- The text embeddings come from the port's towers (`models/clip.py`) on
  `device`, 256 captions a batch.
"""

from __future__ import annotations

import json
import math
import os
import pickle
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

IMAGE_SIZE = 64
# Raw images held before they are resized: at most this many bytes, and at
# most RESIZE_BATCH images of one shape in one call.
PENDING_BYTES = 256 << 20
RESIZE_BATCH = 256


def read_image(path: str) -> np.ndarray:
    """An image file -> its array: `.npy` as saved, PNG as [H, W, 3] uint8."""
    from moegan_tpu_torch.infer.png import _SIGNATURE, decode_png

    if path.endswith(".npy"):
        return np.load(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _SIGNATURE:
        return decode_png(data)
    raise ValueError(f"{path}: only PNG and .npy images are read (there is no JPEG decoder "
                     "without PIL); convert the images to PNG or .npy first")


def _rgb_uint8(img: np.ndarray) -> np.ndarray:
    """HWC (or HW grey) -> [H, W, 3] uint8, as the JAX function hands it to PIL:
    non-uint8 values clipped to [0, 255] and truncated; alpha dropped."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] in (1, 2):
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _resize_batch(batch: np.ndarray, size: int, device) -> np.ndarray:
    """[n, h, w, 3] uint8 -> [n, size, size, 3] float32 in [-1, 1] on `device`."""
    h, w = batch.shape[1:3]
    scale = size / min(w, h)
    nw, nh = round(w * scale), round(h * scale)
    x = torch.as_tensor(batch, device=device).permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(nh, nw), mode="bilinear", antialias=True, align_corners=False)
    left, top = (nw - size) // 2, (nh - size) // 2
    x = x[:, :, top:top + size, left:left + size].round().clamp(0.0, 255.0) / 255.0
    return ((x - 0.5) / 0.5).permute(0, 2, 3, 1).cpu().numpy()


def resize_center_crop_batch(images, size: int = IMAGE_SIZE, device="cuda") -> np.ndarray:
    """Images (arrays, or paths for `read_image`) -> [N, size, size, 3] float32
    in [-1, 1]: each resized so that its short side is `size`, then cropped
    to the centre. Images of one shape are resized together on `device`."""
    from moegan_tpu_torch import resolve_device

    dev = resolve_device(device)
    images = list(images)
    out = np.empty((len(images), size, size, 3), np.float32)
    pending: dict = {}  # shape -> [(index, image)] not resized yet
    held = 0

    def flush(shape) -> int:
        idx, arrs = zip(*pending.pop(shape))
        out[list(idx)] = _resize_batch(np.stack(arrs), size, dev)
        return sum(a.nbytes for a in arrs)

    for i, item in enumerate(images):
        img = _rgb_uint8(read_image(item) if isinstance(item, str) else item)
        pending.setdefault(img.shape, []).append((i, img))
        held += img.nbytes
        if len(pending[img.shape]) >= RESIZE_BATCH:
            held -= flush(img.shape)
        elif held > PENDING_BYTES:
            for shape in list(pending):
                held -= flush(shape)
    for shape in list(pending):
        flush(shape)
    return out


def resize_center_crop(img: np.ndarray, size: int = IMAGE_SIZE, device="cuda") -> np.ndarray:
    """uint8/float HWC -> float32 [size, size, 3] in [-1, 1] (the short side
    resized to `size`, bilinear, then the centre cropped)."""
    return resize_center_crop_batch([img], size, device)[0]


def load_coco_from_dir(image_dir: str, captions_json: str,
                       max_samples: int = -1) -> tuple[list, list]:
    """A local COCO layout -> (image paths, the first caption of each image),
    in image-id order; `captions_json` has the official annotation schema
    (images[{id, file_name}], annotations[{image_id, caption}])."""
    with open(captions_json) as f:
        meta = json.load(f)
    id_to_file = {im["id"]: im["file_name"] for im in meta["images"]}
    id_to_caps: dict[int, list[str]] = {}
    for ann in meta["annotations"]:
        id_to_caps.setdefault(ann["image_id"], []).append(ann["caption"])
    paths, captions = [], []
    for img_id, fname in sorted(id_to_file.items()):
        p = os.path.join(image_dir, fname)
        caps = id_to_caps.get(img_id)
        if caps and os.path.exists(p):
            paths.append(p)
            captions.append(caps[0])
        if 0 < max_samples <= len(paths):
            break
    return paths, captions


def download_coco_with_fiftyone(split: str = "train", max_samples: int = 5000):
    """The FiftyOne zoo route; it raises where fiftyone is not installed."""
    try:
        import fiftyone.zoo as foz  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "fiftyone is not installed and this environment has no network "
            "egress; use load_coco_from_dir with a local COCO layout"
        ) from e
    ds = foz.load_zoo_dataset("coco-2017", split=split, label_types=["detections"],
                              max_samples=max_samples)
    return [s.filepath for s in ds], ["" for _ in ds]


def extract_clip_text_embeddings(captions: Sequence[str], clip_params=None,
                                 batch_size: int = 256, device="cuda") -> np.ndarray:
    """Captions -> float32 [N, 512] CLIP text embeddings, `batch_size` at a
    time, through `clip_params` (default: `load_clip_params(device=device)`)."""
    from moegan_tpu_torch.models.clip import load_clip_params

    if clip_params is None:
        clip_params = load_clip_params(device=device)
    out = []
    with torch.inference_mode():
        for i in range(0, len(captions), batch_size):
            emb = clip_params.encode_text(list(captions[i:i + batch_size]))
            out.append(emb.float().cpu().numpy())
    return np.concatenate(out, axis=0).astype(np.float32)


def process_dataset(image_paths_or_arrays, captions: Sequence[str], output_dir: str,
                    split: str = "train", *, image_size: int = IMAGE_SIZE, clip_params=None,
                    device="cuda") -> dict:
    """Images + captions -> the `mscoco_{split}_*` npy artifacts and metadata pkl."""
    from moegan_tpu_torch.data.datasets import ProcessedMSCOCODataset

    items = list(image_paths_or_arrays)
    if len(items) != len(captions):
        raise ValueError(f"{len(items)} images for {len(captions)} captions")
    imgs = resize_center_crop_batch(items, image_size, device)
    embeds = extract_clip_text_embeddings(captions, clip_params, device=device)
    ProcessedMSCOCODataset(imgs, embeds, np.asarray(list(captions), object)).save(
        output_dir, split)
    prefix = os.path.join(output_dir, f"mscoco_{split}")
    metadata = [{"index": i, "caption": c, "image_size": image_size}
                for i, c in enumerate(captions)]
    with open(f"{prefix}_metadata.pkl", "wb") as f:
        pickle.dump(metadata, f)
    return {"n": len(captions), "prefix": prefix}


def analyze_dataset(captions: Sequence[str], output_dir: Optional[str] = None) -> dict:
    """Caption statistics -> `dataset_statistics.json` in `output_dir`."""
    lengths = [len(str(c).split()) for c in captions]
    words: dict[str, int] = {}
    for c in captions:
        for w in str(c).lower().split():
            words[w] = words.get(w, 0) + 1
    top_words = sorted(words.items(), key=lambda kv: -kv[1])[:20]
    stats = {
        "num_samples": len(captions),
        "avg_caption_length": float(np.mean(lengths)) if lengths else 0.0,
        "min_caption_length": int(min(lengths)) if lengths else 0,
        "max_caption_length": int(max(lengths)) if lengths else 0,
        "top_words": top_words,
    }
    if output_dir:
        with open(os.path.join(output_dir, "dataset_statistics.json"), "w") as f:
            json.dump(stats, f, indent=2)
    return stats


def visualize_dataset(images_m11: np.ndarray, captions, output_dir: str, n: int = 16):
    """`sample_grid.png`: the first n images as tiles of a square grid; and,
    where matplotlib imports, `caption_lengths.png`, a histogram of the
    captions' lengths in words."""
    from moegan_tpu_torch.infer.png import encode_png

    os.makedirs(output_dir, exist_ok=True)
    n = min(n, len(images_m11))
    cols = int(math.ceil(math.sqrt(n)))
    h, w = images_m11.shape[1:3]
    grid = np.zeros((cols * h, cols * w, 3), np.uint8)
    for i in range(n):
        r, c = divmod(i, cols)
        tile = np.clip(np.round((np.asarray(images_m11[i]) + 1.0) * 127.5), 0, 255)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = tile.astype(np.uint8)
    with open(os.path.join(output_dir, "sample_grid.png"), "wb") as f:
        f.write(encode_png(grid))
    lengths = [len(str(c).split()) for c in captions] if captions is not None else []
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        print(f"visualization skipped: {e}")
        return
    if lengths:
        fig = plt.figure(figsize=(6, 3))
        plt.hist(lengths, bins=20)
        plt.xlabel("caption length (words)")
        fig.savefig(os.path.join(output_dir, "caption_lengths.png"), dpi=80)
        plt.close(fig)


def run_pipeline(image_paths_or_arrays, captions: Sequence[str], output_dir: str, *,
                 augment: bool = True, aug_factor: int = 2, image_size: int = IMAGE_SIZE,
                 clip_params=None, seed: int = 0, device="cuda") -> dict:
    """Process -> visualise -> analyse -> split -> augment, on `device`
    (raises without a card unless "cpu"). The validation split is the first
    min(max(1000, n // 5), n // 2) samples; the augmentation takes the train
    split. Returns {"stats", "n_train", "n_val"}."""
    from moegan_tpu_torch import resolve_device
    from moegan_tpu_torch.data.augment import create_augmentations
    from moegan_tpu_torch.data.datasets import ProcessedMSCOCODataset

    resolve_device(device)
    process_dataset(image_paths_or_arrays, captions, output_dir, "train",
                    image_size=image_size, clip_params=clip_params, device=device)
    ds = ProcessedMSCOCODataset.load(output_dir, "train", return_captions=True)

    visualize_dataset(ds.images, ds.captions, output_dir)
    stats = analyze_dataset(captions, output_dir)

    n = len(ds)
    n_val = min(max(1000, n // 5), n // 2)
    val = ProcessedMSCOCODataset(ds.images[:n_val], ds.text_embeddings[:n_val],
                                 ds.captions[:n_val] if ds.captions is not None else None)
    val.save(output_dir, "validation")
    train = ProcessedMSCOCODataset(ds.images[n_val:], ds.text_embeddings[n_val:],
                                   ds.captions[n_val:] if ds.captions is not None else None)
    train.save(output_dir, "train")

    if augment:
        ai, ae, ac = create_augmentations(train.images, train.text_embeddings, train.captions,
                                          aug_factor=aug_factor, seed=seed, device=device)
        ProcessedMSCOCODataset(ai, ae, ac).save(output_dir, "train", augmented=True)
    return {"stats": stats, "n_train": n - n_val, "n_val": n_val}
