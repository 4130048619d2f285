"""The port's data processing (`data/pipeline.py`, `data/augment.py`,
`infer/png.py`'s reader, `cli/process_data.py`) against the JAX package's
(`data/pipeline.py`, `data/augment.py`; PIL for images).

Inputs are made with numpy from a seed and handed to both. The end-to-end
case carries the port's CLIP text tower (float32) into the JAX layout; the
JAX pipeline encodes with it at its default bf16 compute, op by op (no jit).
"""

import io
import json
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from moegan_tpu.data import augment as jax_augment
from moegan_tpu.data import pipeline as jax_pipeline
from moegan_tpu.models.clip_jax import params_from_flat
from moegan_tpu_torch.convert import torch_to_jax
from moegan_tpu_torch.data import augment, pipeline
from moegan_tpu_torch.infer.png import decode_png
from moegan_tpu_torch.models import clip

LSB = 2.0 / 255.0  # one 8-bit step after the normalisation to [-1, 1]


def _raw(seed, n, shape):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape + (3,), dtype=np.uint8) for _ in range(n)]


def _images_m11(seed, n, h, w):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(0, 0.5, (n, h, w, 3)), -1, 1).astype(np.float32)


def test_resize_center_crop_within_one_step_of_pil():
    """PIL's bilinear resize in 8 bits against F.interpolate (antialiased) rounded
    to 8 bits, at COCO-like, square and odd shapes, images of one shape batched."""
    for i, shape in enumerate([(96, 128), (480, 640), (427, 640), (64, 64), (50, 70)]):
        raw = _raw(i, 3, shape)
        want = np.stack([jax_pipeline.resize_center_crop(im, 64) for im in raw])
        got = pipeline.resize_center_crop_batch(raw, 64, device="cpu")
        diff = np.abs(got - want)
        assert got.shape == (3, 64, 64, 3) and got.dtype == np.float32
        assert diff.max() <= LSB + 1e-6, (shape, diff.max() / LSB)
        assert diff.mean() <= 0.25 * LSB, (shape, diff.mean() / LSB)
    one = pipeline.resize_center_crop(raw[0].astype(np.float32) * 1.5, 32, device="cpu")
    np.testing.assert_allclose(one, jax_pipeline.resize_center_crop(raw[0] * 1.5, 32),
                               rtol=0, atol=LSB + 1e-6)


@pytest.mark.parametrize("kind", ["hflip", "color_jitter", "random_affine", "create"])
def test_augmentations_match_jax(kind):
    """Each kind on 12 images with parameters drawn in the JAX order from the same
    seed; `create_augmentations` with its kinds drawn too, embeddings and
    captions repeated alike."""
    imgs = _images_m11(1, 12, 16, 20)
    if kind == "create":
        embs = np.random.default_rng(2).normal(size=(12, 8)).astype(np.float32)
        caps = np.asarray([f"caption {i}" for i in range(12)], object)
        want = jax_augment.create_augmentations(imgs, embs, caps, aug_factor=2, seed=3)
        got = augment.create_augmentations(imgs, embs, caps, aug_factor=2, seed=3, device="cpu")
        assert got[0].shape == (36, 16, 20, 3) and got[0].dtype == np.float32
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got[1], want[1])
        assert list(got[2]) == list(want[2])
        return
    k = augment.KINDS.index(kind)
    fn = getattr(jax_augment, kind)
    jax_rng, rng = np.random.default_rng(5), np.random.default_rng(5)
    want = np.stack([fn(im) if k == 0 else fn(im, jax_rng) for im in imgs])
    params = [augment.draw_params(k, rng, 16, 20) for _ in imgs]
    got = augment.apply_augmentations(torch.from_numpy(imgs), np.full(12, k), params).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert rng.random() == jax_rng.random()  # both drew as many numbers


def test_analyze_dataset_matches_jax(tmp_path):
    caps = ["a cat on a mat", "a dog", "a cat sleeping on a sofa", "Dogs and CATS"]
    os.makedirs(tmp_path / "ours")
    os.makedirs(tmp_path / "jax")
    got = pipeline.analyze_dataset(caps, str(tmp_path / "ours"))
    want = jax_pipeline.analyze_dataset(caps, str(tmp_path / "jax"))
    assert got == want
    assert ((tmp_path / "ours" / "dataset_statistics.json").read_text()
            == (tmp_path / "jax" / "dataset_statistics.json").read_text())


def _coco_layout(root, n, shape=(40, 56)):
    """A COCO layout of PNG files (PIL-written), with two captions for image 0
    and one image without a caption."""
    os.makedirs(root / "imgs")
    for i, im in enumerate(_raw(7, n, shape)):
        Image.fromarray(im).save(root / "imgs" / f"img{i}.png")
    ann = {"images": [{"id": i, "file_name": f"img{i}.png"} for i in range(n)],
           "annotations": [{"image_id": 0, "caption": "first zero"},
                           {"image_id": 0, "caption": "second zero"}]
           + [{"image_id": i, "caption": f"image {i}"} for i in range(1, n - 1)]}
    (root / "captions.json").write_text(json.dumps(ann))
    return str(root / "imgs"), str(root / "captions.json")


def test_load_coco_from_dir_matches_jax(tmp_path):
    """The same paths and first captions, with and without max_samples; the PNG
    files read and resized within one step of the JAX pipeline's PIL route."""
    img_dir, cap_json = _coco_layout(tmp_path, 6)
    for max_samples in (-1, 3):
        got = pipeline.load_coco_from_dir(img_dir, cap_json, max_samples)
        assert got == jax_pipeline.load_coco_from_dir(img_dir, cap_json, max_samples)
    paths, _ = got
    ours = pipeline.resize_center_crop_batch(paths, 16, device="cpu")
    theirs = np.stack([jax_pipeline.resize_center_crop(
        np.asarray(Image.open(p).convert("RGB")), 16) for p in paths])
    assert np.abs(ours - theirs).max() <= LSB + 1e-6


def test_png_reader_matches_pil():
    """PIL-written PNGs of every 8-bit colour type (PIL picks the scanline
    filters) read as PIL's convert("RGB")."""
    rng = np.random.default_rng(9)
    img = (np.cumsum(rng.integers(0, 256, (37, 53, 3), dtype=np.uint8), axis=1) // 8)
    for mode in ("RGB", "L", "RGBA", "LA", "P"):
        pil = Image.fromarray(img.astype(np.uint8)).convert(mode)
        buf = io.BytesIO()
        pil.save(buf, format="PNG")
        np.testing.assert_array_equal(decode_png(buf.getvalue()),
                                      np.asarray(pil.convert("RGB")), err_msg=mode)


def test_jpeg_raises_naming_the_file(tmp_path):
    path = str(tmp_path / "photo.jpg")
    Image.fromarray(_raw(0, 1, (16, 16))[0]).save(path)
    with pytest.raises(ValueError, match="photo.jpg"):
        pipeline.resize_center_crop_batch([path], 16, device="cpu")


def test_run_pipeline_matches_jax(tmp_path):
    """10 images at 16x16 through both pipelines: every artifact in both
    directories; images within one step; the augmented copies, whose colour
    jitter scales a one-step difference of their input by up to 1.2^3, within
    1e-4 of the JAX augmentation of the port's own train split; embeddings (the port's float32 tower, JAX's bf16 on the same weights) to
    a cosine >= 0.9999; captions, metadata and split sizes equal."""
    raw = _raw(11, 10, (48, 72))
    caps = [f"synthetic caption number {i}" for i in range(10)]
    model = clip.init_clip_params(0, compute_dtype="float32").eval()
    text = {k: v for k, v in torch_to_jax(model.state_dict()).items() if k.startswith("text/")}
    ours, theirs = tmp_path / "ours", tmp_path / "jax"
    got = pipeline.run_pipeline(raw, caps, str(ours), aug_factor=1, image_size=16,
                                clip_params=model, device="cpu")
    want = jax_pipeline.run_pipeline(raw, caps, str(theirs), aug_factor=1, image_size=16,
                                     clip_params=params_from_flat(text))
    assert (got["n_train"], got["n_val"]) == (want["n_train"], want["n_val"]) == (5, 5)
    assert got["stats"] == want["stats"]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for split in ("train", "validation", "train_augmented"):
        a = np.load(ours / f"mscoco_{split}_images.npy")
        b = np.load(theirs / f"mscoco_{split}_images.npy")
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        n = len(a) if split != "train_augmented" else got["n_train"]
        assert np.abs(a[:n] - b[:n]).max() <= LSB + 1e-6, split
        ea = np.load(ours / f"mscoco_{split}_text_embeddings.npy")
        eb = np.load(theirs / f"mscoco_{split}_text_embeddings.npy")
        assert ea.dtype == eb.dtype == np.float32
        cos = (ea * eb).sum(-1) / (np.linalg.norm(ea, axis=-1) * np.linalg.norm(eb, axis=-1))
        assert cos.min() >= 0.9999, (split, cos.min())
        assert (list(np.load(ours / f"mscoco_{split}_captions.npy", allow_pickle=True))
                == list(np.load(theirs / f"mscoco_{split}_captions.npy", allow_pickle=True)))
    train = np.load(ours / "mscoco_train_images.npy").transpose(0, 2, 3, 1)
    aug = jax_augment.create_augmentations(train, np.zeros((5, 1)), aug_factor=1, seed=0)[0]
    np.testing.assert_allclose(
        np.load(ours / "mscoco_train_augmented_images.npy").transpose(0, 2, 3, 1), aug,
        rtol=0, atol=1e-4)
    with open(ours / "mscoco_train_metadata.pkl", "rb") as f, \
            open(theirs / "mscoco_train_metadata.pkl", "rb") as g:
        assert pickle.load(f) == pickle.load(g)  # all 10 samples, as the JAX pipeline leaves it
    with open(ours / "sample_grid.png", "rb") as f:
        assert decode_png(f.read()).shape == (4 * 16, 4 * 16, 3)
