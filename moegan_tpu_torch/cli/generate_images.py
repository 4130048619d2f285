"""Image generation CLI (counterpart of moegan_tpu/cli/generate_images.py):
load a generator file, sample images for a prompt, save them as one grid
PNG named after the prompt.

    python -m moegan_tpu_torch.cli.generate_images --model_path M --prompt "a red bird"
        [--num_samples 4] [--output_dir .] [--show_experts] [--device cpu]

The JAX CLI's flags, plus `--device` (default "cuda"; "cpu" runs the plain
versions). The prompt is encoded by the CLIP text tower (CLIP_WEIGHTS_PATH's
converted `.npz`, else the random init); z for `--seed` comes from a
`torch.Generator`, so the images differ from the JAX CLI's for the same seed.
The PNG is written with the standard library (`infer/png.py`).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate images from text (PyTorch port)")
    p.add_argument("--model_path", type=str, required=True,
                   help="generator file: .msgpack or .npz")
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--num_samples", type=int, default=4)
    p.add_argument("--truncation_psi", type=float, default=0.7)
    p.add_argument("--output_dir", type=str, default=".")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_resolution", type=int, default=64)
    p.add_argument("--show_experts", action="store_true",
                   help="print expert-utilization stats")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def save_grid(images_m11: np.ndarray, path: str):
    """Tile [N, H, W, 3] images in [-1, 1] into one grid PNG (ceil(sqrt(N))
    columns, the JAX CLI's pixels)."""
    from moegan_tpu_torch.infer.png import encode_png

    arr = np.clip((images_m11 + 1.0) * 127.5, 0, 255).astype(np.uint8)
    n, h, w, _ = arr.shape
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, img in enumerate(arr):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
    with open(path, "wb") as f:
        f.write(encode_png(grid))


def main(argv=None):
    args = build_parser().parse_args(argv)

    from moegan_tpu_torch.config import GeneratorConfig
    from moegan_tpu_torch.convert import jax_to_torch
    from moegan_tpu_torch.infer.sample import Sampler
    from moegan_tpu_torch.utils.checkpoint import load_generator_params

    full = {4: 512, 8: 256, 16: 128, 32: 64, 64: 32}
    cfg = GeneratorConfig(
        max_resolution=args.max_resolution,
        channels={k: v for k, v in full.items() if k <= args.max_resolution},
    )
    g_params = jax_to_torch(load_generator_params(args.model_path))
    sampler = Sampler(cfg, g_params, device=args.device)
    images, stats = sampler(args.prompt, args.num_samples, args.truncation_psi,
                            seed=args.seed, return_stats=True)

    os.makedirs(args.output_dir, exist_ok=True)
    fname = "_".join(args.prompt.split())[:64] + ".png"
    out_path = os.path.join(args.output_dir, fname)
    save_grid(images.float().cpu().numpy(), out_path)
    print(f"saved {args.num_samples} samples to {out_path}")
    if args.show_experts:
        import json

        print(json.dumps(stats, indent=2))
    return out_path


if __name__ == "__main__":
    main()
