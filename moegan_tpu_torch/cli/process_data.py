"""Data processing (counterpart of moegan_tpu/cli/process_data.py).

    python -m moegan_tpu_torch.cli.process_data (--image_dir I --captions_json J | --synthetic N)
        [--output_dir ./processed_data] [--device cuda|cpu]

Runs `data/pipeline.py::run_pipeline` on a local COCO layout (PNG or .npy
images) or on N synthetic 96x128 images with numbered captions (the JAX
CLI's, from `np.random.default_rng(0)`), with the JAX CLI's flags plus
`--device` (default cuda; raises without a card unless "cpu").
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description="Process a dataset into training npy artifacts")
    ap.add_argument("--image_dir", type=str, help="local COCO-style image dir")
    ap.add_argument("--captions_json", type=str, help="COCO captions annotations json")
    ap.add_argument("--output_dir", type=str, default="./processed_data")
    ap.add_argument("--max_samples", type=int, default=-1)  # -1: all
    ap.add_argument("--no_augmentation", action="store_true")
    ap.add_argument("--aug_factor", type=int, default=2)
    ap.add_argument("--image_size", type=int, default=64)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate N synthetic samples instead of reading COCO")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from moegan_tpu_torch import resolve_device
    from moegan_tpu_torch.data.pipeline import load_coco_from_dir, run_pipeline

    resolve_device(args.device)
    if args.synthetic:
        import numpy as np

        rng = np.random.default_rng(0)
        raw = [rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
               for _ in range(args.synthetic)]
        captions = [f"synthetic sample number {i}" for i in range(args.synthetic)]
    else:
        if not (args.image_dir and args.captions_json):
            raise SystemExit("need --image_dir and --captions_json (or --synthetic N)")
        raw, captions = load_coco_from_dir(args.image_dir, args.captions_json, args.max_samples)

    info = run_pipeline(raw, captions, args.output_dir, augment=not args.no_augmentation,
                        aug_factor=args.aug_factor, image_size=args.image_size,
                        device=args.device)
    print(f"processed: {info['n_train']} train / {info['n_val']} val -> {args.output_dir}")
    return info


if __name__ == "__main__":
    main()
