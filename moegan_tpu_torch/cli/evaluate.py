"""Evaluation CLI (counterpart of moegan_tpu/cli/evaluate.py): FID and
CLIPScore of a generator file on a processed dataset, and optionally the
reference statistics that serving's FID reads.

    python -m moegan_tpu_torch.cli.evaluate --model_path M [--synthetic]
        [--save_reference_stats reference_stats.npz] [--device cpu]

The JAX CLI's flags, plus `--device` (default "cuda"; "cpu" runs the plain
versions). The generator file is a `.msgpack` or `.npz` of either package
(`utils/checkpoint.py::load_generator_params`). Prints `[METRIC] name:
value` lines and, last, the result as one JSON line.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Evaluate FID/CLIPScore (PyTorch port)")
    ap.add_argument("--model_path", type=str, required=True)
    ap.add_argument("--data_dir", type=str, default="")
    ap.add_argument("--split", type=str, default="validation")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--num_samples", type=int, default=10000)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--max_resolution", type=int, default=64)
    ap.add_argument("--truncation_psi", type=float, default=1.0)
    ap.add_argument("--save_reference_stats", type=str, default="",
                    help="also write reference_stats.npz from the real images")
    ap.add_argument("--feature_source", type=str, default="inception",
                    choices=("inception", "clip"),
                    help="FID feature space: InceptionV3 pool-2048 or CLIP-FID")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from moegan_tpu_torch.config import GeneratorConfig
    from moegan_tpu_torch.convert import jax_to_torch
    from moegan_tpu_torch.data.datasets import ProcessedMSCOCODataset, synthetic_dataset
    from moegan_tpu_torch.infer.evaluate import evaluate_fid_clipscore
    from moegan_tpu_torch.infer.fid import (
        FIDEvaluator,
        clip_feature_extractor,
        inception_feature_extractor,
    )
    from moegan_tpu_torch.models.clip import load_clip_params
    from moegan_tpu_torch.utils.checkpoint import load_generator_params

    full = {4: 512, 8: 256, 16: 128, 32: 64, 64: 32}
    cfg = GeneratorConfig(
        max_resolution=args.max_resolution,
        channels={k: v for k, v in full.items() if k <= args.max_resolution},
    )
    if args.synthetic or not args.data_dir:
        ds = synthetic_dataset(max(args.batch_size * 2, 64), args.max_resolution)
    else:
        ds = ProcessedMSCOCODataset.load(args.data_dir, args.split)

    g_params = jax_to_torch(load_generator_params(args.model_path))
    clip_params = load_clip_params(device=args.device)
    res = evaluate_fid_clipscore(
        g_params, ds, clip_params, cfg=cfg,
        num_samples=args.num_samples, batch_size=args.batch_size,
        truncation_psi=args.truncation_psi, feature_source=args.feature_source,
        device=args.device,
    )
    for name in ("fid", "clip_score"):
        if res.get(name) is not None:
            print(f"[METRIC] {name}: {res[name]:.6f}")

    if args.save_reference_stats:
        extractor = (
            inception_feature_extractor(device=args.device)
            if args.feature_source == "inception"
            else clip_feature_extractor(clip_params)
        )
        ev = FIDEvaluator(extractor)
        ev.set_reference_images(ds.images[: args.num_samples])
        ev.save_reference_stats(args.save_reference_stats)
        print(f"wrote {args.save_reference_stats}")

    print(json.dumps(res, default=str))
    return res


if __name__ == "__main__":
    main()
