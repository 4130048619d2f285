"""The managed training job (counterpart of moegan_tpu/cli/job_train.py).

    python -m moegan_tpu_torch.cli.job_train [--device cuda|cpu]

The contract of the reference's managed-training entry point, as the job
runner (`orchestration/jobs.py::JobRunner`) sets it up:

- HYPERPARAMETERS_PATH: a JSON of strings (default JOB_DIR/hyperparameters.json,
  where the job runner writes it), typed by `config.coerce_hyperparameters`
  and laid over the training CLI's defaults (`cli/train_model.py::build_parser`;
  `learning_rate` sets `lr`; a name the parser lacks changes nothing);
- DATA_DIR: the processed splits (`mscoco_train_*` of which the first
  `use_percentage` is used, `mscoco_validation_*` if present), resized to
  the configuration's resolution when they hold another; without it the
  synthetic fixture;
- JOB_DIR: `metrics.jsonl` (the `[METRIC] name: value` lines also go to
  stdout for the search's scraper) and `checkpoints/`;
- MODEL_DIR (default JOB_DIR/model): `aurora_model_final.msgpack` and
  `generator_config.json`, which serving reads.

The CLIP loss runs through `models.clip.load_clip_params` unless the
hyperparameter `no_clip_loss` is true. Training runs on `--device` (the card
by default; raises without one unless "cpu").
"""

from __future__ import annotations

import argparse
import json
import os


def apply_hyperparameters(args: argparse.Namespace, hp: dict) -> argparse.Namespace:
    """Set each typed hyperparameter on the training CLI's `args` where the
    parser has an attribute of its name (`learning_rate` sets `lr`)."""
    for key, val in hp.items():
        name = {"learning_rate": "lr"}.get(key, key)
        if hasattr(args, name):
            setattr(args, name, val)
    return args


def load_data(data_dir: str, resolution: int, batch_size: int, use_percentage: float = 1.0):
    """(train, validation or None) at `resolution`: DATA_DIR's processed
    splits when it holds them, else the synthetic fixture."""
    from moegan_tpu_torch.data.datasets import ProcessedMSCOCODataset, synthetic_dataset
    from moegan_tpu_torch.train.progressive import resize_dataset

    if data_dir and os.path.exists(os.path.join(data_dir, "mscoco_train_images.npy")):
        ds = ProcessedMSCOCODataset.load(data_dir, "train", use_percentage=use_percentage)
        try:
            val = ProcessedMSCOCODataset.load(data_dir, "validation")
        except FileNotFoundError:
            val = None
        return (resize_dataset(ds, resolution),
                resize_dataset(val, resolution) if val is not None else None)
    return (synthetic_dataset(max(64, 2 * batch_size), resolution),
            synthetic_dataset(max(32, batch_size), resolution, seed=1))


def main(argv=None):
    ap = argparse.ArgumentParser(description="Managed training job (PyTorch port)")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    opts = ap.parse_args(argv)

    from moegan_tpu_torch import resolve_device
    from moegan_tpu_torch.cli.train_model import build_parser, config_from_args
    from moegan_tpu_torch.config import coerce_hyperparameters
    from moegan_tpu_torch.train.loop import train_aurora_gan
    from moegan_tpu_torch.utils.checkpoint import save_generator_params
    from moegan_tpu_torch.utils.metrics import MetricLogger

    resolve_device(opts.device)
    job_dir = os.environ.get("JOB_DIR", ".")
    hp_path = os.environ.get("HYPERPARAMETERS_PATH", os.path.join(job_dir, "hyperparameters.json"))
    model_dir = os.environ.get("MODEL_DIR", os.path.join(job_dir, "model"))
    raw = {}
    if os.path.exists(hp_path):
        with open(hp_path) as f:
            raw = json.load(f)
    hp = coerce_hyperparameters(raw)
    args = apply_hyperparameters(build_parser().parse_args([]), hp)
    args.device = opts.device
    cfg = config_from_args(args)
    ds, val = load_data(os.environ.get("DATA_DIR", ""), cfg.generator.max_resolution,
                        cfg.batch_size, float(hp.get("use_percentage", 1.0)))

    clip_params = None
    if not hp.get("no_clip_loss", False):
        from moegan_tpu_torch.models.clip import load_clip_params

        clip_params = load_clip_params(device=opts.device)

    os.makedirs(job_dir, exist_ok=True)
    logger = MetricLogger(os.path.join(job_dir, "metrics.jsonl"))
    try:
        state = train_aurora_gan(ds, val, cfg=cfg, clip_params=clip_params,
                                 save_dir=os.path.join(job_dir, "checkpoints"), logger=logger,
                                 device=opts.device)
    finally:
        logger.close()
    os.makedirs(model_dir, exist_ok=True)
    final = os.path.join(model_dir, "aurora_model_final.msgpack")
    save_generator_params(final, state.generator.state_dict())
    with open(os.path.join(model_dir, "generator_config.json"), "w") as f:
        f.write(cfg.generator.to_json())
    print(f"saved {final}")
    return state


if __name__ == "__main__":
    main()
