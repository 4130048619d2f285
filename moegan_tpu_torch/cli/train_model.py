"""The training CLI (counterpart of moegan_tpu/cli/train_model.py).

    python -m moegan_tpu_torch.cli.train_model --synthetic [--tiny] [--device cpu]

The JAX CLI's flags and defaults, plus `--device` (default "cuda"; "cpu"
runs the plain versions). It trains with the multi-level CLIP loss unless
`--no_clip_loss` is given (the CLIP towers from CLIP_WEIGHTS_PATH's
converted `.npz`, else their random init), saves the whole training state
to `--save_dir` after every epoch (the newest three kept; `--resume`
continues from the newest), logs to `save_dir/metrics.jsonl`, and ends by
writing `aurora_model_final.msgpack` (the JAX package's flax msgpack
layout) and `generator_config.json`, which serving reads. Under `torchrun`
(WORLD_SIZE > 1) the ranks train together over the process group, each on
`cuda:LOCAL_RANK`, laid out as `--expert_parallelism` says (0: the largest
size dividing the world size and the expert count).
`--gradient_accumulation_steps k` applies an update every k steps, to the
mean of their gradients.
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the MoE-GAN (PyTorch port)")
    p.add_argument("--data_dir", type=str, default="./processed_data")
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--use_augmented", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="use the built-in synthetic fixture instead of COCO npy data")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--r1_gamma", type=float, default=10.0)
    p.add_argument("--kl_weight", type=float, default=1e-3)
    p.add_argument("--kl_annealing_epochs", type=int, default=5)
    p.add_argument("--lr_warmup_epochs", type=int, default=3)
    p.add_argument("--balance_weight", type=float, default=0.01)
    p.add_argument("--clip_weights", type=str, default=None,
                   help='JSON {"64": 0.1, "32": 0.05} keyed by resolution')
    p.add_argument("--no_clip_loss", action="store_true")
    p.add_argument("--max_resolution", type=int, default=64, choices=[16, 32, 64])
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--save_dir", type=str, default="./aurora_checkpoints")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--use_percentage", type=float, default=1.0)
    p.add_argument("--expert_parallelism", type=int, default=0,
                   help="0 = auto (gcd of the world size and num experts)")
    p.add_argument("--tiny", action="store_true",
                   help="shrink channels/router for smoke tests and CI")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK under torchrun) or cpu")
    return p


def config_from_args(args):
    from moegan_tpu_torch.config import (
        DiscriminatorConfig,
        GeneratorConfig,
        LossConfig,
        MeshConfig,
        TrainConfig,
    )

    r = args.max_resolution
    full = {4: 512, 8: 256, 16: 128, 32: 64, 64: 32}
    if args.tiny:
        full = {4: 32, 8: 24, 16: 16, 32: 16, 64: 8}
    channels = {k: v for k, v in full.items() if k <= r}
    if args.clip_weights:
        clip_weights = {int(k): float(v) for k, v in json.loads(args.clip_weights).items()}
    else:
        defaults = {64: 0.1, 32: 0.05, 16: 0.1 if r == 16 else 0.025,
                    8: 0.05 if r == 16 else 0.0125}
        clip_weights = {k: v for k, v in defaults.items() if k <= r}
    return TrainConfig(
        num_epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        beta1=args.beta1,
        beta2=args.beta2,
        lr_warmup_epochs=args.lr_warmup_epochs,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        log_interval=args.log_interval,
        seed=args.seed,
        loss=LossConfig(
            r1_gamma=args.r1_gamma,
            kl_weight=args.kl_weight,
            kl_annealing_epochs=args.kl_annealing_epochs,
            balance_weight=args.balance_weight,
            clip_weights=clip_weights,
        ),
        generator=GeneratorConfig(max_resolution=r, channels=channels,
                                  router_hidden=8 if args.tiny else 128),
        discriminator=DiscriminatorConfig(max_resolution=r),
        mesh=MeshConfig(expert_parallelism=args.expert_parallelism),
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    from moegan_tpu_torch import resolve_device
    from moegan_tpu_torch.data.datasets import ProcessedMSCOCODataset, synthetic_dataset
    from moegan_tpu_torch.parallel.sharding import gather_full
    from moegan_tpu_torch.train.loop import train_aurora_gan
    from moegan_tpu_torch.utils.checkpoint import save_generator_params
    from moegan_tpu_torch.utils.metrics import MetricLogger, is_writer

    distributed = int(os.environ.get("WORLD_SIZE", 1)) > 1
    device = args.device
    if distributed and device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    resolve_device(device)

    if args.synthetic:
        r = cfg.generator.max_resolution
        ds = synthetic_dataset(max(64, 2 * cfg.batch_size), r, seed=cfg.seed)
        val = synthetic_dataset(max(32, cfg.batch_size), r, seed=cfg.seed + 1)
    else:
        ds = ProcessedMSCOCODataset.load(args.data_dir, args.split, augmented=args.use_augmented,
                                         use_percentage=args.use_percentage)
        try:
            val = ProcessedMSCOCODataset.load(args.data_dir, "validation")
        except FileNotFoundError:
            val = None

    clip_params = None
    if not args.no_clip_loss:
        from moegan_tpu_torch.models.clip import load_clip_params

        clip_params = load_clip_params(device=device)

    os.makedirs(args.save_dir, exist_ok=True)
    logger = MetricLogger(os.path.join(args.save_dir, "metrics.jsonl"))
    try:
        state = train_aurora_gan(ds, val, cfg=cfg, clip_params=clip_params,
                                 save_dir=args.save_dir, resume=args.resume,
                                 distributed=distributed, device=device, logger=logger)
    finally:
        logger.close()
    generator = state.generator.state_dict()
    if state.mesh is not None:
        generator = gather_full(generator, state.mesh)
    if is_writer():
        final = os.path.join(args.save_dir, "aurora_model_final.msgpack")
        save_generator_params(final, generator)
        # Serving rebuilds the architecture from this (else from the param shapes).
        with open(os.path.join(args.save_dir, "generator_config.json"), "w") as f:
            f.write(cfg.generator.to_json())
        print(f"saved final generator to {final}")
    return state


if __name__ == "__main__":
    main()
