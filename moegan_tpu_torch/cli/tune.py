"""Hyperparameter tuning (counterpart of moegan_tpu/cli/tune.py).

    python -m moegan_tpu_torch.cli.tune --config configs/hyperparameter_config.json \\
        [--trial_mode in-process|subprocess] [--data_dir D | --synthetic] [--device cpu]

It reads the reference's search-space JSON, runs `--max_jobs` trials,
`--max_parallel_jobs` at a time (`hpo/search.py::run_hpo`), keeps the best on
the objective (val_clip_loss, Minimize) and writes `best_hyperparameters.json`,
`trial_timeline.json` and `model_metrics.json` to `--out_dir`.

A trial trains the configuration the training CLI's defaults give at
`--max_resolution`, with the trial's hyperparameters laid over them where the
training parser has an attribute of their name (so the search space's
`clip_weight_64` and `clip_weight_32` change nothing, as in the JAX package):

- in-process: each trial a `train_aurora_gan` call on `--device` in a thread
  of this process, with the CLIP loss (`models.clip.load_clip_params`, one
  frozen tower pack read by every trial) and the metric callback for early
  stopping. The threads share the kernel libraries (`ops/_build.py` loads
  under a lock), the launch plans (pure functions behind `lru_cache`) and the
  kernels' launch counters, plain ints that a race may leave short; each
  trial has its own state, optimizer, loader thread and noise generators;
- subprocess: each trial a `cli.job_train --device ...` process of a
  `JobRunner`; its `[METRIC]` lines feed the early stop, which stops the job.

The data is `--data_dir`'s processed splits (resized to the trial's
resolution when they hold another) or the synthetic fixture.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="Hyperparameter tuning (PyTorch port)")
    ap.add_argument("--config", type=str, required=True,
                    help="search-space JSON (reference schema)")
    ap.add_argument("--max_jobs", type=int, default=10)
    ap.add_argument("--max_parallel_jobs", type=int, default=2)
    ap.add_argument("--warmup_jobs", type=int, default=4)
    ap.add_argument("--strategy", type=str, default="tpe", choices=("tpe", "perturb"))
    ap.add_argument("--trial_mode", type=str, default="in-process",
                    choices=("in-process", "subprocess"),
                    help="subprocess runs each trial as a JobRunner process; in-process "
                         "runs trials as threads of this process")
    ap.add_argument("--out_dir", type=str, default="./hpo_results")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--data_dir", type=str, default="")
    ap.add_argument("--max_resolution", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import moegan_tpu_torch
    from moegan_tpu_torch import resolve_device
    from moegan_tpu_torch.hpo.search import SearchSpace, describe_best, run_hpo, trial_timeline
    from moegan_tpu_torch.orchestration.pipeline import publish_model_metrics

    resolve_device(args.device)
    space = SearchSpace.from_json_file(args.config)
    use_data = bool(args.data_dir) and not args.synthetic

    def in_process_train_fn():
        from moegan_tpu_torch.cli.job_train import apply_hyperparameters
        from moegan_tpu_torch.cli.train_model import build_parser, config_from_args
        from moegan_tpu_torch.config import coerce_hyperparameters
        from moegan_tpu_torch.data.datasets import ProcessedMSCOCODataset, synthetic_dataset
        from moegan_tpu_torch.models.clip import load_clip_params
        from moegan_tpu_torch.train.loop import train_aurora_gan
        from moegan_tpu_torch.train.progressive import resize_dataset

        if use_data:
            ds = ProcessedMSCOCODataset.load(args.data_dir, "train")
            val = ProcessedMSCOCODataset.load(args.data_dir, "validation")
        else:
            ds = synthetic_dataset(64, args.max_resolution, seed=args.seed)
            val = synthetic_dataset(32, args.max_resolution, seed=args.seed + 1)
        clip_params = load_clip_params(device=args.device)

        def train_fn(params: dict, report) -> dict:
            hp = coerce_hyperparameters({k: str(v) for k, v in params.items()})
            cli = build_parser().parse_args([])
            cli.max_resolution = args.max_resolution
            cfg = config_from_args(apply_hyperparameters(cli, hp))
            r = cfg.generator.max_resolution
            final = {}

            def cb(epoch, metrics):
                final.clear()
                final.update(metrics)
                return report(epoch, metrics)

            train_aurora_gan(resize_dataset(ds, r), resize_dataset(val, r), cfg=cfg,
                             clip_params=clip_params, metric_callback=cb, distributed=True,
                             device=args.device)
            return final

        return train_fn

    def subprocess_train_fn():
        """Each trial one JobRunner process; its [METRIC] lines feed the
        reporter, and a False return stops the job."""
        from moegan_tpu_torch.orchestration.jobs import JobRunner, python_job

        runner = JobRunner(os.path.join(args.out_dir, "jobs"))
        # The trial's interpreter imports this package from where this one does.
        root = os.path.dirname(os.path.dirname(os.path.abspath(moegan_tpu_torch.__file__)))
        path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)

        def train_fn(params: dict, report) -> dict:
            hp = {k: str(v) for k, v in params.items()}
            hp.setdefault("max_resolution", str(args.max_resolution))
            env = {"MPLBACKEND": "Agg", "PYTHONPATH": path}
            if use_data:
                env["DATA_DIR"] = args.data_dir
            rec = runner.submit(python_job("hpo-trial", "moegan_tpu_torch.cli.job_train",
                                           "--device", args.device, hyperparameters=hp,
                                           environment=env))
            seen = 0
            while runner.poll(rec.job_name).status == "InProgress":
                vals = runner.metrics(rec.job_name, space.objective_name)
                for epoch, v in enumerate(vals[seen:], start=seen):
                    if not report(epoch, {space.objective_name: v}):
                        runner.stop(rec.job_name)
                        break
                seen = len(vals)
                time.sleep(0.5)
            vals = runner.metrics(rec.job_name, space.objective_name)
            return {space.objective_name: vals[-1]} if vals else {}

        return train_fn

    os.makedirs(args.out_dir, exist_ok=True)
    train_fn = (subprocess_train_fn() if args.trial_mode == "subprocess"
                else in_process_train_fn())
    best, trials = run_hpo(space, train_fn, max_jobs=args.max_jobs,
                           max_parallel_jobs=args.max_parallel_jobs,
                           warmup_jobs=args.warmup_jobs, seed=args.seed, strategy=args.strategy)

    info = describe_best(best)
    with open(os.path.join(args.out_dir, "best_hyperparameters.json"), "w") as f:
        json.dump(info, f, indent=2)
    with open(os.path.join(args.out_dir, "trial_timeline.json"), "w") as f:
        json.dump(trial_timeline(trials), f, indent=2)
    publish_model_metrics({space.objective_name: best.objective},
                          os.path.join(args.out_dir, "model_metrics.json"),
                          training_job=info["BestTrainingJob"], hyperparameters=best.params)
    print(json.dumps(info, indent=2))
    return info


if __name__ == "__main__":
    main()
