"""train_aurora_gan: the training loop (counterpart of moegan_tpu/train/loop.py:31-205).

Each epoch: the KL-annealing and router-temperature schedules; the steps,
each with its noise from a generator seeded by (cfg.seed, step) on every
rank; EMA running losses every `log_interval` steps and the per-block
expert vectors at the end of the epoch; validation (the batch shrunk to a
multiple of the data-parallel size) whose metrics go to `metric_callback`,
which stops training early by returning False.

The loop is distributed when `distributed` is set and the process group
(initialised by the caller, or from `torchrun`'s environment) has more than
one rank: `parallel.api.setup_distributed_training` lays the ranks out as
cfg.mesh says.

With a tower pack `clip_params` (`models.clip.load_clip_params`, or a toy
pack) every step adds the multi-level CLIP loss and validation reports
`val_clip_loss*`. With `save_dir` the whole state is saved after every
epoch (`utils.checkpoint.save_checkpoint`, the newest three kept); with
`resume` the newest checkpoint there is restored and training continues at
the epoch after it. Since the noise of a step is seeded by (cfg.seed, step)
and the data order of an epoch by cfg.seed + epoch, a resumed run draws
what the uninterrupted run would. `transfer_from`, a generator state dict
of the previous progressive stage (`train.progressive`), is grafted into
the new state where names and shapes match, before `resume` restores
(under a mesh each rank grafts its own expert slices).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from moegan_tpu_torch.config import TrainConfig
from moegan_tpu_torch.data.loader import BatchLoader, prefetch_to_device
from moegan_tpu_torch.losses.gan import kl_annealing_factor, temperature_factor
from moegan_tpu_torch.parallel.api import setup_distributed_training
from moegan_tpu_torch.train.state import TrainState, count_params, create_train_state
from moegan_tpu_torch.train.step import make_eval_step, make_train_step
from moegan_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from moegan_tpu_torch.utils.metrics import EMAMeter, MetricLogger
from moegan_tpu_torch.utils.profiling import MemoryMonitor


def noise_generator(device, seed: int, index: int) -> torch.Generator:
    """The generator of one step's noise: seeded by (seed, index), the same on every rank."""
    return torch.Generator(device=device).manual_seed((seed << 32) | index)


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def train_aurora_gan(
    dataset,
    val_dataset=None,
    *,
    cfg: TrainConfig = TrainConfig(),
    clip_params=None,
    metric_callback: Optional[Callable[[int, dict], bool]] = None,
    save_dir: Optional[str] = None,
    resume: bool = False,
    distributed: bool = True,
    device=None,
    backend: Optional[str] = None,
    logger: Optional[MetricLogger] = None,
    transfer_from=None,
) -> TrainState:
    """Train the Aurora MoE-GAN; returns the final (this rank's) TrainState.

    `device` defaults to the card ("cuda", or `cuda:LOCAL_RANK` when
    distributed); pass "cpu" for the plain versions. `backend` is the
    process group's when this call initialises it (default "nccl").
    """
    log = logger or MetricLogger()
    loader = BatchLoader(dataset, cfg.batch_size, shuffle=True, seed=cfg.seed)
    steps_per_epoch = cfg.steps_per_epoch or loader.steps_per_epoch

    if distributed and _world_size() > 1:
        mesh, state, step_fn = setup_distributed_training(
            cfg, device=device, backend=backend, steps_per_epoch=steps_per_epoch)
    else:
        mesh = None
        state = create_train_state(cfg, device="cuda" if device is None else device)
        step_fn = make_train_step(cfg, steps_per_epoch)
    dev = state.generator.constant.device
    if transfer_from is not None:
        from moegan_tpu_torch.train.progressive import transfer_params

        grafted, copied = transfer_params(transfer_from, state.generator.state_dict())
        state.generator.load_state_dict(grafted)
        log.log_line(f"transferred {copied} generator tensors from the previous stage")
    eval_fn = make_eval_step(cfg)

    start_epoch = 0
    if resume and save_dir:
        state, start_epoch = restore_checkpoint(save_dir, state)
        if start_epoch:
            log.log_line(f"Resumed from {save_dir} at epoch {start_epoch}")

    log.log_line(f"Generator parameters: {count_params(state.generator, mesh):,} | "
                 f"Discriminator parameters: {count_params(state.discriminator, mesh):,}")
    mem = MemoryMonitor(interval=max(cfg.log_interval, 1) * 10, device=dev)
    ema = EMAMeter(0.9)
    step = state.step
    for epoch in range(start_epoch, cfg.num_epochs):
        eff_kl_w = cfg.loss.kl_weight * kl_annealing_factor(epoch, cfg.loss.kl_annealing_epochs)
        temp = temperature_factor(epoch)
        schedule = {"temperature_factor": temp, "effective_kl_weight": eff_kl_w}
        log.log_line(f"Epoch {epoch + 1}/{cfg.num_epochs} | temp_factor={temp:.2f} "
                     f"eff_kl_weight={eff_kl_w:.8f}")

        t_epoch = time.time()
        n_imgs = 0
        last_metrics = None
        for batch in prefetch_to_device(loader.epoch(epoch), dev, mesh=mesh):
            state, metrics = step_fn(state, batch, schedule, clip_params=clip_params,
                                     generator=noise_generator(dev, cfg.seed, step))
            last_metrics = metrics
            n_imgs += cfg.batch_size
            step += 1
            mem.step(step)
            if step % cfg.log_interval == 0:
                running = ema.update({k: float(v) for k, v in metrics.items() if v.dim() == 0})
                log.log_line(f"Step [{step}] Epoch [{epoch + 1}] "
                             + " ".join(f"{k}={v:.4f}" for k, v in sorted(running.items())))

        dt = time.time() - t_epoch
        log.log_metric("train_imgs_per_sec", n_imgs / max(dt, 1e-9), step)
        if last_metrics is not None:
            # The per-block routing vectors [num_blocks, E]: the collapse signal.
            log.log_vector("expert_util_per_block", last_metrics["expert_util"].tolist(), step)
            log.log_vector("expert_top1_per_block", last_metrics["expert_top1"].tolist(), step)

        val_bs = None
        if val_dataset is not None:
            # A val split smaller than the batch validates with a smaller
            # batch; only one smaller than the data-parallel size skips.
            val_bs = min(cfg.batch_size, len(val_dataset))
            if mesh is not None:
                val_bs = (val_bs // mesh.data_size) * mesh.data_size
            if val_bs <= 0:
                log.log_line(f"WARNING: validation SKIPPED - val split has {len(val_dataset)} "
                             "examples, fewer than the data-parallel shard count; no val "
                             "metrics this epoch")
                val_bs = None
            elif val_bs < cfg.batch_size:
                log.log_line(f"WARNING: val split ({len(val_dataset)}) smaller than batch_size "
                             f"({cfg.batch_size}); validating with batch_size={val_bs}")
        if val_bs:
            vloader = BatchLoader(val_dataset, val_bs, shuffle=False)
            sums: dict[str, float] = {}
            n_val = 0
            vbatches = prefetch_to_device(vloader.epoch(0), dev, mesh=mesh)
            for i, vbatch in enumerate(vbatches):
                # The eval stream counts down from the top of the 32-bit
                # index space, apart from the training steps' (step >= 0).
                vm = eval_fn(state, vbatch, schedule, clip_params=clip_params,
                             generator=noise_generator(dev, cfg.seed, 0xFFFF_FFFF - i))
                n_val += val_bs
                for k, v in vm.items():
                    sums[k] = sums.get(k, 0.0) + float(v) * val_bs
            val_metrics = {k: v / n_val for k, v in sums.items()}
            log.log_metrics(val_metrics, step)
            if metric_callback is not None and not metric_callback(epoch, val_metrics):
                log.log_line("Early stopping triggered by metric callback")
                break

        if save_dir:
            save_checkpoint(save_dir, state, epoch)
    return state
