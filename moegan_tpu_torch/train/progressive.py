"""Progressive multi-resolution training, 16 -> 32 -> 64 (counterpart of
moegan_tpu/train/progressive.py).

Each stage trains at one resolution with `train_aurora_gan`. When the
ladder grows, every generator tensor whose name and shape exist in the next
stage's model (the mapping network, the text projection, the constant, the
lower-resolution blocks and RGB taps) is carried over, and only the new
block and its RGB tap start fresh. The discriminator changes topology with
its input resolution, so each stage builds a new one. Stage checkpoints go
to `save_dir/stage_{r}`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from moegan_tpu_torch.config import TrainConfig
from moegan_tpu_torch.train.loop import train_aurora_gan
from moegan_tpu_torch.utils.metrics import MetricLogger

# The reference's channel ladder, halving from 512 at 4x4 (progressive.py:26).
FULL_CHANNELS = {4: 512, 8: 256, 16: 128, 32: 64, 64: 32}


def transfer_params(old: Mapping[str, torch.Tensor],
                    new: Mapping[str, torch.Tensor]) -> tuple[dict, int]:
    """(`new` with every tensor of `old` whose name and shape it shares in its
    place, the number of tensors taken from `old`) (progressive.py:29-40)."""
    out = dict(new)
    copied = 0
    for name, t in old.items():
        if name in out and tuple(out[name].shape) == tuple(t.shape):
            out[name] = t
            copied += 1
    return out, copied


def resize_dataset(ds, resolution: int):
    """The dataset with its images resized to `resolution` (progressive.py:43-54).

    `jax.image.resize(..., "bilinear")` antialiases: downsampling by s it
    weighs source pixels with a triangle widened by s. `F.interpolate`
    with `antialias=True` computes the same weights (to float32 rounding).
    """
    if ds.images.shape[1] == resolution:
        return ds
    x = torch.from_numpy(np.ascontiguousarray(ds.images, np.float32)).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(resolution, resolution), mode="bilinear", antialias=True,
                      align_corners=False)
    return dataclasses.replace(ds, images=y.permute(0, 2, 3, 1).contiguous().numpy())


def stage_config(cfg: TrainConfig, resolution: int, epochs: int) -> TrainConfig:
    """`cfg` cut to one stage (progressive.py:57-67): the generator's channels
    up to `resolution` (cfg's own where they reach it, else FULL_CHANNELS),
    D at `resolution`, the CLIP weights of the taps up to it, `epochs` epochs."""
    channels = {k: v for k, v in FULL_CHANNELS.items() if k <= resolution}
    if cfg.generator.channels and max(cfg.generator.channels) >= resolution:
        channels = {k: v for k, v in cfg.generator.channels.items() if k <= resolution}
    clip_weights = {k: v for k, v in cfg.loss.clip_weights.items() if k <= resolution}
    return cfg.replace(
        num_epochs=epochs,
        generator=cfg.generator.replace(max_resolution=resolution, channels=channels),
        discriminator=cfg.discriminator.replace(max_resolution=resolution),
        loss=cfg.loss.replace(clip_weights=clip_weights),
    )


def train_progressive(
    dataset,
    val_dataset=None,
    *,
    cfg: TrainConfig = TrainConfig(),
    stages: Sequence[tuple] = ((16, 10), (32, 10), (64, 30)),
    clip_params=None,
    save_dir: Optional[str] = None,
    logger: Optional[MetricLogger] = None,
    metric_callback=None,
    **loop_kwargs,
):
    """Run the ladder of (resolution, epochs) stages; returns (final state,
    [(resolution, state), ...]) (progressive.py:70-109).

    The generator's tensors pass from each stage to the next. `loop_kwargs`
    go to `train_aurora_gan` (`device`, `distributed`, `backend`).
    """
    log = logger or MetricLogger()
    prev_g = None
    stage_states = []
    state = None
    for resolution, epochs in stages:
        scfg = stage_config(cfg, resolution, epochs)
        ds_r = resize_dataset(dataset, resolution)
        val_r = resize_dataset(val_dataset, resolution) if val_dataset is not None else None
        stage_dir = f"{save_dir}/stage_{resolution}" if save_dir else None
        log.log_line(f"=== progressive stage {resolution}x{resolution} ({epochs} epochs) ===")
        state = train_aurora_gan(ds_r, val_r, cfg=scfg, clip_params=clip_params,
                                 save_dir=stage_dir, logger=log,
                                 metric_callback=metric_callback, transfer_from=prev_g,
                                 **loop_kwargs)
        prev_g = state.generator.state_dict()
        stage_states.append((resolution, state))
    return state, stage_states
