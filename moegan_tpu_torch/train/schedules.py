"""Learning-rate schedule (counterpart of moegan_tpu/train/schedules.py)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(count, lr: float, num_epochs: int, steps_per_epoch: int, warmup_epochs: int,
                  min_fraction: float = 0.05):
    """The learning rate at update `count` (a number or a tensor): linear from
    0.1 lr to lr over the warm-up, then a cosine to min_fraction * lr, as
    optax.join_schedules([linear_schedule, cosine_decay_schedule]) gives it
    (moegan_tpu/train/schedules.py)."""
    warmup = max(1, warmup_epochs * steps_per_epoch)
    total = max(warmup + 1, num_epochs * steps_per_epoch)
    decay = total - warmup
    count = torch.as_tensor(count, dtype=torch.float32)
    frac = 1.0 - torch.clamp(count, 0, warmup) / warmup
    linear = (0.1 * lr - lr) * frac + lr
    c = torch.clamp(count - warmup, max=decay)
    cosine = lr * ((1 - min_fraction) * 0.5 * (1 + torch.cos(math.pi * c / decay)) + min_fraction)
    return torch.where(count < warmup, linear, cosine)
