"""Losses of the training step (counterpart of moegan_tpu/losses/), with the
JAX package's seven exports."""

from moegan_tpu_torch.losses.clip_loss import clip_loss
from moegan_tpu_torch.losses.gan import (
    discriminator_loss,
    generator_loss,
    kl_annealing_factor,
    moe_balance_loss,
    r1_penalty,
    temperature_factor,
)

__all__ = [
    "generator_loss",
    "discriminator_loss",
    "r1_penalty",
    "moe_balance_loss",
    "kl_annealing_factor",
    "temperature_factor",
    "clip_loss",
]
