"""The adversarial training step (counterpart of moegan_tpu/train/step.py:37-196),
default configuration, one device.

D phase: real logits and the R1 penalty from one double-backward, the fake
from a no-grad generator forward with its own router noise, the
shuffled-text logits, then the D update. G phase: a fresh generator forward
with other router noise, D's logits on it with the updated D, the
nonsaturating loss + the last block's CV balance + the annealed, clamped
router KL, then the G update. No CLIP loss: this is the JAX step's
`with_clip=False`.

The step runs where the state lives: the kernels on the card, their plain
versions on the CPU.
"""

from __future__ import annotations

import functools

import torch

from moegan_tpu_torch.config import TrainConfig
from moegan_tpu_torch.losses.gan import (
    discriminator_loss,
    expert_top1_per_block,
    expert_utilization_per_block,
    generator_loss,
    moe_balance_loss,
)
from moegan_tpu_torch.models.generator import AuroraGenerator
from moegan_tpu_torch.train.schedules import warmup_cosine
from moegan_tpu_torch.train.state import TrainState, clipped_adamw_update


def _check_supported(cfg: TrainConfig) -> None:
    lc = cfg.loss
    unsupported = [name for name, off_default in (
        (f"gan_loss={lc.gan_loss!r}", lc.gan_loss != "nonsaturating"),
        (f"balance_kind={lc.balance_kind!r}", lc.balance_kind != "cv"),
        ("balance_all_blocks=True", lc.balance_all_blocks),
        ("shared_fake=True", cfg.shared_fake),
        (f"gradient_accumulation_steps={cfg.gradient_accumulation_steps}",
         cfg.gradient_accumulation_steps != 1),
    ) if off_default]
    if unsupported:
        raise NotImplementedError(
            "the port's training step runs the default configuration only; not ported: "
            + ", ".join(unsupported))


def draw_noise(generator_module: AuroraGenerator, batch_size: int,
               generator: torch.Generator | None = None, device=None) -> dict:
    """The step's randomness: z [B, latent], the text shuffle perm [B], and
    the router noise of the D-phase and G-phase generator forwards,
    {"eps_d" | "eps_g": {resolution: (eps_f, eps_t, eps_c)}}, drawn in that
    order from `generator` (on `device`, default the generator's)."""
    cfg = generator_module.config
    dev = torch.device(device) if device is not None else (
        generator.device if generator is not None else torch.device("cpu"))

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    noise = {"z": randn(batch_size, cfg.latent_dim),
             "perm": torch.randperm(batch_size, generator=generator, device=dev)}
    for phase in ("eps_d", "eps_g"):
        noise[phase] = {}
        for r in cfg.resolutions():
            router = getattr(generator_module, f"gen_block_{r}").attn_block.moe.router
            noise[phase][r] = tuple(randn(*mu.shape) for mu in router.mean_weights())
    return noise


def make_train_step(cfg: TrainConfig, steps_per_epoch: int | None = None):
    """step(state, batch, schedule, noise=None, generator=None) -> (state, metrics).

    batch = {"image": [B, R, R, 3] in [-1, 1], "text": [B, 512]}; schedule =
    {"temperature_factor", "effective_kl_weight"} (numbers, per epoch on
    the host, `losses.gan`); noise as `draw_noise` gives it, or None to draw
    it from `generator`. The state is updated in place and returned; the
    metrics are detached scalars (and [blocks, E] routing statistics) on
    the state's device.
    """
    _check_supported(cfg)
    lcfg = cfg.loss
    lr_fn = functools.partial(
        warmup_cosine, lr=cfg.lr, num_epochs=cfg.num_epochs,
        steps_per_epoch=steps_per_epoch or cfg.steps_per_epoch or 1000,
        warmup_epochs=cfg.lr_warmup_epochs, min_fraction=cfg.lr_min_fraction)
    adamw = functools.partial(clipped_adamw_update, lr_fn=lr_fn, b1=cfg.beta1, b2=cfg.beta2,
                              weight_decay=cfg.weight_decay)

    def step(state: TrainState, batch, schedule, noise=None, generator=None):
        gen, disc = state.generator, state.discriminator
        dev = gen.constant.device
        real = batch["image"].to(dev, torch.float32)
        text = batch["text"].to(dev, torch.float32)
        temp = schedule["temperature_factor"]
        eff_kl_w = schedule["effective_kl_weight"]
        if noise is None:
            noise = draw_noise(gen, real.shape[0], generator)
        z, perm = noise["z"].to(dev), noise["perm"].to(dev)
        g_params, d_params = list(gen.parameters()), list(disc.parameters())

        # D phase: real logits and their input gradient in one graph (R1).
        real_in = real.detach().requires_grad_(True)
        real_pred = disc(real_in, text)
        (grad_real,) = torch.autograd.grad(real_pred.sum(), real_in, create_graph=True)
        r1 = (lcfg.r1_gamma / 2.0) * grad_real.float().square().sum(dim=(1, 2, 3)).mean()
        with torch.no_grad():
            fake = gen(z, text, training=True, annealing_factor=temp,
                       router_eps=noise["eps_d"]).image
        fake_pred = disc(fake, text)
        mism_pred = disc(real, text[perm])
        d_gan = discriminator_loss(real_pred, fake_pred, mism_pred)
        d_total = d_gan + r1
        adamw(d_params, torch.autograd.grad(d_total, d_params), state.d_opt,
              clip=cfg.grad_clip_d)

        # G phase, against the updated D.
        out = gen(z, text, training=True, annealing_factor=temp, router_eps=noise["eps_g"])
        kl = torch.clamp(out.kl, max=lcfg.kl_clamp)
        g_gan = generator_loss(disc(out.image, text))
        balance = moe_balance_loss(out.routing, lcfg.balance_weight)
        g_total = g_gan + balance + eff_kl_w * kl
        # norm2 and the cross-attention's q/k weights feed nothing (one text
        # token): their gradients are zero, as in the JAX package.
        g_grads = torch.autograd.grad(g_total, g_params, allow_unused=True, materialize_grads=True)
        adamw(g_params, g_grads, state.g_opt,
              clip=cfg.grad_clip_g)

        state.step += 1
        metrics = dict(d_loss=d_gan, r1_loss=r1, d_total=d_total, g_total=g_total, g_loss=g_gan,
                       kl_loss=kl, balance_loss=balance,
                       expert_util=expert_utilization_per_block(out.routing),
                       expert_top1=expert_top1_per_block(out.routing))
        return state, {k: v.detach() for k, v in metrics.items()}

    return step
