"""The adversarial training step and the validation step (counterpart of
moegan_tpu/train/step.py), every `TrainConfig` the JAX step trains.

D phase: real logits and the R1 penalty from one double-backward, the fake
from a no-grad generator forward with its own router noise, the
shuffled-text logits, then the D update. G phase: a fresh generator forward
with other router noise, D's logits on it with the updated D, the GAN loss
(`cfg.loss.gan_loss`, nonsaturating or hinge) + the weighted multi-level
CLIP loss (when the step is given a tower pack, `clip_params`) + the
balance (`balance_kind` cv or switch, of the last block or averaged over
every block with `balance_all_blocks`) + the annealed, clamped router KL,
then the G update.

With `shared_fake` (JAX step.py:74-90, :169-180) the step runs one
differentiable generator forward, under the G phase's router noise: D
trains on its image detached, and the G loss is taken on the same output
against the updated D, its backward through the graph kept from before the
D update. The noise of both phases is still drawn (`draw_noise`), so the
seeded stream does not depend on the flag. With
`gradient_accumulation_steps` k > 1 each call is one mini-step: the
optimizers accumulate and apply an update every k-th call
(`train.state.clipped_adamw_update`).

The step runs where the state lives: the kernels on the card, their plain
versions on the CPU.

Under a mesh (`state.mesh`, from `parallel.api.setup_distributed_training`)
the step keeps the single-device semantics that GSPMD gives the JAX step:
every rank takes the global batch (or its slice, `parallel.sharding.
shard_batch`) and draws the noise for the global batch from the same seeded
generator, then keeps its data slice, so z and the router noise are the
single-device step's and the shuffled text pairs across data shards as on
one device. The forwards run under the mesh (the sharded MoE path when its
expert axis is larger than 1); after each backward the gradients are
averaged over the data group, the balance and routing statistics are
taken over the global batch, and the scalar metrics are averaged over the
data group.

Spans (`utils.profiling`, recorded under a profiler session): `moegan.step`
around the call; `.d_phase` from the real input to D's gradients, holding
`.r1` (the create-graph input gradient) and `.d_backward`; `.d_adamw`;
`.g_phase`, the G forward, D on the fake, the losses and `.g_backward`;
`.g_adamw`; `.metrics`. With `shared_fake` the one generator forward runs
before `.d_phase`, in the root's own time.
"""

from __future__ import annotations

import functools

import torch

from moegan_tpu_torch.config import TrainConfig
from moegan_tpu_torch.losses.clip_loss import multi_level_clip_loss
from moegan_tpu_torch.losses.gan import (
    discriminator_loss,
    expert_top1_per_block,
    expert_utilization_per_block,
    generator_loss,
    moe_balance_loss,
    r1_from_input_grad,
)
from moegan_tpu_torch.models.generator import AuroraGenerator
from moegan_tpu_torch.parallel.mesh import maybe_mesh_context
from moegan_tpu_torch.parallel.sharding import (
    batch_sharding,
    data_mean,
    gather_batch,
    shard_batch,
)
from moegan_tpu_torch.train.schedules import warmup_cosine
from moegan_tpu_torch.train.state import TrainState, clipped_adamw_update, sharded_mask
from moegan_tpu_torch.utils.profiling import span

# The step's spans (`utils.profiling`): the root, then its phases in order.
SPAN = {"step": "moegan.step",
        **{k: f"moegan.step.{k}" for k in ("d_phase", "r1", "d_backward", "d_adamw", "g_phase",
                                             "g_backward", "g_adamw", "metrics")}}


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


def _local_inputs(state: TrainState, batch):
    """(real, text, local slice function, global batch size) of this rank."""
    dev = state.generator.constant.device
    mesh = state.mesh
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    real = batch["image"].to(dev, torch.float32)
    text = batch["text"].to(dev, torch.float32)
    data_size = 1 if mesh is None else mesh.data_size
    return real, text, batch_sharding(mesh), real.shape[0] * data_size


def _mean_metrics(metrics: dict, mesh) -> dict:
    """Detached metrics; the scalars averaged over the data group."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    names = [k for k, v in metrics.items() if v.dim() == 0]
    for k, v in zip(names, data_mean([metrics[k] for k in names], mesh)):
        metrics[k] = v
    return metrics


def make_train_step(cfg: TrainConfig, steps_per_epoch: int | None = None):
    """step(state, batch, schedule, noise=None, generator=None, clip_params=None)
    -> (state, metrics).

    batch = {"image": [B, R, R, 3] in [-1, 1], "text": [B, 512]}, the
    global batch (under a mesh also this rank's `ShardedBatch`); schedule =
    {"temperature_factor", "effective_kl_weight"} (numbers, per epoch on
    the host, `losses.gan`); noise as `draw_noise` gives it for the global
    batch, or None to draw it from `generator`. The state is updated in
    place and returned; the metrics are detached scalars (and [blocks, E]
    routing statistics) on the state's device. With a tower pack
    `clip_params` (`models.clip.CLIP` or {"toy": ...}), the G loss adds
    cfg.loss.clip_weights[r] * clip_loss_r for every RGB tap r of positive
    weight (moegan_tpu/train/step.py:135-150), each reported as `clip_loss_{r}`.
    """
    lcfg = cfg.loss
    lr_fn = functools.partial(
        warmup_cosine, lr=cfg.lr, num_epochs=cfg.num_epochs,
        steps_per_epoch=steps_per_epoch or cfg.steps_per_epoch or 1000,
        warmup_epochs=cfg.lr_warmup_epochs, min_fraction=cfg.lr_min_fraction)
    adamw = functools.partial(clipped_adamw_update, lr_fn=lr_fn, b1=cfg.beta1, b2=cfg.beta2,
                              weight_decay=cfg.weight_decay,
                              every_k=cfg.gradient_accumulation_steps)
    shared = cfg.shared_fake

    def step(state: TrainState, batch, schedule, noise=None, generator=None, clip_params=None):
        with span(SPAN["step"]):
            return _step(state, batch, schedule, noise, generator, clip_params)

    def _step(state, batch, schedule, noise, generator, clip_params):
        gen, disc, mesh = state.generator, state.discriminator, state.mesh
        dev = gen.constant.device
        real, text, local, B = _local_inputs(state, batch)
        temp = schedule["temperature_factor"]
        eff_kl_w = schedule["effective_kl_weight"]
        if noise is None:
            noise = draw_noise(gen, B, generator)
        z, perm = local(noise["z"].to(dev)), noise["perm"].to(dev)
        mism_text = local(gather_batch(text, mesh)[perm])
        g_params, d_params = list(gen.parameters()), list(disc.parameters())
        g_mask, d_mask = sharded_mask(gen, mesh), sharded_mask(disc, mesh)

        def g_forward():
            return gen(z, text, training=True, annealing_factor=temp, router_eps=noise["eps_g"])

        with maybe_mesh_context(mesh):
            # One differentiable generator forward, shared by both phases.
            out = g_forward() if shared else None
            with span(SPAN["d_phase"]):
                # D phase: real logits and their input gradient in one graph (R1).
                real_in = real.detach().requires_grad_(True)
                real_pred = disc(real_in, text)
                with span(SPAN["r1"]):
                    (grad_real,) = torch.autograd.grad(real_pred.sum(), real_in,
                                                       create_graph=True)
                r1 = r1_from_input_grad(grad_real, lcfg.r1_gamma)
                if shared:
                    fake = out.image.detach()
                else:
                    with torch.no_grad():
                        fake = gen(z, text, training=True, annealing_factor=temp,
                                   router_eps=noise["eps_d"]).image
                fake_pred = disc(fake, text)
                mism_pred = disc(real, mism_text)
                d_gan = discriminator_loss(real_pred, fake_pred, mism_pred, lcfg.gan_loss)
                d_total = d_gan + r1
                with span(SPAN["d_backward"]):
                    d_grads = data_mean(torch.autograd.grad(d_total, d_params), mesh)
            with span(SPAN["d_adamw"]):
                adamw(d_params, d_grads, state.d_opt, clip=cfg.grad_clip_d, mesh=mesh,
                      sharded=d_mask)

            # G phase, against the updated D.
            with span(SPAN["g_phase"]):
                if not shared:
                    out = g_forward()
                kl = torch.clamp(out.kl, max=lcfg.kl_clamp)
                g_gan = generator_loss(disc(out.image, text), lcfg.gan_loss)
                clip_metrics = {}
                g_clip = torch.zeros((), device=dev)
                if clip_params is not None:
                    taps = {r: out.intermediates[r] for r, w in lcfg.clip_weights.items()
                            if r in out.intermediates and w > 0}
                    for r, cl in multi_level_clip_loss(
                            clip_params, taps, text,
                            stop_gradient=lcfg.clip_stop_gradient).items():
                        clip_metrics[f"clip_loss_{r}"] = cl
                        g_clip = g_clip + lcfg.clip_weights[r] * cl
                balance = moe_balance_loss(out.routing, lcfg.balance_weight,
                                           all_blocks=lcfg.balance_all_blocks,
                                           kind=lcfg.balance_kind, mesh=mesh)
                g_total = g_gan + g_clip + balance + eff_kl_w * kl
                # norm2 and the cross-attention's q/k weights feed nothing (one text
                # token): their gradients are zero, as in the JAX package.
                with span(SPAN["g_backward"]):
                    g_grads = data_mean(torch.autograd.grad(
                        g_total, g_params, allow_unused=True, materialize_grads=True), mesh)
            with span(SPAN["g_adamw"]):
                adamw(g_params, g_grads, state.g_opt, clip=cfg.grad_clip_g, mesh=mesh,
                      sharded=g_mask)

        with span(SPAN["metrics"]):
            state.step += 1
            metrics = dict(d_loss=d_gan, r1_loss=r1, d_total=d_total, g_total=g_total,
                           g_loss=g_gan, kl_loss=kl, balance_loss=balance,
                           expert_util=expert_utilization_per_block(out.routing, mesh),
                           expert_top1=expert_top1_per_block(out.routing, mesh),
                           **clip_metrics)
            return state, _mean_metrics(metrics, mesh)

    return step


def make_eval_step(cfg: TrainConfig):
    """eval_fn(state, batch, schedule, generator=None, noise=None, clip_params=None)
    -> {"val_d_loss", "val_g_loss"} (moegan_tpu/train/step.py:199-249).

    G at eval (mean router weights, hard routing: under an expert axis the
    combine kernel takes one-hot probs), D on the real images, the fake and
    the real images against shuffled text; no update. The noise, {"z": [B,
    latent], "perm": [B]} for the global batch, is given or drawn (z, then
    the shuffle) from `generator`, the caller's stream apart from the
    training steps'. Under a mesh the batch is as in the training step and
    the losses are averaged over the data group. With a tower pack
    `clip_params`, `val_clip_loss_{r}` for every RGB tap r that cfg.loss.clip_weights
    names, and `val_clip_loss`, the top resolution's (the HPO objective).
    The GAN losses are `cfg.loss.gan_loss`'s.
    """
    lcfg = cfg.loss

    @torch.no_grad()
    def eval_fn(state: TrainState, batch, schedule, generator=None, noise=None,
                clip_params=None):
        gen, disc, mesh = state.generator, state.discriminator, state.mesh
        dev = gen.constant.device
        real, text, local, B = _local_inputs(state, batch)
        if noise is None:
            gdev = generator.device if generator is not None else torch.device("cpu")
            noise = {"z": torch.randn((B, cfg.generator.latent_dim), generator=generator,
                                      device=gdev),
                     "perm": torch.randperm(B, generator=generator, device=gdev)}
        z, perm = local(noise["z"].to(dev)), noise["perm"].to(dev)
        mism_text = local(gather_batch(text, mesh)[perm])
        with maybe_mesh_context(mesh):
            out = gen(z, text, training=False, annealing_factor=schedule["temperature_factor"])
            real_pred = disc(real, text)
            fake_pred = disc(out.image, text)
            mism_pred = disc(real, mism_text)
        metrics = {
            "val_d_loss": discriminator_loss(real_pred, fake_pred, mism_pred, lcfg.gan_loss),
            # step.py:241-243: the val G loss includes the annealed, clamped KL.
            "val_g_loss": generator_loss(fake_pred, lcfg.gan_loss)
            + schedule["effective_kl_weight"]
            * torch.clamp(out.kl, max=lcfg.kl_clamp),
        }
        if clip_params is not None:
            taps = {r: x for r, x in out.intermediates.items() if r in lcfg.clip_weights}
            for r, cl in multi_level_clip_loss(clip_params, taps, text).items():
                metrics[f"val_clip_loss_{r}"] = cl
            top = f"val_clip_loss_{max(out.intermediates)}"
            if top in metrics:
                metrics["val_clip_loss"] = metrics[top]
        return _mean_metrics(metrics, mesh)

    return eval_fn
