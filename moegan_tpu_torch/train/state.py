"""Training state and the optimizer (counterpart of moegan_tpu/train/state.py).

`TrainState` holds the generator, the discriminator and one `AdamWState`
for each. The optimizer is the JAX package's optax chain, written out over
flat float32 buffers so that it matches optax step for step:

    skip_if_nonfinite(chain(clip_by_global_norm(clip),
                            adamw(schedule, b1, b2, eps=1e-8, weight_decay)))

- clip_by_global_norm scales the gradients by clip / norm when
  norm >= clip (not `torch.nn.utils.clip_grad_norm_`, which adds 1e-6);
- adamw takes the learning rate of the update count before this update,
  bias-corrects both moments, and adds weight_decay * p to the Adam
  direction before scaling by -lr;
- skip_if_nonfinite (state.py:40-81): when any incoming gradient is not
  finite, the parameters, moments and count stay as they were and
  `notfinite_count` rises by one; after `max_consecutive_errors` such
  updates in a row the update passes through. The choice is a select on
  the device, so the step never waits on the host.

With `gradient_accumulation_steps` k > 1 the chain inside the skip is
`optax.MultiSteps(chain(...), k)` (state.py:84-100): each call folds the
raw gradient into the running mean `acc += (g - acc) / (mini_step + 1)`;
the k-th call clips and applies AdamW to that mean and resets `acc`, every
other call leaves the parameters, moments and count as they are. AdamW's
count, which drives the learning-rate schedule, so counts emitted updates,
not calls. The skip wraps the accumulator: a non-finite call leaves `acc`
and `mini_step` too as they were.

Parameters are updated in place (the JAX step returns new arrays).

Under a mesh (`parallel.mesh`) every rank builds the full G and D from
the same seed and keeps its slice of the expert-sharded MoE weights
(`parallel.sharding.shard_module_`), so a sharded state is exactly the
shards of the single-device state, and AdamW's flat buffers hold the local
parameters. The update must still see the global gradient: the squared
norm of the expert-sharded part is summed over the expert group before
the clip, and the non-finite flag over the whole world, so that all ranks
skip or apply an update together.

For checkpoints, `state_payload` turns the state into whole (unsharded)
tensors by parameter name, AdamW's moments per parameter instead of flat
buffers (and the accumulator, when there is one), and
`load_state_payload` turns such a payload back into this rank's state
under any layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from moegan_tpu_torch import resolve_device
from moegan_tpu_torch.config import TrainConfig
from moegan_tpu_torch.models.discriminator import AuroraDiscriminator
from moegan_tpu_torch.models.generator import AuroraGenerator
from moegan_tpu_torch.parallel.mesh import Mesh
from moegan_tpu_torch.parallel.sharding import (
    expert_slice,
    gather_full,
    param_sharding_rules,
    shard_module_,
)

MAX_CONSECUTIVE_ERRORS = 100


@dataclass
class AdamWState:
    count: torch.Tensor  # int32 scalar: updates applied
    mu: torch.Tensor  # flat fp32 first moment
    nu: torch.Tensor  # flat fp32 second moment
    notfinite_count: torch.Tensor  # int32 scalar: non-finite updates in a row
    # Under gradient accumulation (MultiSteps): the flat fp32 running mean of
    # this round's gradients and the int32 count of calls folded into it.
    acc: torch.Tensor | None = None
    mini_step: torch.Tensor | None = None


def init_adamw(params, every_k: int = 1) -> AdamWState:
    """A fresh optimizer state; with `every_k` > 1, with an accumulator."""
    params = list(params)
    dev = params[0].device
    n = sum(p.numel() for p in params)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    state = AdamWState(zero, torch.zeros(n, device=dev), torch.zeros(n, device=dev), zero.clone())
    if every_k > 1:
        state.acc, state.mini_step = torch.zeros(n, device=dev), zero.clone()
    return state


def _global_norm_and_finite(g: torch.Tensor, sizes, sharded, finite, mesh: Mesh):
    """The norm of the whole (unsharded) gradient and the world's finite flag.

    The replicated part's squared norm is computed from the replicated
    gradients alone, the same bits on every rank, so that the replicated
    parameters stay identical across the expert group; the expert-sharded
    part's is summed over the group.
    """
    parts = g.split(sizes)
    rep = [x for x, s in zip(parts, sharded) if not s]
    exp = [x for x, s in zip(parts, sharded) if s]
    sq_rep = torch.sum(torch.cat(rep) ** 2) if rep else g.new_zeros(())
    sq_exp = torch.sum(torch.cat(exp) ** 2) if exp else g.new_zeros(())
    if mesh.expert_group is not None and exp:
        dist.all_reduce(sq_exp, group=mesh.expert_group)
    notfinite = (~finite).float()
    if mesh.world_size > 1:
        dist.all_reduce(notfinite)
    return torch.sqrt(sq_rep + sq_exp), notfinite == 0


@torch.no_grad()
def clipped_adamw_update(params, grads, state: AdamWState, lr_fn, clip: float, b1: float,
                         b2: float, weight_decay: float, eps: float = 1e-8,
                         max_consecutive_errors: int = MAX_CONSECUTIVE_ERRORS,
                         mesh: Mesh | None = None, sharded=None, every_k: int = 1) -> None:
    """One optimizer call on `params` (a list of tensors) from `grads`, in place.

    With `every_k` > 1 the call accumulates and only every k-th applies an
    update (the state must come from `init_adamw(params, every_k)`). Under
    `mesh`, `sharded[i]` says whether params[i] is this rank's slice of an
    expert-sharded parameter; the grads are the data-group averages.
    """
    params = list(params)
    g = torch.cat([x.reshape(-1).float() for x in grads])
    p = torch.cat([x.reshape(-1).float() for x in params])
    finite = torch.isfinite(g).all()  # of the incoming gradient: the skip wraps MultiSteps
    if every_k > 1:
        acc = state.acc + (g - state.acc) / (state.mini_step + 1)
        emit = state.mini_step == every_k - 1
        g = acc
    if mesh is None:
        norm = torch.sqrt(torch.sum(g * g))
    else:
        norm, finite = _global_norm_and_finite(g, [x.numel() for x in params], sharded, finite,
                                               mesh)
    g = torch.where(norm < clip, g, g / norm * clip)
    count_inc = state.count + 1
    mu = (1 - b1) * g + b1 * state.mu
    nu = (1 - b2) * (g * g) + b2 * state.nu
    mu_hat = mu / (1 - b1 ** count_inc.float())
    nu_hat = nu / (1 - b2 ** count_inc.float())
    update = (mu_hat / (torch.sqrt(nu_hat) + eps) + weight_decay * p) * -lr_fn(state.count)
    use_new = finite | (state.notfinite_count >= max_consecutive_errors)
    if every_k > 1:
        # MultiSteps: the update is emit * update, its state the inner one on emit.
        update = emit * update
        state.acc = torch.where(use_new, (~emit) * acc, state.acc)
        state.mini_step = torch.where(use_new, (state.mini_step + 1) % every_k, state.mini_step)
        use_inner = use_new & emit
    else:
        use_inner = use_new
    p = p + torch.where(use_new, update, torch.zeros_like(update))
    state.mu = torch.where(use_inner, mu, state.mu)
    state.nu = torch.where(use_inner, nu, state.nu)
    state.count = torch.where(use_inner, count_inc, state.count)
    state.notfinite_count = torch.where(finite, torch.zeros_like(state.notfinite_count),
                                        state.notfinite_count + 1)
    torch._foreach_copy_(params, [v.view_as(x) for v, x in
                                  zip(p.split([x.numel() for x in params]), params)])


@dataclass
class TrainState:
    step: int
    generator: AuroraGenerator
    discriminator: AuroraDiscriminator
    g_opt: AdamWState
    d_opt: AdamWState
    mesh: Mesh | None = None


def sharded_mask(module: torch.nn.Module, mesh: Mesh | None) -> list[bool]:
    """Per parameter of `module`, whether the mesh splits it over its expert axis."""
    if mesh is None or mesh.expert_size == 1:
        return [False] * len(list(module.parameters()))
    return [param_sharding_rules(n, mesh.expert_axis) is not None
            for n, _ in module.named_parameters()]


def count_params(module: torch.nn.Module, mesh: Mesh | None = None) -> int:
    """Parameters of the whole (unsharded) module (JAX state.py:179); under a
    mesh, each expert-sharded tensor counts for the whole expert group."""
    scale = 1 if mesh is None else mesh.expert_size
    return sum(p.numel() * (scale if s else 1)
               for p, s in zip(module.parameters(), sharded_mask(module, mesh)))


def create_train_state(cfg: TrainConfig, device="cuda", seed: int | None = None,
                       mesh: Mesh | None = None) -> TrainState:
    """G and D from the port's seeded initialisers (`seed`, default cfg.seed) on
    `device`, with fresh optimizer states; under `mesh`, this rank's shards.
    Raises without a card unless device="cpu"."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    g = AuroraGenerator(cfg.generator, gen=gen)
    d = AuroraDiscriminator(cfg.discriminator, gen=gen)
    if mesh is not None:
        shard_module_(g, mesh)
    g, d = g.to(dev), d.to(dev)
    k = cfg.gradient_accumulation_steps
    return TrainState(0, g, d, init_adamw(g.parameters(), k), init_adamw(d.parameters(), k), mesh)


def _per_parameter(flat: torch.Tensor, module: torch.nn.Module) -> dict:
    """{name: view of `flat` shaped as the parameter}, in `module.parameters()` order."""
    named = list(module.named_parameters())
    return {n: v.view_as(p) for v, (n, p) in zip(flat.split([p.numel() for _, p in named]),
                                                 named)}


def _nets(state: TrainState):
    return (("generator", "optimizer_g", state.generator, state.g_opt),
            ("discriminator", "optimizer_d", state.discriminator, state.d_opt))


def state_payload(state: TrainState, epoch: int) -> dict:
    """The whole training state on the CPU: {"step", "epoch", "generator" and
    "discriminator": {name: tensor}, "optimizer_g" and "optimizer_d": {"count",
    "notfinite_count", "mu" and "nu": {name: tensor}}}; under gradient
    accumulation each optimizer also holds "mini_step" and "acc": {name:
    tensor}. Under a mesh the expert-sharded tensors are gathered, so every
    rank must call it."""

    def whole(named: dict) -> dict:
        if state.mesh is not None:
            named = gather_full(named, state.mesh)
        return {k: v.detach().to("cpu", copy=True) for k, v in named.items()}

    out = {"step": int(state.step), "epoch": int(epoch)}
    for key, opt_key, module, opt in _nets(state):
        out[key] = whole(dict(module.named_parameters()))
        out[opt_key] = {"count": int(opt.count), "notfinite_count": int(opt.notfinite_count),
                        "mu": whole(_per_parameter(opt.mu, module)),
                        "nu": whole(_per_parameter(opt.nu, module))}
        if opt.acc is not None:
            out[opt_key]["mini_step"] = int(opt.mini_step)
            out[opt_key]["acc"] = whole(_per_parameter(opt.acc, module))
    return out


@torch.no_grad()
def load_state_payload(state: TrainState, payload: dict) -> TrainState:
    """Load a `state_payload` into `state` in place, each rank keeping its slice
    of the expert-sharded tensors. An accumulating state loaded from a payload
    without an accumulator starts its round afresh."""
    mesh = state.mesh

    def local(name: str, full: torch.Tensor) -> torch.Tensor:
        if (mesh is not None and mesh.expert_size > 1
                and param_sharding_rules(name, mesh.expert_axis) is not None):
            return full[expert_slice(mesh, full.shape[0])]
        return full

    for key, opt_key, module, opt in _nets(state):
        params = dict(module.named_parameters())
        saved = payload[key]
        if set(saved) != set(params):
            raise ValueError(f"{key}: the checkpoint's parameters differ from the model's: "
                             f"missing {sorted(set(params) - set(saved))}, unexpected "
                             f"{sorted(set(saved) - set(params))}")
        for name, p in params.items():
            p.copy_(local(name, saved[name]))
        dev = next(iter(params.values())).device
        moments = payload[opt_key]

        def flat(m):
            return torch.cat([local(n, moments[m][n]).reshape(-1) for n in params]).to(
                dev, torch.float32)

        def scalar(m):
            return torch.tensor(moments[m], dtype=torch.int32, device=dev)

        opt.mu, opt.nu = flat("mu"), flat("nu")
        opt.count, opt.notfinite_count = scalar("count"), scalar("notfinite_count")
        if opt.acc is not None:
            if "acc" in moments:
                opt.acc, opt.mini_step = flat("acc"), scalar("mini_step")
            else:
                opt.acc, opt.mini_step = torch.zeros_like(opt.acc), torch.zeros_like(opt.count)
    state.step = int(payload["step"])
    return state
