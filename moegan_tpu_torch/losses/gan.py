"""Adversarial losses, MoE balance losses and schedules (counterpart of
moegan_tpu/losses/gan.py).

The GAN losses are the nonsaturating (the default) and the hinge loss; the
balance is the CV balance or the switch (hard-dispatch) balance, of the
last block's routing or averaged over every block.

Under data parallelism (`mesh` given) the balances and the routing
statistics are taken over the global batch, as the JAX step takes them
over the whole sharded batch: the per-expert sums and the token count are
summed over the data group first. Per-rank losses are never averaged: the
CV of a mean and the switch balance's product f·P do not commute with an
average over ranks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from moegan_tpu_torch.parallel.sharding import data_sum


def generator_loss(fake_pred: torch.Tensor, kind: str = "nonsaturating") -> torch.Tensor:
    """G loss (gan.py:14-22): "hinge" -D(fake).mean(); any other kind the
    nonsaturating softplus(-D(fake)).mean()."""
    if kind == "hinge":
        return -fake_pred.mean()
    return F.softplus(-fake_pred).mean()


def discriminator_loss(real_pred, fake_pred, mismatched_pred,
                       kind: str = "nonsaturating") -> torch.Tensor:
    """Matching-aware D loss over real, fake, and real with shuffled text
    (gan.py:25-43): hinge margins relu(1 - real) + relu(1 + fake) + relu(1 +
    mismatched) for "hinge", else the nonsaturating softplus terms."""
    if kind == "hinge":
        return (F.relu(1.0 - real_pred).mean() + F.relu(1.0 + fake_pred).mean()
                + F.relu(1.0 + mismatched_pred).mean())
    return (F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()
            + F.softplus(mismatched_pred).mean())


def r1_from_input_grad(grad_real: torch.Tensor, r1_gamma: float) -> torch.Tensor:
    """(gamma / 2) * mean over the batch of ||dD/dx||^2, from dD/dx [B, H, W, C]."""
    return (r1_gamma / 2.0) * grad_real.float().square().sum(dim=(1, 2, 3)).mean()


def r1_penalty(d_apply, real_images: torch.Tensor, r1_gamma: float) -> torch.Tensor:
    """R1 gradient penalty (gan.py:46-57): (gamma / 2) * E[||dD(x)/dx||^2] at the
    real images, `d_apply` mapping images to logits [B]. The input gradient is
    taken with create_graph, so the penalty differentiates into D's parameters."""
    x = real_images.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(d_apply(x).sum(), x, create_graph=True)
    return r1_from_input_grad(grad, r1_gamma)


def cv_balance(probs: torch.Tensor, mesh=None) -> torch.Tensor:
    """Coefficient-of-variation load balance of one block's routing [..., E]:
    unbiased std, times E, clamped to [0, 10], NaN -> 0 (gan.py:59-76)."""
    p = probs.float().reshape(-1, probs.shape[-1])
    eps = 1e-6
    n = p.shape[0] * (1 if mesh is None else mesh.data_size)
    fraction = (data_sum(p.sum(dim=0), mesh) + eps) / n
    cv = fraction.std(unbiased=True) / (fraction.mean() + eps)
    return torch.nan_to_num(torch.clamp(p.shape[-1] * cv, 0.0, 10.0), nan=0.0)


def switch_balance(probs: torch.Tensor, mesh=None) -> torch.Tensor:
    """Switch-Transformer load loss E * sum_i f_i * P_i of one block's routing
    [..., E] (gan.py:79-95): f the share of tokens whose top-1 expert is i
    (no gradient), P the mean soft probability of expert i. 1 at a uniform
    assignment."""
    p = probs.float().reshape(-1, probs.shape[-1])
    E = p.shape[-1]
    n = p.shape[0] * (1 if mesh is None else mesh.data_size)
    with torch.no_grad():
        f = data_sum(F.one_hot(p.argmax(dim=-1), E).float().sum(dim=0), mesh) / n
    mean_p = data_sum(p.sum(dim=0), mesh) / n
    return E * (f * mean_p).sum()


def moe_balance_loss(routing_probs, balance_weight: float = 0.01, all_blocks: bool = False,
                     kind: str = "cv", mesh=None) -> torch.Tensor:
    """balance_weight * the balance of the last block's routing, or its mean
    over every block with `all_blocks` (gan.py:98-121); the switch balance for
    kind "switch", else the CV balance. 0 without routing."""
    if not routing_probs:
        return torch.zeros(())
    term = switch_balance if kind == "switch" else cv_balance
    if all_blocks:
        balance = torch.stack([term(p, mesh) for p in routing_probs]).mean()
    else:
        balance = term(routing_probs[-1], mesh)
    return balance_weight * balance


def kl_annealing_factor(epoch: float, kl_annealing_epochs: int) -> float:
    """Quadratic KL warm-up from 1e-5 to 1 (gan.py:124-128)."""
    warm = min(1.0, (epoch / kl_annealing_epochs) ** 2)
    return 1e-5 + (1.0 - 1e-5) * warm


def temperature_factor(epoch: float) -> float:
    """Router temperature annealing max(1, 3 - 0.1 * epoch) (gan.py:131-133)."""
    return max(1.0, 3.0 - 0.1 * epoch)


@torch.no_grad()
def _global_mean(rows, mesh) -> torch.Tensor:
    """[num_blocks, E] column means of per-block [N, E] rows over the global batch."""
    if mesh is None or mesh.data_size == 1:
        return torch.stack([r.mean(dim=0) for r in rows])
    sums = data_sum(torch.stack([r.sum(dim=0) for r in rows]), mesh)
    return sums / torch.tensor([float(r.shape[0] * mesh.data_size) for r in rows],
                               device=sums.device)[:, None]


def expert_utilization(routing_probs) -> torch.Tensor:
    """[E] mean routing probability of each expert in the last block (gan.py:136-140)."""
    last = routing_probs[-1].float()
    return last.reshape(-1, last.shape[-1]).mean(dim=0)


def expert_utilization_per_block(routing_probs, mesh=None) -> torch.Tensor:
    """[num_blocks, E] mean routing probability of each expert, per block."""
    return _global_mean([p.float().reshape(-1, p.shape[-1]) for p in routing_probs], mesh)


def expert_top1_per_block(routing_probs, mesh=None) -> torch.Tensor:
    """[num_blocks, E] share of tokens whose top-1 expert is each expert, per block."""
    rows = []
    for p in routing_probs:
        p2 = p.float().reshape(-1, p.shape[-1])
        rows.append(F.one_hot(p2.argmax(dim=-1), p2.shape[-1]).float())
    return _global_mean(rows, mesh)
