"""Adversarial losses, MoE balance loss and schedules (counterpart of
moegan_tpu/losses/gan.py), for the default configuration.

The nonsaturating GAN loss and the CV balance of the last block's routing
are ported; the hinge loss, the switch balance and the all-block balance
are not (`make_train_step` refuses them).

Under data parallelism (`mesh` given) the balance and the routing
statistics are taken over the global batch, as the JAX step takes them
over the whole sharded batch: the per-expert sums and the token count are
summed over the data group first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from moegan_tpu_torch.parallel.sharding import data_sum


def generator_loss(fake_pred: torch.Tensor) -> torch.Tensor:
    """Nonsaturating G loss: softplus(-D(fake)).mean()."""
    return F.softplus(-fake_pred).mean()


def discriminator_loss(real_pred, fake_pred, mismatched_pred) -> torch.Tensor:
    """Matching-aware nonsaturating D loss (real, fake, and real with shuffled text)."""
    return (F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()
            + F.softplus(mismatched_pred).mean())


def cv_balance(probs: torch.Tensor, mesh=None) -> torch.Tensor:
    """Coefficient-of-variation load balance of one block's routing [..., E]:
    unbiased std, times E, clamped to [0, 10], NaN -> 0 (gan.py:79-97)."""
    p = probs.float().reshape(-1, probs.shape[-1])
    eps = 1e-6
    n = p.shape[0] * (1 if mesh is None else mesh.data_size)
    fraction = (data_sum(p.sum(dim=0), mesh) + eps) / n
    cv = fraction.std(unbiased=True) / (fraction.mean() + eps)
    return torch.nan_to_num(torch.clamp(p.shape[-1] * cv, 0.0, 10.0), nan=0.0)


def moe_balance_loss(routing_probs, balance_weight: float = 0.01, mesh=None) -> torch.Tensor:
    """balance_weight * CV balance of the last block's routing."""
    return balance_weight * cv_balance(routing_probs[-1], mesh)


def kl_annealing_factor(epoch: float, kl_annealing_epochs: int) -> float:
    """Quadratic KL warm-up from 1e-5 to 1 (gan.py:150-154)."""
    warm = min(1.0, (epoch / kl_annealing_epochs) ** 2)
    return 1e-5 + (1.0 - 1e-5) * warm


def temperature_factor(epoch: float) -> float:
    """Router temperature annealing max(1, 3 - 0.1 * epoch) (gan.py:157-159)."""
    return max(1.0, 3.0 - 0.1 * epoch)


@torch.no_grad()
def _global_mean(rows, mesh) -> torch.Tensor:
    """[num_blocks, E] column means of per-block [N, E] rows over the global batch."""
    if mesh is None or mesh.data_size == 1:
        return torch.stack([r.mean(dim=0) for r in rows])
    sums = data_sum(torch.stack([r.sum(dim=0) for r in rows]), mesh)
    return sums / torch.tensor([float(r.shape[0] * mesh.data_size) for r in rows],
                               device=sums.device)[:, None]


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
