"""Plain float32 training step: the GAN losses with R1, the balance and KL
terms, and the clipped AdamW update, over the parameter dicts of
`perfbench.reference.model`.

One step, for the configuration's defaults (nonsaturating loss, the CV
balance of the last block, no shared fake, one mini-step an update):

  D phase: real logits and R1 = gamma/2 * mean ||dD/dx||^2 from one graph
  (the input gradient taken with create_graph); the fake from a no-grad
  generator forward under the D phase's router noise; the real images
  against the text shuffled by `perm`; D loss = softplus(-real) +
  softplus(fake) + softplus(mismatched), each a batch mean, plus R1; then
  the D update.
  G phase: a generator forward under the G phase's router noise, D's
  logits on it with the updated D; G loss = softplus(-fake) + the balance
  weight * the CV balance of the last block's routing + the annealed KL
  weight * min(summed router KL, kl_clamp); then the G update.

The update (optax's chain, written per parameter): clip the whole
gradient to the global norm `clip` when its norm is at least `clip`;
Adam moments with bias correction; update = -(lr * (m_hat / (sqrt(v_hat)
+ 1e-8) + weight_decay * p)), lr from the warm-up cosine schedule at the
update count before this update. Every gradient here is finite, so the
non-finite skip never acts and is not written out.

Departures from the program's arithmetic: float32 throughout; parameters
and moments per tensor, not over one flat buffer (the same sums in
another order).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import model
from perfbench.reference.precision import FP32, Precision


def warmup_cosine(count: int, lr: float, num_epochs: int, steps_per_epoch: int,
                  warmup_epochs: int, min_fraction: float) -> float:
    warmup = max(1, warmup_epochs * steps_per_epoch)
    total = max(warmup + 1, num_epochs * steps_per_epoch)
    if count < warmup:
        return 0.1 * lr + (lr - 0.1 * lr) * count / warmup
    c = min(count - warmup, total - warmup)
    return lr * ((1 - min_fraction) * 0.5 * (1 + math.cos(math.pi * c / (total - warmup)))
                 + min_fraction)


def cv_balance(probs):
    p = probs.reshape(-1, probs.shape[-1])
    fraction = (p.sum(dim=0) + 1e-6) / p.shape[0]
    cv = fraction.std(unbiased=True) / (fraction.mean() + 1e-6)
    return torch.nan_to_num(torch.clamp(p.shape[-1] * cv, 0.0, 10.0), nan=0.0)


class AdamW:
    """Per-parameter AdamW with the global-norm clip; `first_grad` keeps the
    clipped gradient of the first update, as the moments record it."""

    def __init__(self, params: dict, clip: float, tcfg: dict, steps_per_epoch: int):
        self.clip, self.t = clip, tcfg
        self.steps_per_epoch = steps_per_epoch
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0
        self.first_grad = None

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        t = self.t
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        lr = warmup_cosine(self.count, t["lr"], t["num_epochs"], self.steps_per_epoch,
                           t["lr_warmup_epochs"], t["lr_min_fraction"])
        b1, b2 = t["beta1"], t["beta2"]
        n = self.count + 1
        clipped = {k: g * scale for k, g in grads.items()}
        if self.first_grad is None:
            self.first_grad = {k: g.clone() for k, g in clipped.items()}
        for k, p in params.items():
            g = clipped[k]
            self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
            self.nu[k] = (1 - b2) * g * g + b2 * self.nu[k]
            m_hat = self.mu[k] / (1 - b1 ** n)
            v_hat = self.nu[k] / (1 - b2 ** n)
            p.add_(-lr * (m_hat / (torch.sqrt(v_hat) + 1e-8) + t["weight_decay"] * p))
        self.count = n


def _grads(loss, params: dict) -> dict:
    names = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
    return {k: (torch.zeros_like(params[k]) if g is None else g) for k, g in zip(names, gs)}


def train_step(G: dict, D: dict, g_opt: AdamW, d_opt: AdamW, cfg: dict, batch: dict,
               noise: dict, schedule: dict, pc: Precision = FP32, remat: bool = True) -> dict:
    """One step in place on the parameter dicts G and D (leaves that require
    grad). batch {"image" [B, R, R, 3], "text" [B, 512]}; noise {"z", "perm",
    "eps_d", "eps_g"} as the benchmark draws it; schedule {"temperature_factor",
    "effective_kl_weight"}; `remat` as in `model.generator`. Returns the step's
    losses as floats."""
    g, d, lcfg = cfg["generator"], cfg["discriminator"], cfg["loss"]
    real, text = batch["image"], batch["text"]
    z, mism_text = noise["z"], text[noise["perm"]]
    temp, kl_w = schedule["temperature_factor"], schedule["effective_kl_weight"]

    real_in = real.detach().requires_grad_(True)
    real_pred = model.discriminator(D, d, real_in, text, pc)
    (grad_real,) = torch.autograd.grad(real_pred.sum(), real_in, create_graph=True)
    r1 = (lcfg["r1_gamma"] / 2.0) * grad_real.square().sum(dim=(1, 2, 3)).mean()
    with torch.no_grad():
        fake = model.generator(G, g, z, text, training=True, annealing=temp,
                               router_eps=noise["eps_d"], pc=pc, remat=remat)[0]
    fake_pred = model.discriminator(D, d, fake, text, pc)
    mism_pred = model.discriminator(D, d, real, mism_text, pc)
    d_gan = (F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()
             + F.softplus(mism_pred).mean())
    d_total = d_gan + r1
    d_opt.update(D, _grads(d_total, D))

    image, _, kl, routing, _ = model.generator(G, g, z, text, training=True, annealing=temp,
                                            router_eps=noise["eps_g"], pc=pc, remat=remat)
    kl = torch.clamp(kl, max=lcfg["kl_clamp"])
    g_gan = F.softplus(-model.discriminator(D, d, image, text, pc)).mean()
    balance = lcfg["balance_weight"] * cv_balance(routing[-1])
    g_total = g_gan + balance + kl_w * kl
    g_opt.update(G, _grads(g_total, G))
    return {k: float(v.detach()) for k, v in (("d_total", d_total), ("g_total", g_total),
                                               ("d_loss", d_gan), ("r1_loss", r1),
                                               ("g_loss", g_gan))}
