"""Bayesian variational router (counterpart of moegan_tpu/core/router.py).

The parameters are the JAX package's: feature/text/combined mu and rho and
the temperature. Serving uses the posterior means and hard top-1 routing.
`forward` is the whole JAX router (the expert-parallel MoE path routes
through it); the fused kernels take the weights from `sample_weights` and
compute the routing themselves.
Training samples the three weight matrices by reparameterisation,
mu + softplus(rho) * eps under the JAX package's clamps, with eps passed in
or drawn from an explicit `torch.Generator`, and regularises the posterior
with the closed-form KL to N(0, 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from moegan_tpu_torch.core import inits


def reparameterize(mu: torch.Tensor, rho: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """mu + softplus(rho) * eps with the reference clamps (router.py:33-39)."""
    mu = torch.clamp(mu, -10.0, 10.0)
    rho = torch.clamp(rho, -8.0, 4.0)
    sigma = torch.clamp(torch.log1p(torch.exp(rho)), 1e-6, 10.0)
    return mu + sigma * torch.clamp(eps, -2.0, 2.0)


def gaussian_kl(mu: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, softplus(rho)^2) || N(0, 1)) in log-variance form (router.py:42-47)."""
    sigma = torch.log1p(torch.exp(rho.float()))
    log_var = 2.0 * torch.log(sigma)
    return 0.5 * torch.sum(torch.exp(log_var) + torch.square(mu.float()) - 1.0 - log_var)


class BayesianRouter(nn.Module):
    def __init__(self, feature_dim: int, text_dim: int, num_experts: int = 4,
                 hidden: int = 128, gen: torch.Generator | None = None):
        super().__init__()
        gen = inits.default_generator(gen)
        h, e = hidden, num_experts
        self.hidden, self.num_experts = h, e
        self.feature_mu = nn.Parameter(inits.normal((feature_dim, h), gen, 0.01))
        self.feature_rho = nn.Parameter(torch.full((feature_dim, h), -4.0))
        self.text_mu = nn.Parameter(inits.normal((text_dim, h), gen, 0.01))
        self.text_rho = nn.Parameter(torch.full((text_dim, h), -4.0))
        self.combined_mu = nn.Parameter(inits.normal((2 * h, e), gen, 0.01))
        self.combined_rho = nn.Parameter(torch.full((2 * h, e), -4.0))
        self.temperature = nn.Parameter(torch.full((1,), 4.0))

    def mean_weights(self):
        """(fw, tw, cw): the posterior means, the eval-time router weights."""
        return self.feature_mu, self.text_mu, self.combined_mu

    def sample_weights(self, sampling: bool, eps=None, generator: torch.Generator | None = None):
        """(fw, tw, cw): sampled weights when `sampling`, else the posterior means.

        The noise is eps = (eps_f, eps_t, eps_c), standard normal of the
        three weights' shapes, passed in or drawn from `generator` in that order.
        """
        if not sampling:
            return self.mean_weights()
        pairs = ((self.feature_mu, self.feature_rho), (self.text_mu, self.text_rho),
                 (self.combined_mu, self.combined_rho))
        if eps is None:
            if generator is None:
                raise ValueError("sampling needs eps or an explicit generator")
            eps = [torch.randn(mu.shape, generator=generator, device=mu.device) for mu, _ in pairs]
        return tuple(reparameterize(mu, rho, e.to(mu.device)) for (mu, rho), e in zip(pairs, eps))

    def kl_divergence(self) -> torch.Tensor:
        """Closed-form KL of the three posteriors, clamped to [0, 120] (router.py:125-133)."""
        kl = (gaussian_kl(self.feature_mu, self.feature_rho)
              + gaussian_kl(self.text_mu, self.text_rho)
              + gaussian_kl(self.combined_mu, self.combined_rho))
        kl = torch.nan_to_num(kl, nan=0.0, posinf=200.0, neginf=0.0)
        return torch.clamp(kl, 0.0, 120.0)

    def inv_temperature(self, annealing_factor: float = 1.0) -> torch.Tensor:
        """1 / clip(temperature * annealing, 0.5, 5) as a 1-element fp32 tensor."""
        return 1.0 / torch.clamp(self.temperature.float() * annealing_factor, 0.5, 5.0)

    def forward(self, feature: torch.Tensor, text: torch.Tensor, sampling: bool = False,
                hard: bool = False, annealing_factor: float | torch.Tensor = 1.0, eps=None):
        """feature [B, T, C], text [B, text_dim] -> (probs, logits) [B, T, E], fp32
        (router.py:84-123).

        `sampling` reparameterises the weights from `eps` (see `sample_weights`),
        else takes the posterior means. The logits are divided by
        clip(temperature * annealing, 0.5, 5) and clipped to +-20. `hard` is
        the argmax one-hot: a tie goes to the first maximum (the fused
        kernel's router splits ties instead).
        """
        fw, tw, cw = self.sample_weights(sampling, eps)
        feature = torch.nan_to_num(feature.float(), nan=0.0, posinf=1.0, neginf=-1.0)
        text = torch.nan_to_num(text.float(), nan=0.0, posinf=1.0, neginf=-1.0)
        h = self.hidden
        logits = (feature @ fw) @ cw[:h] + ((text @ tw) @ cw[h:])[:, None, :]
        eff_temp = torch.clamp(self.temperature[0].float() * annealing_factor, 0.5, 5.0)
        logits = torch.clamp(logits / eff_temp, -20.0, 20.0)
        probs = torch.softmax(logits, dim=-1)
        probs = torch.clamp(probs, 1e-6, 1.0)
        probs = probs / probs.sum(dim=-1, keepdim=True)
        if hard:
            probs = F.one_hot(probs.argmax(dim=-1), self.num_experts).to(probs.dtype)
        return probs, logits
