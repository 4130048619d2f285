"""Blundell-style Bayesian linear layer (counterpart of moegan_tpu/prototype/bayesian.py).

Posterior N(mu, softplus(rho)^2) over weights and biases, reparameterised
samples w = mu + softplus(rho) * eps, and the KL estimated as log q(w) -
log P(w) under a scale mixture of two Gaussians (sigma 1 and 0.0025, pi
0.5). The weights keep the JAX layout [in, out] (y = x @ w + b).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from moegan_tpu_torch.core import inits

PRIOR_SIGMA_1 = 1.0
PRIOR_SIGMA_2 = 0.0025
PRIOR_PI = 0.5


def _log_gaussian(x, mu, sigma):
    sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
    return -0.5 * math.log(2 * math.pi) - torch.log(sigma) - 0.5 * torch.square((x - mu) / sigma)


def scale_mixture_log_prob(w: torch.Tensor) -> torch.Tensor:
    """log P(w) under the two-Gaussian scale-mixture prior."""
    p1 = PRIOR_PI * torch.exp(_log_gaussian(w, 0.0, PRIOR_SIGMA_1))
    p2 = (1 - PRIOR_PI) * torch.exp(_log_gaussian(w, 0.0, PRIOR_SIGMA_2))
    return torch.sum(torch.log(p1 + p2 + 1e-30))


class BayesianLinear(nn.Module):
    def __init__(self, in_dim: int, features: int, gen: torch.Generator | None = None):
        super().__init__()
        gen = inits.default_generator(gen)
        self.w_mu = nn.Parameter(inits.normal((in_dim, features), gen, 0.1))
        self.w_rho = nn.Parameter(torch.full((in_dim, features), -3.0))
        self.b_mu = nn.Parameter(inits.normal((features,), gen, 0.1))
        self.b_rho = nn.Parameter(torch.full((features,), -3.0))

    def draw_noise(self, generator: torch.Generator | None = None):
        """(eps_w, eps_b), standard normal of the weight's and the bias's shapes."""
        dev = self.w_mu.device
        return (torch.randn(self.w_mu.shape, generator=generator, device=dev),
                torch.randn(self.b_mu.shape, generator=generator, device=dev))

    def sample(self, eps) -> tuple[torch.Tensor, torch.Tensor]:
        """(w, b) = mu + softplus(rho) * eps for eps = (eps_w, eps_b)."""
        if eps is None:
            raise ValueError("a sampled forward needs its noise eps = (eps_w, eps_b)")
        return (self.w_mu + torch.log1p(torch.exp(self.w_rho)) * eps[0],
                self.b_mu + torch.log1p(torch.exp(self.b_rho)) * eps[1])

    def kl(self, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """log q(w, b) - log P(w, b) of a draw from `sample`."""
        log_q = (torch.sum(_log_gaussian(w, self.w_mu, torch.log1p(torch.exp(self.w_rho))))
                 + torch.sum(_log_gaussian(b, self.b_mu, torch.log1p(torch.exp(self.b_rho)))))
        return log_q - (scale_mixture_log_prob(w) + scale_mixture_log_prob(b))

    def forward(self, x: torch.Tensor, sample: bool = True, eps=None):
        """(y, kl): with `sample`, the weights drawn with eps = (eps_w, eps_b) and
        kl = log q(w) - log P(w) of the draw; else the means and kl = 0."""
        if not sample:
            return x @ self.w_mu + self.b_mu, torch.zeros((), device=x.device)
        w, b = self.sample(eps)
        return x @ w + b, self.kl(w, b)
