"""Bayesian variational router (counterpart of moegan_tpu/core/router.py), eval path.

The parameters are the JAX package's: feature/text/combined mu and rho and
the temperature. Serving uses the posterior means and hard top-1 routing,
so it needs no router randomness; weight sampling, the KL and the annealed
temperature belong to the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from moegan_tpu_torch.core import inits


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

    def inv_temperature(self, annealing_factor: float = 1.0) -> torch.Tensor:
        """1 / clip(temperature * annealing, 0.5, 5) as a 1-element fp32 tensor."""
        return 1.0 / torch.clamp(self.temperature.float() * annealing_factor, 0.5, 5.0)

    def forward(self, feature: torch.Tensor, text: torch.Tensor, hard: bool = True):
        """Eval routing. feature [B, T, C], text [B, text_dim] -> (probs, logits) [B, T, E].

        `hard` is argmax one-hot, as the JAX router's (a tie goes to the
        first maximum; the fused path splits ties instead).
        """
        fw, tw, cw = self.mean_weights()
        feature = torch.nan_to_num(feature.float(), nan=0.0, posinf=1.0, neginf=-1.0)
        text = torch.nan_to_num(text.float(), nan=0.0, posinf=1.0, neginf=-1.0)
        h = self.hidden
        logits = (feature @ fw) @ cw[:h] + ((text @ tw) @ cw[h:])[:, None, :]
        logits = torch.clamp(logits * self.inv_temperature(), -20.0, 20.0)
        probs = torch.softmax(logits, dim=-1)
        probs = torch.clamp(probs, 1e-6, 1.0)
        probs = probs / probs.sum(dim=-1, keepdim=True)
        if hard:
            probs = F.one_hot(probs.argmax(dim=-1), self.num_experts).to(probs.dtype)
        return probs, logits
