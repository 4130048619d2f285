"""Bayesian MoE gating network with HMC uncertainty (counterpart of
moegan_tpu/prototype/gating.py).

Six stacked BayesianLinears with ReLU (layer1, layer2, layer2a-c, layer3),
optional text conditioning by an elementwise product with a projected text
embedding after layer 1, and Hamiltonian Monte Carlo over the input
embedding: leapfrog integration of x against the potential KL(softmax(
logits0 / T) || softmax(logits(x) / T)), a Metropolis test, and the expert
probabilities of the kept samples -> (mean, std).

The chain is a Python loop with `torch.autograd.grad` for the leapfrog
gradient, and keeps the JAX chain's draws (gating.py:55-124): each step
draws, from one `torch.Generator` and in this order, the momentum, the
network noise of the first gradient, one noise shared by every leapfrog
step, one shared by both potentials of the accept test, the accept
uniform, and the noise of the kept sample's forward. The last leapfrog step
takes a half momentum update, and a proposal is accepted when dH < 0 or u <
exp(-min(dH, 50)). The accept decision stays on the device. A step draws
each noise's weights once and differentiates the potential in x only; the
potential does not need the KL, so the chain never computes it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from moegan_tpu_torch.core import inits
from moegan_tpu_torch.prototype.bayesian import BayesianLinear

LAYERS = ("layer1", "layer2", "layer2a", "layer2b", "layer2c", "layer3")


class BayesianMoEGatingNetwork(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, num_experts: int,
                 use_text: bool = False, text_dim: int | None = None, num_samples: int = 75,
                 gen: torch.Generator | None = None):
        super().__init__()
        gen = inits.default_generator(gen)
        self.hidden_dim, self.num_experts = hidden_dim, num_experts
        self.use_text, self.num_samples = use_text, num_samples
        self.layer1 = BayesianLinear(input_dim, hidden_dim, gen)
        if use_text:
            self.text_projection = nn.Linear(text_dim or input_dim, hidden_dim)
            with torch.no_grad():
                self.text_projection.weight.copy_(
                    inits.lecun_normal((text_dim or input_dim, hidden_dim), gen).t())
                self.text_projection.bias.zero_()
        for name in LAYERS[1:-1]:
            self.add_module(name, BayesianLinear(hidden_dim, hidden_dim, gen))
        self.layer3 = BayesianLinear(hidden_dim, num_experts, gen)

    def draw_noise(self, generator: torch.Generator | None = None) -> list:
        """The noise of one sampled forward: [(eps_w, eps_b)] per layer, in LAYERS order."""
        return [getattr(self, name).draw_noise(generator) for name in LAYERS]

    def weights(self, eps=None) -> list:
        """[(w, b)] per layer: drawn with `eps` (as `draw_noise` gives it), or the means."""
        layers = [getattr(self, name) for name in LAYERS]
        if eps is None:
            return [(layer.w_mu, layer.b_mu) for layer in layers]
        return [layer.sample(e) for layer, e in zip(layers, eps)]

    def logits(self, x: torch.Tensor, weights, text_embedding: torch.Tensor | None = None):
        """The network's logits with the given weights [(w, b)] per layer."""
        for i, (w, b) in enumerate(weights):
            x = x @ w + b
            if i < len(weights) - 1:
                x = F.relu(x)
            if i == 0 and self.use_text and text_embedding is not None:
                x = x * self.text_projection(text_embedding)
        return x

    def forward(self, x: torch.Tensor, text_embedding: torch.Tensor | None = None,
                sample: bool = True, eps=None):
        """(expert_probs, kl, logits); `eps` as `draw_noise` gives it when `sample`."""
        if sample and eps is None:
            raise ValueError("a sampled forward needs its noise (draw_noise)")
        weights = self.weights(eps if sample else None)
        logits = self.logits(x, weights, text_embedding)
        if sample:
            kl = sum(getattr(self, name).kl(w, b) for name, (w, b) in zip(LAYERS, weights))
        else:
            kl = torch.zeros((), device=x.device)
        return torch.softmax(logits, dim=-1), kl, logits


def _potential(gating, x, ref, weights, temperature):
    logp = F.log_softmax(gating.logits(x, weights) / temperature, dim=-1)
    return torch.sum(ref * (torch.log(ref + 1e-30) - logp))


def hmc_potential(gating: BayesianMoEGatingNetwork, x: torch.Tensor, ref: torch.Tensor,
                  eps, temperature: float = 1.3) -> torch.Tensor:
    """sum ref * (log ref - log softmax(logits(x) / T)) under the network noise eps."""
    return _potential(gating, x, ref, gating.weights(eps), temperature)


def _grad_potential(gating, x, ref, weights, temperature):
    x = x.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(_potential(gating, x, ref, weights, temperature), x)
    return g


def metropolis_accept(delta_h: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Accept when dH < 0 or u < exp(-min(dH, 50))."""
    return (delta_h < 0) | (u < torch.exp(-torch.clamp(delta_h, max=50.0)))


def hmc_step(gating: BayesianMoEGatingNetwork, x: torch.Tensor, ref: torch.Tensor,
             generator: torch.Generator | None, *, step_size: float = 0.003,
             num_steps: int = 15, temperature: float = 1.3):
    """One chain step from x: (x_next, probs of x_next, accepted, dH)."""
    dev = x.device
    momentum0 = torch.randn(x.shape, generator=generator, device=dev)
    eps1, eps2, eps3 = (gating.draw_noise(generator) for _ in range(3))
    u = torch.rand((), generator=generator, device=dev)
    eps_cur = gating.draw_noise(generator)
    # Each noise's weights are drawn once; only x is differentiated.
    with torch.no_grad():
        w1, w2, w3 = (gating.weights(e) for e in (eps1, eps2, eps3))

    mom = momentum0 - 0.5 * step_size * _grad_potential(gating, x, ref, w1, temperature)
    x_prop = x
    for i in range(num_steps):
        x_prop = x_prop + step_size * mom
        g = _grad_potential(gating, x_prop, ref, w2, temperature)
        mom = mom - (1.0 if i < num_steps - 1 else 0.5) * step_size * g
    with torch.no_grad():
        u_prop = _potential(gating, x_prop, ref, w3, temperature)
        u_cur = _potential(gating, x, ref, w3, temperature)
        delta_h = (u_prop + 0.5 * torch.sum(mom ** 2)) - (u_cur + 0.5 * torch.sum(momentum0 ** 2))
        accept = metropolis_accept(delta_h, u)
        x_next = torch.where(accept, x_prop, x)
        probs = torch.softmax(gating.logits(x_next, gating.weights(eps_cur)), dim=-1)
    return x_next, probs, accept, delta_h


def hamiltonian_monte_carlo(gating: BayesianMoEGatingNetwork, x: torch.Tensor,
                            generator: torch.Generator | None, *, num_samples: int = 75,
                            step_size: float = 0.003, num_steps: int = 15, burn_in: int = 200,
                            temperature: float = 1.3):
    """HMC over the input embedding x [N, input_dim] (gating.py:55-124):
    burn_in + num_samples chain steps. Returns (mean_probs, uncertainty,
    acceptance_rate) over the kept samples (the acceptance over all steps)."""
    with torch.no_grad():
        _, _, logits0 = gating(x, sample=False)
        ref = torch.softmax(logits0 / temperature, dim=-1)
    kept, accepts = [], []
    x_cur = x.detach()
    for i in range(burn_in + num_samples):
        x_cur, probs, accept, _ = hmc_step(gating, x_cur, ref, generator, step_size=step_size,
                                           num_steps=num_steps, temperature=temperature)
        accepts.append(accept)
        if i >= burn_in:
            kept.append(probs)
    kept = torch.stack(kept)
    return (kept.mean(dim=0), kept.std(dim=0, unbiased=False),
            torch.stack(accepts).float().mean())


def predict_expert(gating: BayesianMoEGatingNetwork, text_embedding: torch.Tensor,
                   generator: torch.Generator | None, *, threshold: float = 0.7,
                   num_samples: int = 75, burn_in: int = 200, step_size: float = 0.003):
    """(selected experts, mean_probs, uncertainty): the experts whose mean
    probability in row 0 exceeds `threshold`, else row 0's argmax (gating.py:127-144)."""
    mean_probs, uncertainty, _ = hamiltonian_monte_carlo(
        gating, text_embedding, generator, num_samples=num_samples, burn_in=burn_in,
        step_size=step_size)
    row = mean_probs[0].detach().cpu()
    selected = [i for i in range(row.shape[-1]) if float(row[i]) > threshold]
    if not selected:
        selected = [int(row.argmax())]
    return selected, mean_probs, uncertainty
