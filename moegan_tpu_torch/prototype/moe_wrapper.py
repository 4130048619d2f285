"""MixtureOfExperts with textual expert descriptions (counterpart of
moegan_tpu/prototype/moe_wrapper.py).

The gating network alone (the experts are placeholders in the prototype),
with human-readable expert descriptions and `describe_selection`, which
reports the HMC mean probabilities with their uncertainties.
"""

from __future__ import annotations

import torch

from moegan_tpu_torch.prototype.gating import BayesianMoEGatingNetwork, predict_expert

EXPERT_DESCRIPTIONS = [
    "General Expert for all categories",
    "Expert for natural landscapes",
    "Expert for portraits and people",
    "Expert for urban environments",
    "Expert for animals and wildlife",
    "Expert for abstract concepts and styles",
    "Expert for indoor scenes and objects",
    "Expert for transportation and vehicles",
    "Expert for weather and atmospheric conditions",
]


class MixtureOfExperts:
    """The gating network on `device` (raises without a card unless
    device="cpu"), its weights from `seed`, and its own noise generator
    seeded with seed + 1 on the device."""

    def __init__(self, input_dim: int, hidden_dim: int, num_experts: int, seed: int = 0,
                 num_samples: int = 75, burn_in: int = 200, device="cuda"):
        from moegan_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.gating = BayesianMoEGatingNetwork(
            input_dim, hidden_dim, num_experts, num_samples=num_samples,
            gen=torch.Generator().manual_seed(seed)).to(self.device)
        self.num_experts = num_experts
        self.num_samples = num_samples
        self.burn_in = burn_in
        self.expert_descriptions = EXPERT_DESCRIPTIONS[:num_experts]
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    def __call__(self, text_embedding):
        """(expert_probs of one sampled forward, selected experts, HMC mean
        probabilities, their uncertainty) for embeddings [N, input_dim]."""
        x = torch.as_tensor(text_embedding, dtype=torch.float32).to(self.device)
        with torch.no_grad():
            probs, _, _ = self.gating(x, sample=True, eps=self.gating.draw_noise(self.generator))
        selected, mean_probs, uncertainty = predict_expert(
            self.gating, x, self.generator, num_samples=self.num_samples, burn_in=self.burn_in)
        return probs, selected, mean_probs, uncertainty

    def describe_selection(self, text_embedding) -> str:
        _, selected, mean_probs, uncertainty = self(text_embedding)
        mp, unc = mean_probs.cpu().numpy(), uncertainty.cpu().numpy()
        lines = ["Expert selection:"]
        for i in range(self.num_experts):
            lines.append(f"- {self.expert_descriptions[i]}: {mp[0, i]:.4f} "
                         f"(uncertainty: {unc[0, i]:.4f})")
        lines.append("")
        lines.append("Selected experts:")
        for idx in selected:
            lines.append(f"- {self.expert_descriptions[idx]}")
        return "\n".join(lines)
