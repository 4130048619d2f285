"""The prototype Bayesian-MoE router (counterpart of moegan_tpu/prototype/).

A standalone router-only MoE trained with pseudo-labels, used to study
expert routing and its uncertainty before the GAN:

- `bayesian.BayesianLinear`: Blundell weight-uncertainty linear layer with a
  scale-mixture Gaussian prior;
- `gating.BayesianMoEGatingNetwork`: six BayesianLinears, optional text
  conditioning, and Hamiltonian Monte Carlo over the input embedding
  (`hamiltonian_monte_carlo`, `predict_expert`);
- `moe_wrapper.MixtureOfExperts`: the network with expert descriptions;
- `training`: k-means pseudo-labels and supervised router training;
- `testing.run_harness`: the manual harness over canned prompts;
- `convert`: the reference router checkpoint's names onto the port's.

Every weight-noise draw is an explicit tensor or comes from a
`torch.Generator`; seeded draws differ from `jax.random`'s.
"""

from moegan_tpu_torch.prototype.bayesian import BayesianLinear
from moegan_tpu_torch.prototype.gating import BayesianMoEGatingNetwork
from moegan_tpu_torch.prototype.moe_wrapper import MixtureOfExperts

__all__ = ["BayesianLinear", "BayesianMoEGatingNetwork", "MixtureOfExperts"]
