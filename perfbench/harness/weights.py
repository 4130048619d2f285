"""Weights, data and noise made from the seed.

Weights: each parameter keeps the scale of its initialiser (the mean and
standard deviation of the tensor the program's initialiser gives, read
once from a template module) and takes its values from one standard-normal
draw on the device, one call for the whole model, from a `torch.Generator`
seeded by the run's seed. Tensors whose initialiser is a constant (biases,
the router's rho and temperature) stay that constant. The router's
combined means are then multiplied by `router_scale`: at the initialiser's
N(0, 0.01) the routing logits of a random model differ by ~1e-3 and bf16
rounding alone would pick most tokens' expert.

The same (seed, template statistics) give the same tensors on every call,
so the reference regenerates the weights it needs instead of reading the
program's.
"""

from __future__ import annotations

import torch

SUBSEEDS = {"weights": 1, "data": 2, "noise": 3, "loader": 4, "inputs": 5, "sample": 6}


def subseed(seed: int, what: str) -> int:
    """A seed for one stream of the run (`SUBSEEDS`), under 2**63."""
    return (int(seed) * 1_000_003 + SUBSEEDS[what]) % (1 << 63)


def template_stats(named_tensors) -> dict[str, tuple[tuple[int, ...], float, float]]:
    """{name: (shape, mean, std)} of the initialiser's tensors."""
    out = {}
    for name, t in named_tensors:
        t = t.detach().float()
        std = float(t.std(correction=0)) if t.numel() > 1 else 0.0
        out[name] = (tuple(t.shape), float(t.mean()), std)
    return out


def make_weights(stats: dict, seed: int, device, router_scale: float) -> dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`}: mean + std * N(0, 1), from one draw."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    total = sum(int(torch.Size(shape).numel()) for shape, _, _ in stats.values())
    noise = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, (shape, mean, std) in stats.items():
        n = int(torch.Size(shape).numel())
        t = noise[offset:offset + n].view(shape) * std + mean
        if name.endswith("combined_mu"):
            t = t * router_scale
        out[name] = t
        offset += n
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: dict, prefix: str = "") -> None:
    """Copy `weights[prefix + name]` into each parameter of `module`."""
    for name, p in module.named_parameters():
        p.copy_(weights[prefix + name])


def noise_shapes(config: dict, batch: int) -> list[tuple[str, tuple[int, ...]]]:
    """The router noise of one training step, in draw order: for the D phase,
    then the G phase, per resolution, the feature, text and combined weights'
    shapes ([C_r, h], [latent, h], [2h, E])."""
    g = config["train_config"]["generator"]
    h, E, lat = g["router_hidden"], g["num_experts"], g["latent_dim"]
    shapes = []
    for phase in ("eps_d", "eps_g"):
        r = 4
        while r <= g["max_resolution"]:
            C = int(g["channels"][str(r)])
            shapes += [(f"{phase}.{r}.f", (C, h)), (f"{phase}.{r}.t", (lat, h)),
                       (f"{phase}.{r}.c", (2 * h, E))]
            r *= 2
    return shapes


class NoiseStream:
    """The training step's randomness from the seed, drawn on the device:
    z [B, latent], the text shuffle perm [B] and the router noise of both
    phases, {"eps_d" | "eps_g": {r: (eps_f, eps_t, eps_c)}}; one normal draw
    and one permutation a step."""

    def __init__(self, config: dict, batch: int, seed: int, device):
        self.batch = batch
        self.latent = config["train_config"]["generator"]["latent_dim"]
        self.shapes = noise_shapes(config, batch)
        self.total = batch * self.latent + sum(
            int(torch.Size(s).numel()) for _, s in self.shapes)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(subseed(seed, "noise"))

    def next(self) -> dict:
        flat = torch.randn(self.total, generator=self.gen, device=self.device)
        perm = torch.randperm(self.batch, generator=self.gen, device=self.device)
        n = self.batch * self.latent
        noise = {"z": flat[:n].view(self.batch, self.latent), "perm": perm,
                 "eps_d": {}, "eps_g": {}}
        offset = n
        for i in range(0, len(self.shapes), 3):
            parts = []
            for name, shape in self.shapes[i:i + 3]:
                k = int(torch.Size(shape).numel())
                parts.append(flat[offset:offset + k].view(shape))
                offset += k
            phase, r, _ = self.shapes[i][0].split(".")
            noise[phase][int(r)] = tuple(parts)
        return noise
