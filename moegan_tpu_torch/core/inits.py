"""Parameter initializers (counterpart of moegan_tpu/core/inits.py).

Same distributions as the JAX package, drawn from an explicit
`torch.Generator` on the CPU. The numbers differ from `jax.random`'s; a
test that needs both packages on the same weights carries them across with
`moegan_tpu_torch.convert`. Shapes are given in the JAX layouts (conv HWIO,
dense [in, out]) so that fan-in is computed the same way; modules permute
the result into their own layout.
"""

from __future__ import annotations

import math

import torch


def kaiming_normal_leaky(shape, gen):
    """He-normal with the leaky-relu(0.2) gain over the fan-in of an HWIO conv kernel."""
    gain = math.sqrt(2.0 / (1.0 + 0.2**2))
    fan_in = shape[0] * shape[1] * shape[2]
    return torch.randn(shape, generator=gen) * (gain / math.sqrt(fan_in))


def torch_linear_kernel(shape, gen):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for an [in, out] kernel."""
    bound = 1.0 / math.sqrt(shape[0])
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def torch_linear_bias(shape, gen, fan_in: int):
    bound = 1.0 / math.sqrt(fan_in)
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def torch_conv_kernel(shape, gen):
    """Kaiming-uniform(a=sqrt(5)) for an HWIO kernel (torch Conv2d default)."""
    fan_in = shape[0] * shape[1] * shape[2]
    bound = math.sqrt(3.0) * math.sqrt(2.0 / 6.0) / math.sqrt(fan_in)
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def torch_linear(in_dim: int, out_dim: int, gen) -> torch.nn.Linear:
    """An nn.Linear with torch's default init drawn from `gen` (as a flax Dense
    with `torch_linear_kernel` and `torch_linear_bias`)."""
    layer = torch.nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        layer.weight.copy_(torch_linear_kernel((in_dim, out_dim), gen).t())
        layer.bias.copy_(torch_linear_bias((out_dim,), gen, in_dim))
    return layer


def xavier_uniform(shape, gen):
    """Glorot uniform for a 2-D [in, out] kernel (flax xavier_uniform)."""
    bound = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def lecun_normal(shape, gen):
    """flax's default kernel init: a normal truncated at +-2 std, scaled so its
    variance is 1/fan_in, fan_in the product of all but the last (output) axis."""
    fan_in = math.prod(shape[:-1])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=gen)


def normal(shape, gen, std: float = 0.02):
    return torch.randn(shape, generator=gen) * std


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous()


def default_generator(gen=None) -> torch.Generator:
    """`gen`, or a CPU generator seeded with 0."""
    return gen if gen is not None else torch.Generator().manual_seed(0)
