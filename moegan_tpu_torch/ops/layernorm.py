"""LayerNorm with float32 statistics (counterpart of `_xla_ln`,
moegan_tpu/ops/fused_layernorm.py:102-110, and of `FusedLayerNorm` at its
default).

The Pallas LayerNorm kernel in the JAX package is opt-in
(`MOEGAN_FUSED_LN=1`), so the serving path runs this plain version.
"""

from __future__ import annotations

import torch
from torch import nn


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5):
    """Normalise over the last axis in float32; output in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    """torch-eps (1e-5) LayerNorm; `weight`/`bias` are flax's `scale`/`bias`."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
