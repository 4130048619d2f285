"""x2 bilinear upsample (counterpart of moegan_tpu/core/upsample.py:136-151).

The JAX default is `jax.image.resize(method="bilinear")`, which for an exact
x2 with half-pixel centres is `F.interpolate(scale_factor=2,
mode="bilinear", align_corners=False)`. The off-by-default two-tap path
(`MOEGAN_FAST_UPSAMPLE`) is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, 2H, 2W, C], computed in float32, returned in x's dtype."""
    y = F.interpolate(
        x.permute(0, 3, 1, 2).float(), scale_factor=2, mode="bilinear", align_corners=False
    )
    return y.permute(0, 2, 3, 1).to(x.dtype)
