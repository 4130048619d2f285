"""Bilinear grid sampling (counterpart of moegan_tpu/ops/grid_sample.py).

The JAX package writes `torch.nn.functional.grid_sample(mode="bilinear",
padding_mode="zeros", align_corners=False)` out as gathers; here it is that
call. NHWC in and out, as in the JAX package. The sampling runs in float32
(the JAX version multiplies the taps by float32 weights) and the result is
cast back to the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """x: [B, H, W, C]; grid: [B, Hg, Wg, 2] in [-1, 1], (x, y) order -> [B, Hg, Wg, C]."""
    out = F.grid_sample(
        x.permute(0, 3, 1, 2).float(),
        grid.float(),
        mode="bilinear",
        padding_mode="zeros",
        align_corners=False,
    )
    return out.permute(0, 2, 3, 1).to(x.dtype)
