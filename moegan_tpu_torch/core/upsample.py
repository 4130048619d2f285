"""x2 bilinear upsample (counterpart of moegan_tpu/core/upsample.py:136-151).

The JAX default is `jax.image.resize(method="bilinear")`, which for an exact
x2 with half-pixel centres is `F.interpolate(scale_factor=2,
mode="bilinear", align_corners=False)`: the plain version
`ops/upsample.py::upsample2x_reference`, computed in float32 and rounded
once. On the card the same function is the hand-written kernel pair of
`ops/csrc/upsample.cu` (NHWC, forward and a gather backward), through
`Upsample2xFunction`. The off-by-default two-tap path
(`MOEGAN_FAST_UPSAMPLE`) is not ported.
"""

from __future__ import annotations

import torch

from moegan_tpu_torch.ops.upsample import Upsample2xFunction, upsample2x_reference


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, 2H, 2W, C], computed in float32, returned in x's
    dtype: the kernels for a CUDA tensor, the plain version otherwise."""
    if x.device.type == "cuda":
        return Upsample2xFunction.apply(x.contiguous())
    return upsample2x_reference(x)
