"""The generator's x2 bilinear upsample: the CUDA kernels, their plain
PyTorch version, and the autograd function that joins them.

The JAX package has no TPU kernel here: moegan_tpu/core/upsample.py calls
`jax.image.resize`, which XLA fuses. The port's `F.interpolate` route (the
plain version, `upsample2x_reference`) held about half of every step on the
H100, so `csrc/upsample.cu` replaces it on the card: `upsample2x_fwd` and
`upsample2x_bwd`, each counting its calls in `.launches`, joined by
`Upsample2xFunction`. Both take [B, H, W, C] (NHWC, as the generator holds
it), bf16 or float32, compute in float32 with PyTorch's taps and weights and
round once; the backward is a gather in a fixed order (no atomics), so two
calls give the same bits.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from moegan_tpu_torch.ops import _build


def upsample2x_reference(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, 2H, 2W, C], half-pixel centres, computed in float32,
    returned in x's dtype."""
    y = F.interpolate(
        x.permute(0, 3, 1, 2).float(), scale_factor=2, mode="bilinear", align_corners=False
    )
    return y.permute(0, 2, 3, 1).to(x.dtype)


def upsample2x_bwd_reference(dy: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward kernel: the gradient [B, H, W, C], in dy's
    dtype, of `upsample2x_reference` for its cotangent dy [B, 2H, 2W, C]."""
    B, H2, W2, C = dy.shape
    with torch.enable_grad():
        x = torch.zeros((B, H2 // 2, W2 // 2, C), dtype=dy.dtype, device=dy.device,
                        requires_grad=True)
        (dx,) = torch.autograd.grad(upsample2x_reference(x), x, dy)
    return dx


def _check(t: torch.Tensor, name: str) -> None:
    if t.dim() != 4:
        raise ValueError(f"{name} must be [B, H, W, C], got shape {tuple(t.shape)}")
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the upsample kernels take bf16 or float32, got {name} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_ARGS = (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def _launch(entry: str, src: torch.Tensor, dst: torch.Tensor, B: int, H: int, W: int,
            C: int) -> None:
    lib, fn = _build.entry("upsample", entry, _ARGS)
    rc = fn(src.data_ptr(), dst.data_ptr(), B, H, W, C, int(src.dtype == torch.bfloat16),
            torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(lib, rc, entry)


def upsample2x_fwd(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, 2H, 2W, C] in x's dtype, as `upsample2x_reference`."""
    if x.device.type == "cpu":
        return upsample2x_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"upsample2x_fwd runs on cpu or cuda tensors, got {x.device}")
    _check(x, "x")
    B, H, W, C = x.shape
    y = torch.empty((B, 2 * H, 2 * W, C), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    _launch("moegan_upsample2x_fwd", x, y, B, H, W, C)
    upsample2x_fwd.launches += 1
    return y


upsample2x_fwd.launches = 0


def upsample2x_bwd(dy: torch.Tensor) -> torch.Tensor:
    """The gradient [B, H, W, C] of the upsample for its cotangent dy
    [B, 2H, 2W, C], in dy's dtype, as `upsample2x_bwd_reference`."""
    if dy.device.type == "cpu":
        return upsample2x_bwd_reference(dy)
    if dy.device.type != "cuda":
        raise ValueError(f"upsample2x_bwd runs on cpu or cuda tensors, got {dy.device}")
    _check(dy, "dy")
    B, H2, W2, C = dy.shape
    if H2 % 2 or W2 % 2:
        raise ValueError(f"dy's height and width must be even, got {tuple(dy.shape)}")
    dx = torch.empty((B, H2 // 2, W2 // 2, C), dtype=dy.dtype, device=dy.device)
    if dx.numel() == 0:
        return dx
    _launch("moegan_upsample2x_bwd", dy, dx, B, H2 // 2, W2 // 2, C)
    upsample2x_bwd.launches += 1
    return dx


upsample2x_bwd.launches = 0


class Upsample2xFunction(torch.autograd.Function):
    """Differentiable `upsample2x_fwd`; the backward launches `upsample2x_bwd`
    on the cotangent (in y's dtype, which is x's). Saves nothing."""

    @staticmethod
    def forward(ctx, x):
        return upsample2x_fwd(x)

    @staticmethod
    def backward(ctx, dy):
        return upsample2x_bwd(dy.contiguous())
