"""LayerNorm with float32 statistics: the plain version, the CUDA kernels
that replace the JAX package's Pallas LayerNorm, and the modules.

Counterpart of moegan_tpu/ops/fused_layernorm.py. `layer_norm` is its XLA
path `_xla_ln` (:102-110). The TPU kernels `_fwd_kernel` (launched by
`_fwd_impl`) and `_bwd_kernel` (launched by `_bwd_rule`) become
`csrc/layer_norm.cu`, wrapped as `layer_norm_fwd` and `layer_norm_bwd` and
joined by `FusedLayerNormFunction`; their plain twins are `layer_norm` and
`layer_norm_bwd_reference`. The backward recomputes the row statistics from
x, as the TPU kernel does.

`FusedLayerNorm` is the JAX class of the same name: at call time it reads
`MOEGAN_FUSED_LN` and takes the kernels under "1", the plain version
otherwise (the JAX default). The TPU kernel's gate (`_supported`: C a
multiple of 8, C <= 512, N a multiple of the row block) has no meaning on
Hopper: the kernel takes every N and every C up to 512 and raises above.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import os

import torch
from torch import nn

from moegan_tpu_torch.ops import _build

MAX_C = 512


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5):
    """Normalise over the last axis in float32; output in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_bwd_reference(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                             eps: float = 1e-5):
    """Plain version of the backward kernel (`_bwd_kernel`): (dx in x's dtype,
    dscale [C] fp32, dbias [C] fp32) for the cotangent dy of `layer_norm`."""
    C = x.shape[-1]
    xf = x.reshape(-1, C).float()
    dyf = dy.reshape(-1, C).float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * inv
    g = dyf * scale.float()
    m1 = g.mean(-1, keepdim=True)
    m2 = (g * xhat).mean(-1, keepdim=True)
    dx = inv * (g - m1 - xhat * m2)
    return dx.reshape(x.shape).to(x.dtype), (dyf * xhat).sum(0), dyf.sum(0)


def _check(x: torch.Tensor, scale: torch.Tensor, bias=None, dy=None) -> tuple[int, int]:
    """Raise unless the kernels take these tensors (x contiguous); returns (N, C)."""
    C = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the LayerNorm kernels take bf16 or float32 x, got {x.dtype}")
    if not 1 <= C <= MAX_C:
        raise ValueError(f"the LayerNorm kernels take 1 <= C <= {MAX_C}, got C={C}")
    for name, t, dtype, shape in (("scale", scale, torch.float32, (C,)),
                                  ("bias", bias, torch.float32, (C,)),
                                  ("dy", dy, x.dtype, tuple(x.shape))):
        if t is None:
            continue
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {x.device}")
    return x.numel() // C, C


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of x [..., C] (bf16 or float32) with float32 weight and bias [C]."""
    if x.device.type == "cpu":
        return layer_norm(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_fwd runs on cpu or cuda tensors, got {x.device}")
    x = x.contiguous()
    N, C = _check(x, weight, bias=bias)
    y = torch.empty_like(x)
    if N == 0:
        return y
    lib = _build.load("layer_norm")
    fn = lib.moegan_layer_norm_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    rc = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), N, C,
            int(x.dtype == torch.bfloat16), eps, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return y


layer_norm_fwd.launches = 0


def layer_norm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, eps: float = 1e-5):
    """(dx in x's dtype, dscale [C] fp32, dbias [C] fp32) for the cotangent dy,
    as `layer_norm_bwd_reference`."""
    if x.device.type == "cpu":
        return layer_norm_bwd_reference(x, weight, dy, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_bwd runs on cpu or cuda tensors, got {x.device}")
    x = x.contiguous()
    dy = dy.to(x.dtype).contiguous()
    N, C = _check(x, weight, dy=dy)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dscale, dbias = torch.empty(C, **f32), torch.empty(C, **f32)
    if N == 0:
        return dx, dscale.zero_(), dbias.zero_()
    lib = _build.load("layer_norm")
    blocks = lib.moegan_layer_norm_bwd_blocks
    blocks.restype = ctypes.c_int
    blocks.argtypes = [ctypes.c_int]
    part = torch.empty((blocks(N), 2, C), **f32)
    fn = lib.moegan_layer_norm_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    rc = fn(x.data_ptr(), weight.data_ptr(), dy.data_ptr(), dx.data_ptr(), part.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), N, C, int(x.dtype == torch.bfloat16), eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, dscale, dbias


layer_norm_bwd.launches = 0


class FusedLayerNormFunction(torch.autograd.Function):
    """Differentiable `layer_norm_fwd`: saves x and the scale, and the backward
    recomputes the statistics (`layer_norm_bwd`), as `fused_layer_norm`'s vjp."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return layer_norm_fwd(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x, weight, dy, ctx.eps)
        return dx, dscale.to(weight.dtype), dbias.to(weight.dtype), None


class LayerNorm(nn.Module):
    """torch-eps (1e-5) LayerNorm; `weight`/`bias` are flax's `scale`/`bias`."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class FusedLayerNorm(LayerNorm):
    """The JAX `FusedLayerNorm` (fused_layernorm.py:185): the kernels under
    `MOEGAN_FUSED_LN=1`, read at call time, else the plain `layer_norm`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if os.environ.get("MOEGAN_FUSED_LN", "0") == "1":
            return FusedLayerNormFunction.apply(x, self.weight, self.bias, self.eps)
        return layer_norm(x, self.weight, self.bias, self.eps)
