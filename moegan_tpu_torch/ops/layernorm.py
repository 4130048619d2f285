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
kernel or raises. There is no fallback between the two. Both launches follow
`layer_norm_plan` (pure Python, cached per shape): the vector width, the
lanes a row, the grid; the C entry points check the plan they are given.
The backward's blocks meet in one launch through a device counter
(`_ticket`, one per device, 0 between calls): the last 8 to arrive add the
partial sums.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

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


class LayerNormPlan(NamedTuple):
    """The launches of both kernels at one shape (`layer_norm_plan`)."""

    vec: int  # elements a vector: 8 (bf16) or 4 (fp32) in 16 bytes, or 1
    group: int  # lanes a row (G, a power of two <= 32)
    vectors: int  # vectors a lane (group * vectors * vec >= C)
    rows: int  # rows a block takes at once
    fwd_blocks: int
    bwd_blocks: int  # also the rows of the backward's partial sums


_WARPS = 8  # a block of either kernel, as csrc/layer_norm.cu's kWarps


def _pow2_at_least(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=None)
def layer_norm_plan(N: int, C: int, dtype: torch.dtype, aligned: bool,
                    sms: int) -> LayerNormPlan:
    """The kernels' launch plan for x [N, C] (N >= 1) of `dtype` on `sms` SMs.
    `aligned`: x, the other row tensors (y; dy and dx) and the weights (scale
    and bias; scale) lie on 16-byte boundaries. 16-byte vectors where C is a
    multiple of them and all are aligned, else single elements; a row over G
    lanes, G = the vectors a row rounded up to a power of two, at most 32.
    The forward's grid: two rows a warp where N allows, at most the blocks
    the SMs hold at once (4 an SM at <= 8 columns a thread, else 2), at
    least a block on every SM that N fills. The backward's depends on N and
    `sms` alone: 2 blocks an SM, at most one a 8 rows (a row a warp), each
    writing one partial row."""
    full = 8 if dtype == torch.bfloat16 else 4
    vec = full if aligned and C % full == 0 else 1
    nvec = -(-C // vec)
    group = min(32, _pow2_at_least(nvec))
    vectors = _pow2_at_least(-(-nvec // group))
    rows = _WARPS * (32 // group)
    fwd_per_sm = 4 if vec * vectors <= 8 else 2
    fwd_blocks = max(min(-(-N // (2 * rows)), fwd_per_sm * sms), min(-(-N // rows), sms))
    return LayerNormPlan(vec, group, vectors, rows, fwd_blocks, min(-(-N // _WARPS), 2 * sms))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _ticket(device: torch.device) -> torch.Tensor:
    """The backward's ticket counter on `device`: 0 between calls (the
    kernel's last reducing block sets it back), so one allocation serves
    every call and every captured CUDA graph."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("layer_norm_bwd: run it once on this device before capturing a graph")
    return torch.zeros(1, dtype=torch.int32, device=device)


_P, _I = ctypes.c_void_p, ctypes.c_int
# pointers, N, C, is_bf16, eps, the plan's five ints, the stream
_FWD_ARGS = (_P,) * 4 + (_I,) * 3 + (ctypes.c_float,) + (_I,) * 5 + (_P,)
_BWD_ARGS = (_P,) * 8 + (_I,) * 3 + (ctypes.c_float,) + (_I,) * 5 + (_P,)


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
    xp, sp, bp, yp = x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr()
    plan = layer_norm_plan(N, C, x.dtype, (xp | sp | bp | yp) % 16 == 0, _sm_count(x.device))
    lib, fn = _build.entry("layer_norm", "moegan_layer_norm_fwd", _FWD_ARGS)
    rc = fn(xp, sp, bp, yp, N, C, int(x.dtype == torch.bfloat16),
            eps, *plan[:4], plan.fwd_blocks, torch.cuda.current_stream(x.device).cuda_stream)
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
    if N == 0:
        return dx, torch.zeros(C, **f32), torch.zeros(C, **f32)
    grads = torch.empty((2, C), **f32)  # dscale, dbias
    xp, sp, dyp, dxp = x.data_ptr(), weight.data_ptr(), dy.data_ptr(), dx.data_ptr()
    plan = layer_norm_plan(N, C, x.dtype, (xp | sp | dyp | dxp) % 16 == 0, _sm_count(x.device))
    part = torch.empty((plan.bwd_blocks, 2, C), **f32)
    lib, fn = _build.entry("layer_norm", "moegan_layer_norm_bwd", _BWD_ARGS)
    rc = fn(xp, sp, dyp, dxp, part.data_ptr(), grads[0].data_ptr(),
            grads[1].data_ptr(), _ticket(x.device).data_ptr(), N, C,
            int(x.dtype == torch.bfloat16), eps, *plan[:4], plan.bwd_blocks,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, grads[0], grads[1]


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
    `MOEGAN_FUSED_LN=1`, read at call time, else the plain `layer_norm`.
    With `use_pallas=False` always the plain `layer_norm`, whatever the flag."""

    def __init__(self, dim: int, eps: float = 1e-5, use_pallas: bool = True):
        super().__init__(dim, eps)
        self.use_pallas = use_pallas

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_pallas and os.environ.get("MOEGAN_FUSED_LN", "0") == "1":
            return FusedLayerNormFunction.apply(x, self.weight, self.bias, self.eps)
        return layer_norm(x, self.weight, self.bias, self.eps)
