"""Fused Bayesian-MoE: CUDA kernel wrappers, their plain PyTorch versions,
and the autograd function that joins the forward and the backward.

Counterpart of moegan_tpu/ops/fused_moe.py. One CUDA kernel,
`csrc/fused_moe.cu`, replaces both TPU forward kernels `_fused_moe_kernel`
(v1) and `_fused_moe_kernel_v2`: they compute the same function, and the
VMEM gate that chose between them on the TPU has no meaning on Hopper.
`csrc/fused_moe_bwd.cu` replaces the backward `_fused_moe_bwd_kernel_v2`
and covers the v1 `_bwd_fused_kernel` (the same gradient). The TPU path
sends the res-4 block (C=512), whose accumulators miss the VMEM budget, to
an XLA recompute; here the kernel takes every block.

The function: router logits ((x @ fw) @ cw_f + text_logits) * inv_temp,
clipped to +-20; softmax, floor 1e-6, renorm; under `hard`, the multi-hot
of the maxima renormalised (a tie splits evenly, `_routing_probs`,
fused_moe.py:67-77); then sum_e p_e * (gelu_erf(x @ W1_e + b1_e) @ W2_e +
b2_e), with the hidden activation rounded to x's dtype.

`FusedMoEFunction` is the differentiable form under soft routing (the
training path): the forward saves its inputs, as `_fused_fwd` does, and
its routing, which the backward kernels read; they give the FFN and
combine part of the gradient, and the router chain's part is plain
autograd over a recompute of `router_probs`, fed the probs cotangent plus
the combine's, as the JAX package leaves it to XLA (`_fused_moe_bwd_v2`).

The expert-parallel combine (`moe_ffn_combine`, `MoECombineFunction`)
replaces the four probs-as-input TPU kernels `_combine_kernel`,
`_combine_kernel_v2` (forward) and `_combine_bwd_kernel`,
`_combine_bwd_kernel_v2` (backward): the routing probs are an input (a
rank's local expert columns) and there is no router chain. The forward
kernel above serves it instantiated without its router
(`moegan_moe_combine_fwd`); the backward kernels are the same launches
(`moegan_moe_combine_bwd`).

The launch plans (`moe_plan`, `moe_bwd_plan`: the splits of the forward's
and the backward token kernel's (expert, chunk) loop and the weight
gradients' T ranges) are pure Python; each C entry point checks what it is
given and sizes its own tiles and shared memory.

The legacy three-kernel backward of the JAX package (`MOEGAN_PALLAS_MOE_BWD=3`)
replaces its TPU kernels `_bwd_dx_kernel`, `_bwd_dw2_kernel` and
`_bwd_dw1_kernel` (launched by `_fused_moe_bwd_pallas`) with three entry
points of `csrc/fused_moe_legacy.cu`: `moe_bwd_dx`, `moe_bwd_dw2` and
`moe_bwd_dw1`, each recomputing z and h for itself and rounding where its
TPU kernel rounds (plain twins `moe_bwd_dx_reference`,
`moe_bwd_dw2_reference`, `moe_bwd_dw1_reference`). Each takes the forward's
routing (`probs=`, as `FusedMoEFunction` passes it) or computes it first with
the forward kernel. Their plans (`legacy_plan`) are pure Python as well.

`FusedMoEFunction.backward` and `MoECombineFunction.backward` read
`MOEGAN_PALLAS_MOE_BWD` at call time, as the JAX package reads it at trace
time (`_fused_bwd`, `_combine_vjp_bwd`): "1" or unset, the backward kernel
above; "3", the three legacy entry points (the combine keeps its kernel);
"0", the plain recompute through autograd of `moe_ffn_reference` (or
`moe_ffn_combine_reference`), an explicit mode that nothing selects unless
the caller sets it. Other values raise.

Dispatch: a CPU tensor takes the plain version (`moe_ffn_reference`,
`moe_ffn_bwd_reference`, `moe_ffn_combine_reference`,
`moe_ffn_combine_bwd_reference` and the legacy twins); a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import NamedTuple

import torch

from moegan_tpu_torch.ops import _build


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-GELU in float32 (torch nn.GELU default)."""
    xf = x.float()
    return 0.5 * xf * (1.0 + torch.erf(xf * (1.0 / math.sqrt(2.0))))


def gelu_grad(z: torch.Tensor) -> torch.Tensor:
    """d/dz of the erf-GELU in float32: Phi(z) + z * phi(z) (`_gelu_grad`)."""
    zf = z.float()
    return 0.5 * (1.0 + torch.erf(zf * (1.0 / math.sqrt(2.0)))) + zf * (
        torch.exp(-0.5 * zf * zf) / math.sqrt(2.0 * math.pi))


def routing_probs(logits: torch.Tensor, hard: bool) -> torch.Tensor:
    """Shared logits -> probs tail (parity with the JAX `_routing_probs`)."""
    probs = torch.softmax(torch.clamp(logits, -20.0, 20.0), dim=-1)
    probs = torch.clamp(probs, 1e-6, 1.0)
    probs = probs / probs.sum(dim=-1, keepdim=True)
    if hard:
        onehot = (probs == probs.amax(dim=-1, keepdim=True)).to(probs.dtype)
        probs = onehot / onehot.sum(dim=-1, keepdim=True)
    return probs


def router_probs(x, fw, cw_f, text_logits, inv_temp, hard: bool = False):
    """The router part (`_router_probs_fn`, fused_moe.py:579-584): probs [T, E] fp32."""
    logits = ((x.float() @ fw.float()) @ cw_f.float() + text_logits.float()) * inv_temp
    return routing_probs(logits, hard)


def ffn_combine(xf, probs, w1, b1, w2, b2, cd: torch.dtype) -> torch.Tensor:
    """sum_e p_e * (gelu(x @ W1_e + b1_e) @ W2_e + b2_e) in fp32, from fp32 tokens xf;
    the weights and the hidden activation are rounded to `cd` as the kernels round them."""
    h = torch.einsum("tc,ecf->etf", xf, w1.to(cd).float()) + b1.float()[:, None, :]
    h = gelu_exact(h).to(cd).float()
    y = torch.einsum("etf,efc->etc", h, w2.to(cd).float()) + b2.float()[:, None, :]
    return torch.einsum("te,etc->tc", probs, y)


def moe_ffn_reference(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, hard: bool):
    """Plain version (moegan_tpu/ops/fused_moe.py:80-94): returns (out [T, C] in x's dtype, probs [T, E] fp32)."""
    probs = router_probs(x, fw, cw_f, text_logits, inv_temp, hard)
    return ffn_combine(x.float(), probs, w1, b1, w2, b2, x.dtype).to(x.dtype), probs


def moe_ffn_bwd_reference(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, dout):
    """Plain version of the backward kernel under soft routing: (dx_ffn [T, C],
    dp [T, E], dw1 [E, C, F], db1 [E, F], dw2 [E, F, C], db2 [E, C]), all fp32.

    The autograd of the FFN and combine with the routing probs held fixed:
    the router chain's part of dx is not in dx_ffn, and dp is the combine's
    cotangent of the probs.
    """
    probs = router_probs(x, fw, cw_f, text_logits, inv_temp)
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_(True) for t in (x, probs, w1, b1, w2, b2)]
        out = ffn_combine(*leaves, x.dtype)
        return torch.autograd.grad(out, leaves, dout.float())


# --- the legacy three-kernel backward (MOEGAN_PALLAS_MOE_BWD=3): plain twins -----------


def _legacy_recompute(x, fw, cw_f, text_logits, inv_temp, w1, b1):
    """(probs [T, E], z [E, T, F] fp32, h [E, T, F] in x's dtype), as the TPU
    kernels' `_probs_and_expert_tile` recomputes them."""
    cd = x.dtype
    probs = router_probs(x, fw, cw_f, text_logits, inv_temp)
    z = torch.einsum("tc,ecf->etf", x.float(), w1.to(cd).float()) + b1.float()[:, None, :]
    return probs, z, gelu_exact(z).to(cd)


def _legacy_dz(probs, z, w2, dout, cd):
    """dz [E, T, F] fp32 = (bf16(p_e * dout) W2_e^T) * gelu'(z), the product's
    inputs rounded to `cd` as the TPU kernels round them."""
    dy = (probs.t()[:, :, None] * dout.float()[None]).to(cd).float()
    return torch.einsum("etc,efc->etf", dy, w2.to(cd).float()) * gelu_grad(z)


def moe_bwd_dx_reference(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, dout):
    """Plain version of `moe_bwd_dx` (`_bwd_dx_kernel`): (dx_ffn [T, C],
    dp [T, E]) in fp32, dx_ffn = sum_e bf16(dz_e) W1_e^T and
    dp[t, e] = <dout_t, h_e W2_e + b2_e>."""
    cd = x.dtype
    probs, z, h = _legacy_recompute(x, fw, cw_f, text_logits, inv_temp, w1, b1)
    y = torch.einsum("etf,efc->etc", h.float(), w2.to(cd).float()) + b2.float()[:, None, :]
    dp = torch.einsum("tc,etc->te", dout.float(), y)
    dz = _legacy_dz(probs, z, w2, dout, cd)
    return torch.einsum("etf,ecf->tc", dz.to(cd).float(), w1.to(cd).float()), dp


def moe_bwd_dw2_reference(x, fw, cw_f, text_logits, inv_temp, w1, b1, dout):
    """Plain version of `moe_bwd_dw2` (`_bwd_dw2_kernel`): (dW2 [E, F, C],
    db2 [E, C]) in fp32, dW2_e = h_e^T bf16(p_e dout), db2_e = sum_t p_e dout."""
    probs, _, h = _legacy_recompute(x, fw, cw_f, text_logits, inv_temp, w1, b1)
    pd = probs.t()[:, :, None] * dout.float()[None]
    return torch.einsum("etf,etc->efc", h.float(), pd.to(x.dtype).float()), pd.sum(1)


def moe_bwd_dw1_reference(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, dout):
    """Plain version of `moe_bwd_dw1` (`_bwd_dw1_kernel`): (dW1 [E, C, F],
    db1 [E, F]) in fp32, dW1_e = x^T bf16(dz_e), db1_e = sum_t dz_e."""
    cd = x.dtype
    probs, z, _ = _legacy_recompute(x, fw, cw_f, text_logits, inv_temp, w1, b1)
    dz = _legacy_dz(probs, z, w2, dout, cd)
    return torch.einsum("tc,etf->ecf", x.float(), dz.to(cd).float()), dz.sum(1)


def _check_tensors(want: dict) -> None:
    """Raise unless every tensor of `want` (name: (tensor, dtype, shape), x and
    the FFN weights among them) has the kernels' type, shape and layout; a
    None tensor (a weight an entry point does not read) is skipped."""
    x, w1 = want["x"][0], want["w1"][0]
    C = x.shape[1]
    E, _, F = w1.shape
    for name, (t, dtype, shape) in want.items():
        if t is None:
            continue
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if C % 16 or F % 16 or C > MAX_C:
        raise ValueError(f"the kernel takes C and F multiples of 16, C at most {MAX_C}; "
                         f"got C={C}, F={F}")
    if E > 16:
        raise ValueError(f"the kernel takes at most 16 experts, got {E}")


def _ffn_want(x, w1, b1, w2, b2) -> dict:
    T, C = x.shape
    E, _, F = w1.shape
    return dict(x=(x, torch.bfloat16, (T, C)), w1=(w1, torch.bfloat16, (E, C, F)),
                b1=(b1, torch.float32, (E, F)), w2=(w2, torch.bfloat16, (E, F, C)),
                b2=(b2, torch.float32, (E, C)))


def _check_cuda_inputs(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2):
    T = x.shape[0]
    E = w1.shape[0]
    _check_tensors(dict(_ffn_want(x, w1, b1, w2, b2),
                        fw=(fw, torch.bfloat16, (x.shape[1], fw.shape[-1])),
                        cw_f=(cw_f, torch.float32, (fw.shape[-1], E)),
                        text_logits=(text_logits, torch.float32, (T, E)),
                        inv_temp=(inv_temp, torch.float32, (1,))))
    if fw.shape[-1] % 8:
        raise ValueError(f"the kernel takes a router width that is a multiple of 8, got {fw.shape[-1]}")


def fused_moe_ffn(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, hard: bool = False):
    """Fused router + all-expert FFN + combine.

    x [T, C]; fw [C, h]; cw_f [h, E]; text_logits [T, E]; inv_temp a scalar
    (float or 1-element tensor); w1 [E, C, F], b1 [E, F], w2 [E, F, C],
    b2 [E, C]. On CUDA: x, fw, w1, w2 bf16 and the rest float32. Returns
    (out [T, C] in x's dtype, probs [T, E] float32).
    """
    if x.device.type == "cpu":
        return moe_ffn_reference(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, hard)
    if x.device.type != "cuda":
        raise ValueError(f"fused_moe_ffn runs on cpu or cuda tensors, got {x.device}")
    if not torch.is_tensor(inv_temp):
        inv_temp = torch.full((1,), float(inv_temp), dtype=torch.float32, device=x.device)
    inv_temp = inv_temp.reshape(1)
    _check_cuda_inputs(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2)
    T, C = x.shape
    E, _, F = w1.shape
    out = torch.empty((T, C), dtype=x.dtype, device=x.device)
    probs = torch.empty((T, E), dtype=torch.float32, device=x.device)
    if T == 0:
        return out, probs
    plan = kernel_plan(T, C, F, E, x.device)
    # per-split partial sums of the FFN, added by the kernel's second pass
    ws = _split_ws(plan.splits, T, C, x.device)
    lib, fn = _build.entry("fused_moe", "moegan_fused_moe_fwd", _FWD_ARGS)
    rc = fn(
        *_ptrs(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, out, probs, ws),
        T, C, fw.shape[-1], E, F, int(hard), plan.splits,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "fused_moe_fwd")
    fused_moe_ffn.launches += 1
    return out, probs


fused_moe_ffn.launches = 0


# --- launch plans ------------------------------------------------------------------------

MAX_C = 512  # the widest C the kernels are compiled for
_FC = 64  # hidden units per (expert, chunk) step of the token kernels
_WGRAD_TILE = 32  # tokens per step of the weight-gradient kernels; a T range is a multiple


def padded_width(C: int) -> int:
    """The width CP the kernels are compiled for that takes C (columns past C are zero)."""
    for cp in (32, 64, 128, 256, 512):
        if C <= cp:
            return cp
    raise ValueError(f"the kernels take C up to {MAX_C}, got {C}")


def _token_tile(C: int) -> int:
    """Tokens a block of the token kernels (`Tile<CP>::BT` of csrc/moe_tiles.cuh)."""
    return 32 if padded_width(C) == 512 else 64


def _splits(parts: int, most: int, sms: int) -> int:
    """How many ways to split each of `parts` grid rows (at most `most`) so the
    grid holds about two blocks per SM: whole waves, not a wave and a bit."""
    target = 2 * sms
    return 1 if parts >= target else max(1, min(most, target // parts))


class MoePlan(NamedTuple):
    """The forward kernel's launch at one shape."""
    block_t: int  # tokens a block
    splits: int  # blocks sharing a token tile's (expert, chunk) loop


def moe_plan(T: int, C: int, F: int, E: int, sms: int) -> MoePlan:
    """The forward (and combine) kernel's plan at [T, C] tokens, F hidden units
    and E experts on a card with `sms` SMs (T >= 1)."""
    bt = _token_tile(C)
    return MoePlan(bt, _splits(-(-T // bt), E * -(-F // _FC), sms))


class MoeBwdPlan(NamedTuple):
    """The backward's launches at one shape: the token kernel's tile and
    splits, and the weight-gradient kernel's T ranges."""
    block_t: int
    splits: int
    t_ranges: int  # T ranges of the weight-gradient grid
    t_range: int  # tokens a range (the last may be shorter)
    scratch: bool  # dz and p*h through [T, E*F] scratches (C > 64), else recomputed

    def ints(self) -> tuple[int, ...]:
        return self[:4]


def wgrad_grid(C: int, F: int, E: int) -> int:
    """Weight-gradient blocks for each T range: 128 x 128 tiles of dW1^T and
    dW2 [E*F, C] on the scratch route (C > 64), else one a (expert, 64 hidden units)."""
    return 2 * -(-E * F // 128) * -(-C // 128) if padded_width(C) >= 128 else E * -(-F // 64)


def moe_bwd_plan(T: int, C: int, F: int, E: int, sms: int) -> MoeBwdPlan:
    """The backward (and combine backward) kernels' plan (T >= 1)."""
    bt = _token_tile(C)
    grid = wgrad_grid(C, F, E)
    ranges = min(_splits(grid, T, sms), -(-T // _WGRAD_TILE))
    t_range = -(-(-(-T // ranges)) // _WGRAD_TILE) * _WGRAD_TILE
    return MoeBwdPlan(bt, _splits(-(-T // bt), E * -(-F // _FC), sms), -(-T // t_range), t_range,
                      padded_width(C) >= 128)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def kernel_plan(T: int, C: int, F: int, E: int, device) -> MoePlan:
    """`moe_plan` on `device`'s SMs."""
    return moe_plan(T, C, F, E, _sm_count(torch.device(device)))


def bwd_kernel_plan(T: int, C: int, F: int, E: int, device) -> MoeBwdPlan:
    """`moe_bwd_plan` on `device`'s SMs."""
    return moe_bwd_plan(T, C, F, E, _sm_count(torch.device(device)))


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = (_P,) * 12 + (_I,) * 7 + (_P,)
_COMBINE_FWD_ARGS = (_P,) * 8 + (_I,) * 5 + (_P,)
_COMBINE_BWD_ARGS = (_P,) * 21 + (_I,) * 4 + (ctypes.POINTER(ctypes.c_int), _P)


def _split_ws(splits: int, T: int, C: int, device):
    """The forward's [splits, T, C] fp32 partial sums, or None when not split."""
    return torch.empty((splits, T, C), dtype=torch.float32, device=device) if splits > 1 else None


def fused_moe_bwd(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, dout, probs=None):
    """The FFN and combine part of the soft-routing gradient of `fused_moe_ffn`.

    Takes the forward's inputs (as `fused_moe_ffn`, inv_temp a 1-element
    tensor) and the output cotangent dout [T, C] (x's dtype). Returns
    (dx_ffn, dp, dw1, db1, dw2, db2) in float32, as `moe_ffn_bwd_reference`.
    The kernels read the soft routing [T, E]: `probs`, the forward's second
    output, as `FusedMoEFunction` passes it, or else the forward kernel's
    routing computed here. The plain version recomputes it either way.
    """
    if x.device.type == "cpu":
        return moe_ffn_bwd_reference(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, dout)
    if x.device.type != "cuda":
        raise ValueError(f"fused_moe_bwd runs on cpu or cuda tensors, got {x.device}")
    inv_temp = inv_temp.reshape(1)
    _check_cuda_inputs(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2)
    T, C = x.shape
    E, _, F = w1.shape
    dout = dout.to(x.dtype).contiguous()
    if dout.shape != x.shape:
        raise ValueError(f"dout: want {tuple(x.shape)}, got {tuple(dout.shape)}")
    if probs is None:
        probs = fused_moe_ffn(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2)[1]
    _check_tensors(dict(_ffn_want(x, w1, b1, w2, b2), probs=(probs, torch.float32, (T, E))))
    outs = _combine_bwd_run(x, probs, w1, b1, w2, b2, dout)
    fused_moe_bwd.launches += 1
    return outs


fused_moe_bwd.launches = 0


def _ptrs(*tensors):
    return [t.data_ptr() if t is not None else None for t in tensors]


def _bwd_buffers(x, E: int, F: int):
    """(plan, scratch, outputs) of the backward kernels for tokens x [T, C]:
    the bf16 dz and p*h [T, E*F] of the scratch route, and the partial sums that the last pass
    adds in a fixed order (None where the plan does not use them); the fp32
    outputs dx, dp, dw1t [E, F, C] (dW1 transposed), db1, dw2, db2."""
    T, C = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    alloc = torch.empty if T else torch.zeros  # the kernels write every output element
    outs = (alloc((T, C), **f32), alloc((T, E), **f32), alloc((E, F, C), **f32),
            alloc((E, F), **f32), alloc((E, F, C), **f32), alloc((E, C), **f32))
    if T == 0:
        return None, (), outs
    plan = bwd_kernel_plan(T, C, F, E, x.device)
    split, ranges = plan.splits > 1, plan.t_ranges > 1
    # the bias gradients' partials: per token tile (scratch) or per T range
    nbias = -(-T // plan.block_t) if plan.scratch else plan.t_ranges
    bias = plan.scratch or ranges

    scratch = (_maybe(plan.scratch, (T, E * F), x, x.dtype),
               _maybe(plan.scratch, (T, E * F), x, x.dtype),
               _maybe(split, (plan.splits, T, C), x), _maybe(split, (plan.splits, T, E), x),
               _maybe(ranges, (plan.t_ranges, E, F, C), x),
               _maybe(ranges, (plan.t_ranges, E, F, C), x),
               _maybe(bias, (nbias, E, F), x), _maybe(bias, (nbias, E, C), x))
    return plan, scratch, outs


def _maybe(use: bool, shape, like, dtype=torch.float32):
    """An uninitialised buffer on `like`'s device, or None when not `use`d."""
    return torch.empty(shape, dtype=dtype, device=like.device) if use else None


def _bwd_outputs(outs):
    dx, dp, dw1t, db1, dw2, db2 = outs
    return dx, dp, dw1t.transpose(1, 2), db1, dw2, db2


# --- the legacy three-kernel backward: the CUDA entry points ------------------------------


def legacy_plan(which: str, T: int, C: int, F: int, E: int, sms: int) -> MoeBwdPlan:
    """The launches of the legacy entry point `which` ("dx", "dw1" or "dw2") at
    one shape (T >= 1): the token kernel's tile and splits; for dW1 and dW2
    their route and the T ranges of their weight-gradient kernels. The route:
    the gradient recomputed per (expert, 64 hidden units) block up to
    C = 256, or above it bf16 dz (dW1) or h (dW2) through a scratch and a
    tiled product."""
    bt = _token_tile(C)
    splits = _splits(-(-T // bt), E * -(-F // _FC), sms)
    if which == "dx":
        return MoeBwdPlan(bt, splits, 1, T, False)
    scratch = padded_width(C) > 256
    # the product's blocks for each T range: 128 x 128 tiles of dW1^T [E*F, C]
    # or of each expert's dW2 [F, C], or one a (expert, 64 hidden units); a
    # range is whole steps of the kernel
    if not scratch:
        grid = E * -(-F // 64)
    elif which == "dw1":
        grid = -(-E * F // 128) * -(-C // 128)
    else:
        grid = E * -(-F // 128) * -(-C // 128)
    step = _WGRAD_TILE if scratch else _recompute_step(C)
    ranges = min(_splits(grid, T, sms), -(-T // step))
    t_range = -(-(-(-T // ranges)) // step) * step
    return MoeBwdPlan(bt, splits if scratch and which == "dw1" else 1, -(-T // t_range), t_range,
                      scratch)


def _recompute_step(C: int) -> int:
    """Tokens a stage of the recompute kernel of dW1 and dW2 (`recompute_step`
    of csrc/fused_moe_legacy.cu)."""
    return 128 if padded_width(C) == 32 else 32


def legacy_kernel_plan(which: str, T: int, C: int, F: int, E: int, device) -> MoeBwdPlan:
    """`legacy_plan` on `device`'s SMs."""
    return legacy_plan(which, T, C, F, E, _sm_count(torch.device(device)))


_LEGACY_ARGS = (_P,) * 11 + (_I,) * 4 + (ctypes.POINTER(ctypes.c_int), _P)


def _legacy_inputs(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, dout):
    """Check the inputs of a legacy entry point on CUDA (w2 and b2 None where it
    reads none); returns inv_temp as [1] and dout in x's dtype."""
    inv_temp = inv_temp.reshape(1)
    _check_cuda_inputs(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2)
    dout = dout.to(x.dtype).contiguous()
    if dout.shape != x.shape:
        raise ValueError(f"dout: want {tuple(x.shape)}, got {tuple(dout.shape)}")
    return inv_temp, dout


def _legacy_probs(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, probs):
    """The soft routing [T, E] that the legacy entry points read: `probs` (the
    forward's, checked) or, when None, the forward kernel's, as `fused_moe_bwd`
    takes it (w2 None for dW2, which has none)."""
    T, E = text_logits.shape
    if probs is None:
        # the routing reads neither the output weights nor the output bias
        C, F = x.shape[1], w1.shape[2]
        if w2 is None:
            w2 = torch.zeros((E, F, C), dtype=w1.dtype, device=x.device)
        b2 = torch.zeros((E, C), dtype=torch.float32, device=x.device)
        probs = fused_moe_ffn(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2)[1]
    _check_tensors(dict(x=(x, x.dtype, x.shape), w1=(w1, w1.dtype, w1.shape),
                        probs=(probs, torch.float32, (T, E))))
    return probs


def _legacy_launch(name: str, plan, ptr_tensors, T, C, E, F, device) -> None:
    lib, fn = _build.entry("fused_moe_legacy", f"moegan_moe_bwd_{name}", _LEGACY_ARGS)
    ints = [int(v) for v in plan]
    rc = fn(*_ptrs(*ptr_tensors), T, C, E, F, (ctypes.c_int * len(ints))(*ints),
            torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, rc, f"moe_bwd_{name}")


def moe_bwd_dx(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, dout, probs=None):
    """(dx_ffn [T, C], dp [T, E]) in fp32 through the kernel that replaces
    `_bwd_dx_kernel`, as `moe_bwd_dx_reference`. Inputs as `fused_moe_bwd`:
    the kernel reads the soft routing `probs` [T, E] (the forward's, as
    `FusedMoEFunction` passes it) or, when None, the forward kernel's routing
    computed here. The plain version recomputes it either way."""
    if x.device.type == "cpu":
        return moe_bwd_dx_reference(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, dout)
    if x.device.type != "cuda":
        raise ValueError(f"moe_bwd_dx runs on cpu or cuda tensors, got {x.device}")
    inv_temp, dout = _legacy_inputs(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, dout)
    T, C = x.shape
    E, _, F = w1.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    if T == 0:
        return torch.zeros((T, C), **f32), torch.zeros((T, E), **f32)
    dx, dp = torch.empty((T, C), **f32), torch.empty((T, E), **f32)
    probs = _legacy_probs(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, probs)
    plan = legacy_plan("dx", T, C, F, E, _sm_count(x.device))
    split = plan.splits > 1
    ws_dx, ws_dp = _maybe(split, (plan.splits, T, C), x), _maybe(split, (plan.splits, T, E), x)
    _legacy_launch("dx", plan[:2], (x, probs, w1, b1, w2, b2, dout, ws_dx, ws_dp, dx, dp),
                   T, C, E, F, x.device)
    moe_bwd_dx.launches += 1
    return dx, dp


moe_bwd_dx.launches = 0


def moe_bwd_dw2(x, fw, cw_f, text_logits, inv_temp, w1, b1, dout, probs=None):
    """(dW2 [E, F, C], db2 [E, C]) in fp32 through the kernel that replaces
    `_bwd_dw2_kernel`, as `moe_bwd_dw2_reference`. `probs` as `moe_bwd_dx`;
    the route by width (`legacy_plan`)."""
    if x.device.type == "cpu":
        return moe_bwd_dw2_reference(x, fw, cw_f, text_logits, inv_temp, w1, b1, dout)
    if x.device.type != "cuda":
        raise ValueError(f"moe_bwd_dw2 runs on cpu or cuda tensors, got {x.device}")
    inv_temp, dout = _legacy_inputs(x, fw, cw_f, text_logits, inv_temp, w1, b1, None, None, dout)
    T, C = x.shape
    E, _, F = w1.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    if T == 0:
        return torch.zeros((E, F, C), **f32), torch.zeros((E, C), **f32)
    dw2, db2 = torch.empty((E, F, C), **f32), torch.empty((E, C), **f32)
    probs = _legacy_probs(x, fw, cw_f, text_logits, inv_temp, w1, b1, None, probs)
    plan = legacy_plan("dw2", T, C, F, E, _sm_count(x.device))
    ranges = plan.t_ranges > 1
    h = _maybe(plan.scratch, (E, T, F), x, x.dtype)
    dy = _maybe(plan.scratch, (E, T, C), x, x.dtype)
    ws_db2 = _maybe(ranges, (plan.t_ranges, E * C), x)
    ws_w = _maybe(ranges, (plan.t_ranges, E * F * C), x)
    _legacy_launch("dw2", plan, (x, probs, w1, b1, dout, h, dy, ws_db2, ws_w, dw2, db2),
                   T, C, E, F, x.device)
    moe_bwd_dw2.launches += 1
    return dw2, db2


moe_bwd_dw2.launches = 0


def moe_bwd_dw1(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, dout, probs=None):
    """(dW1 [E, C, F], db1 [E, F]) in fp32 through the kernels that replace
    `_bwd_dw1_kernel`, as `moe_bwd_dw1_reference`. `probs` as `moe_bwd_dx`;
    the route by width (`legacy_plan`)."""
    if x.device.type == "cpu":
        return moe_bwd_dw1_reference(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, dout)
    if x.device.type != "cuda":
        raise ValueError(f"moe_bwd_dw1 runs on cpu or cuda tensors, got {x.device}")
    inv_temp, dout = _legacy_inputs(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, None, dout)
    T, C = x.shape
    E, _, F = w1.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    if T == 0:
        return torch.zeros((E, C, F), **f32), torch.zeros((E, F), **f32)
    dw1t, db1 = torch.empty((E, F, C), **f32), torch.empty((E, F), **f32)
    probs = _legacy_probs(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, probs)
    plan = legacy_plan("dw1", T, C, F, E, _sm_count(x.device))
    # the db1 partials: one row a token tile (scratch route) or a T range
    nbias = -(-T // plan.block_t) if plan.scratch else plan.t_ranges
    dz = _maybe(plan.scratch, (T, E * F), x, x.dtype)
    ws_db1 = _maybe(nbias > 1, (nbias, E * F), x)
    ws_w = _maybe(plan.t_ranges > 1, (plan.t_ranges, E * F * C), x)
    _legacy_launch("dw1", plan, (x, probs, w1, b1, w2, dout, dz, ws_db1, ws_w, dw1t, db1),
                   T, C, E, F, x.device)
    moe_bwd_dw1.launches += 1
    return dw1t.transpose(1, 2), db1


moe_bwd_dw1.launches = 0


def moe_bwd_mode() -> str:
    """`MOEGAN_PALLAS_MOE_BWD` at call time: "1" (the default, the backward
    kernel), "3" (the legacy three entry points) or "0" (plain recompute)."""
    mode = os.environ.get("MOEGAN_PALLAS_MOE_BWD", "1")
    if mode not in ("0", "1", "3"):
        raise ValueError(f"MOEGAN_PALLAS_MOE_BWD={mode!r}: the port reads '0', '1' or '3'")
    return mode


def _recompute_grads(fn, inputs, cotangents):
    """The gradients of `fn(*inputs)` for `cotangents` by autograd (mode "0")."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, cotangents)


class FusedMoEFunction(torch.autograd.Function):
    """Differentiable `fused_moe_ffn` under soft routing -> (out, probs).

    inv_temp is a 1-element float32 tensor, so that its gradient reaches the
    router's temperature.
    """

    @staticmethod
    def forward(ctx, x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2):
        out, probs = fused_moe_ffn(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, hard=False)
        # the inputs, and the routing for the backward kernel to read
        ctx.save_for_backward(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, probs)
        return out, probs

    @staticmethod
    def backward(ctx, dout, dprobs):
        *saved, probs = ctx.saved_tensors
        x, fw, cw_f, tl, it, w1, b1, w2, b2 = saved
        mode = moe_bwd_mode()
        if mode == "0":
            return _recompute_grads(lambda *a: moe_ffn_reference(*a, hard=False), saved,
                                    (dout, dprobs))
        if mode == "3":
            dx_ffn, dp = moe_bwd_dx(x, fw, cw_f, tl, it, w1, b1, w2, b2, dout, probs=probs)
            dw2, db2 = moe_bwd_dw2(x, fw, cw_f, tl, it, w1, b1, dout, probs=probs)
            dw1, db1 = moe_bwd_dw1(x, fw, cw_f, tl, it, w1, b1, w2, dout, probs=probs)
        else:
            dx_ffn, dp, dw1, db1, dw2, db2 = fused_moe_bwd(x, fw, cw_f, tl, it, w1, b1, w2, b2,
                                                           dout, probs=probs)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (x, fw, cw_f, tl, it)]
            probs = router_probs(*leaves)
            dx_r, dfw, dcw, dtl, dit = torch.autograd.grad(probs, leaves, dprobs.float() + dp)
        return ((dx_ffn + dx_r.float()).to(x.dtype), dfw, dcw, dtl, dit,
                dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype))


# --- the expert-parallel combine (probs as an input) ------------------------------------


def moe_ffn_combine_reference(x, probs, w1, b1, w2, b2):
    """Plain version (moegan_tpu/ops/fused_moe.py:1034-1043): sum_e probs[:, e] *
    (gelu(x @ W1_e + b1_e) @ W2_e + b2_e) over the E experts given, in x's dtype."""
    return ffn_combine(x.float(), probs.float(), w1, b1, w2, b2, x.dtype).to(x.dtype)


def moe_ffn_combine_bwd_reference(x, probs, w1, b1, w2, b2, dout):
    """Plain version of the combine's backward: (dx [T, C], dp [T, E], dw1, db1,
    dw2, db2), all fp32, the autograd of `ffn_combine` for the cotangent dout."""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_(True) for t in (x, probs, w1, b1, w2, b2)]
        out = ffn_combine(*leaves, x.dtype)
        return torch.autograd.grad(out, leaves, dout.float())


def _check_combine_inputs(x, probs, w1, b1, w2, b2):
    _check_tensors(dict(_ffn_want(x, w1, b1, w2, b2),
                        probs=(probs, torch.float32, (x.shape[0], w1.shape[0]))))


def moe_ffn_combine(x, probs, w1, b1, w2, b2):
    """sum_e probs[:, e] * FFN_e(x) over the given (local) experts.

    x [T, C]; probs [T, E] (soft, or one-hot at eval); w1 [E, C, F], b1
    [E, F], w2 [E, F, C], b2 [E, C]. On CUDA: x, w1, w2 bf16, the rest
    float32. Returns out [T, C] in x's dtype: a rank's partial sum, which
    the caller adds over the expert group.
    """
    if x.device.type == "cpu":
        return moe_ffn_combine_reference(x, probs, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"moe_ffn_combine runs on cpu or cuda tensors, got {x.device}")
    _check_combine_inputs(x, probs, w1, b1, w2, b2)
    T, C = x.shape
    E, _, F = w1.shape
    out = torch.empty((T, C), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    plan = kernel_plan(T, C, F, E, x.device)
    ws = _split_ws(plan.splits, T, C, x.device)
    lib, fn = _build.entry("fused_moe", "moegan_moe_combine_fwd", _COMBINE_FWD_ARGS)
    rc = fn(
        *_ptrs(x, probs, w1, b1, w2, b2, out, ws), T, C, E, F, plan.splits,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "moe_combine_fwd")
    moe_ffn_combine.launches += 1
    return out


moe_ffn_combine.launches = 0


def moe_ffn_combine_bwd(x, probs, w1, b1, w2, b2, dout):
    """The gradient of `moe_ffn_combine` for the output cotangent dout [T, C]:
    (dx, dp, dw1, db1, dw2, db2) in float32, as `moe_ffn_combine_bwd_reference`."""
    if x.device.type == "cpu":
        return moe_ffn_combine_bwd_reference(x, probs, w1, b1, w2, b2, dout)
    if x.device.type != "cuda":
        raise ValueError(f"moe_ffn_combine_bwd runs on cpu or cuda tensors, got {x.device}")
    _check_combine_inputs(x, probs, w1, b1, w2, b2)
    dout = dout.to(x.dtype).contiguous()
    if dout.shape != x.shape:
        raise ValueError(f"dout: want {tuple(x.shape)}, got {tuple(dout.shape)}")
    outs = _combine_bwd_run(x, probs, w1, b1, w2, b2, dout)
    moe_ffn_combine_bwd.launches += 1
    return outs


def _combine_bwd_run(x, probs, w1, b1, w2, b2, dout):
    """The backward kernels with the routing probs given (checked CUDA inputs)."""
    T, C = x.shape
    E, _, F = w1.shape
    plan, scratch, outs = _bwd_buffers(x, E, F)
    if T == 0:
        return _bwd_outputs(outs)
    lib, fn = _build.entry("fused_moe_bwd", "moegan_moe_combine_bwd", _COMBINE_BWD_ARGS)
    rc = fn(
        *_ptrs(x, probs, w1, b1, w2, b2, dout, *scratch, *outs),
        T, C, E, F, (ctypes.c_int * 4)(*plan.ints()),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "moe_combine_bwd")
    return _bwd_outputs(outs)


moe_ffn_combine_bwd.launches = 0


class MoECombineFunction(torch.autograd.Function):
    """Differentiable `moe_ffn_combine`: the forward kernel, saving only its
    inputs (as `_combine_vjp_fwd`), and the backward kernel."""

    @staticmethod
    def forward(ctx, x, probs, w1, b1, w2, b2):
        ctx.save_for_backward(x, probs, w1, b1, w2, b2)
        return moe_ffn_combine(x, probs, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dout):
        x, probs, w1, b1, w2, b2 = ctx.saved_tensors
        if moe_bwd_mode() == "0":
            return _recompute_grads(moe_ffn_combine_reference, ctx.saved_tensors, (dout,))
        dx, dp, dw1, db1, dw2, db2 = moe_ffn_combine_bwd(x, probs, w1, b1, w2, b2, dout)
        return (dx.to(x.dtype), dp.to(probs.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(b2.dtype))
