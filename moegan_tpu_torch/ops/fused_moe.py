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
training path): the forward kernel saves only its inputs, as `_fused_fwd`
does; the backward kernel gives the FFN and combine part of the gradient,
and the router chain's part is plain autograd over a recompute of
`router_probs`, fed the probs cotangent plus the combine's, as the JAX
package leaves it to XLA (`_fused_moe_bwd_v2`).

The expert-parallel combine (`moe_ffn_combine`, `MoECombineFunction`)
replaces the four probs-as-input TPU kernels `_combine_kernel`,
`_combine_kernel_v2` (forward) and `_combine_bwd_kernel`,
`_combine_bwd_kernel_v2` (backward): the routing probs are an input (a
rank's local expert columns) and there is no router chain. The forward and
backward kernels above serve it, instantiated without their router
(`moegan_moe_combine_fwd`, `moegan_moe_combine_bwd`).

Dispatch: a CPU tensor takes the plain version (`moe_ffn_reference`,
`moe_ffn_bwd_reference`, `moe_ffn_combine_reference`,
`moe_ffn_combine_bwd_reference`); a CUDA tensor launches the kernel or
raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from moegan_tpu_torch.ops import _build


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-GELU in float32 (torch nn.GELU default)."""
    xf = x.float()
    return 0.5 * xf * (1.0 + torch.erf(xf * (1.0 / math.sqrt(2.0))))


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


def _check_tensors(want: dict) -> None:
    """Raise unless every tensor of `want` (name: (tensor, dtype, shape), x and
    the FFN weights among them) has the kernels' type, shape and layout."""
    x, w1 = want["x"][0], want["w1"][0]
    C = x.shape[1]
    E, _, F = w1.shape
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if C % 16 or F % 16:
        raise ValueError(f"the kernel takes C and F multiples of 16, got C={C}, F={F}")
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
    _, _, splits = kernel_plan(T, C, F, E, x.device)
    # per-split partial sums of the FFN, added by the kernel's second pass
    ws = torch.empty((splits, T, C), dtype=torch.float32, device=x.device) if splits > 1 else None
    lib = _build.load("fused_moe")
    fn = lib.moegan_fused_moe_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    rc = fn(
        x.data_ptr(), fw.data_ptr(), cw_f.data_ptr(), text_logits.data_ptr(),
        inv_temp.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), probs.data_ptr(), ws.data_ptr() if ws is not None else None,
        T, C, fw.shape[-1], E, F, int(hard), splits,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "fused_moe_fwd")
    fused_moe_ffn.launches += 1
    return out, probs


fused_moe_ffn.launches = 0


def kernel_plan(T: int, C: int, F: int, E: int, device) -> tuple[int, int, int]:
    """(token tile, F-chunk, splits) of the CUDA kernel at these widths on `device`."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _plan(T, C, F, E, sms)


@functools.lru_cache(maxsize=None)
def _plan(T: int, C: int, F: int, E: int, sms: int) -> tuple[int, int, int]:
    lib = _build.load("fused_moe")
    bt, fc, splits = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    fn = lib.moegan_fused_moe_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
    if not fn(T, C, F, E, sms, ctypes.byref(bt), ctypes.byref(fc), ctypes.byref(splits)):
        raise ValueError(f"no tile fits shared memory at C={C}, F={F}, E={E}")
    return bt.value, fc.value, splits.value


def fused_moe_bwd(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, dout):
    """The FFN and combine part of the soft-routing gradient of `fused_moe_ffn`.

    Takes the forward's inputs (as `fused_moe_ffn`, inv_temp a 1-element
    tensor) and the output cotangent dout [T, C] (x's dtype). Returns
    (dx_ffn, dp, dw1, db1, dw2, db2) in float32, as `moe_ffn_bwd_reference`.
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
    plan, scratch, outs = _bwd_buffers(x, E, F)
    lib = _build.load("fused_moe_bwd")
    fn = lib.moegan_fused_moe_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 24 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ]
    rc = fn(
        *_ptrs(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, dout, *scratch, *outs),
        T, C, fw.shape[-1], E, F, (ctypes.c_int * 5)(*plan),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "fused_moe_bwd")
    fused_moe_bwd.launches += 1
    return _bwd_outputs(outs, C, E, F)


fused_moe_bwd.launches = 0


def _ptrs(*tensors):
    return [t.data_ptr() if t is not None else None for t in tensors]


def _bwd_buffers(x, E: int, F: int):
    """(plan, scratch, outputs) of the backward kernels for tokens x [T, C]:
    the bf16 scratch of dz and p*h for the weight-gradient products and the
    partial sums that the later passes add in a fixed order; the fp32
    outputs dx, dp, dw1s [C, E*F], db1, dw2, db2."""
    T, C = x.shape
    plan = bwd_kernel_plan(T, C, F, E, x.device)
    bt, _, splits, ws1, ws2 = plan
    ntiles = -(-T // bt)
    f32 = dict(dtype=torch.float32, device=x.device)
    bf = dict(dtype=x.dtype, device=x.device)
    scratch = (torch.empty((T, E * F), **bf), torch.empty((T, E * F), **bf),
               torch.empty((splits, T, C), **f32), torch.empty((splits, T, E), **f32),
               torch.empty((ntiles, E * F), **f32), torch.empty((ntiles, E * C), **f32),
               torch.empty((ws1, C, E * F), **f32) if ws1 > 1 else None,
               torch.empty((ws2, E * F, C), **f32) if ws2 > 1 else None)
    outs = (torch.empty((T, C), **f32), torch.empty((T, E), **f32),
            torch.empty((C, E * F), **f32), torch.empty((E, F), **f32),
            torch.empty((E, F, C), **f32), torch.empty((E, C), **f32))
    return plan, scratch, outs


def _bwd_outputs(outs, C: int, E: int, F: int):
    dx, dp, dw1s, db1, dw2, db2 = outs
    return dx, dp, dw1s.reshape(C, E, F).permute(1, 0, 2), db1, dw2, db2


def bwd_kernel_plan(T: int, C: int, F: int, E: int, device) -> tuple[int, int, int, int, int]:
    """(token tile, F-chunk, splits, dW1 T-splits, dW2 T-splits) of the backward kernel."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _bwd_plan(T, C, F, E, sms)


@functools.lru_cache(maxsize=None)
def _bwd_plan(T: int, C: int, F: int, E: int, sms: int) -> tuple[int, int, int, int, int]:
    lib = _build.load("fused_moe_bwd")
    plan = (ctypes.c_int * 5)()
    fn = lib.moegan_fused_moe_bwd_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    if not fn(T, C, F, E, sms, plan):
        raise ValueError(f"no tile fits shared memory at C={C}, F={F}, E={E}")
    return tuple(plan)


class FusedMoEFunction(torch.autograd.Function):
    """Differentiable `fused_moe_ffn` under soft routing -> (out, probs).

    inv_temp is a 1-element float32 tensor, so that its gradient reaches the
    router's temperature.
    """

    @staticmethod
    def forward(ctx, x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2):
        ctx.save_for_backward(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2)
        return fused_moe_ffn(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, hard=False)

    @staticmethod
    def backward(ctx, dout, dprobs):
        x, fw, cw_f, tl, it, w1, b1, w2, b2 = ctx.saved_tensors
        dx_ffn, dp, dw1, db1, dw2, db2 = fused_moe_bwd(x, fw, cw_f, tl, it, w1, b1, w2, b2, dout)
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
    _, _, splits = kernel_plan(T, C, F, E, x.device)
    ws = torch.empty((splits, T, C), dtype=torch.float32, device=x.device) if splits > 1 else None
    lib = _build.load("fused_moe")
    fn = lib.moegan_moe_combine_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    rc = fn(
        x.data_ptr(), probs.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), ws.data_ptr() if ws is not None else None,
        T, C, E, F, splits, torch.cuda.current_stream(x.device).cuda_stream,
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
    T, C = x.shape
    E, _, F = w1.shape
    dout = dout.to(x.dtype).contiguous()
    if dout.shape != x.shape:
        raise ValueError(f"dout: want {tuple(x.shape)}, got {tuple(dout.shape)}")
    plan, scratch, outs = _bwd_buffers(x, E, F)
    lib = _build.load("fused_moe_bwd")
    fn = lib.moegan_moe_combine_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ]
    rc = fn(
        *_ptrs(x, probs, w1, b1, w2, b2, dout, *scratch, *outs),
        T, C, E, F, (ctypes.c_int * 5)(*plan), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "moe_combine_bwd")
    moe_ffn_combine_bwd.launches += 1
    return _bwd_outputs(outs, C, E, F)


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
        dx, dp, dw1, db1, dw2, db2 = moe_ffn_combine_bwd(x, probs, w1, b1, w2, b2, dout)
        return (dx.to(x.dtype), dp.to(probs.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(b2.dtype))
