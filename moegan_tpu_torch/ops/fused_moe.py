"""Fused Bayesian-MoE forward: CUDA kernel wrapper and its plain PyTorch version.

Counterpart of moegan_tpu/ops/fused_moe.py, forward only. One CUDA kernel,
`csrc/fused_moe.cu`, replaces both TPU kernels `_fused_moe_kernel` (v1) and
`_fused_moe_kernel_v2`: they compute the same function, and the VMEM gate
that chose between them on the TPU has no meaning on Hopper.

The function: router logits ((x @ fw) @ cw_f + text_logits) * inv_temp,
clipped to +-20; softmax, floor 1e-6, renorm; under `hard`, the multi-hot
of the maxima renormalised (a tie splits evenly, `_routing_probs`,
fused_moe.py:67-77); then sum_e p_e * (gelu_erf(x @ W1_e + b1_e) @ W2_e +
b2_e), with the hidden activation rounded to x's dtype.

Dispatch: a CPU tensor takes `moe_ffn_reference`; a CUDA tensor launches
the kernel or raises. There is no fallback between the two.
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


def moe_ffn_reference(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2, hard: bool):
    """Plain version (moegan_tpu/ops/fused_moe.py:80-94): returns (out [T, C] in x's dtype, probs [T, E] fp32)."""
    xf = x.float()
    logits = ((xf @ fw.float()) @ cw_f.float() + text_logits.float()) * inv_temp
    probs = routing_probs(logits, hard)
    cd = x.dtype
    h = torch.einsum("tc,ecf->etf", xf, w1.to(cd).float()) + b1.float()[:, None, :]
    h = gelu_exact(h).to(cd).float()
    y = torch.einsum("etf,efc->etc", h, w2.to(cd).float()) + b2.float()[:, None, :]
    out = torch.einsum("te,etc->tc", probs, y)
    return out.to(cd), probs


def _check_cuda_inputs(x, fw, cw_f, text_logits, inv_temp, w1, b1, w2, b2):
    T, C = x.shape
    E, _, F = w1.shape
    want = {
        "x": (x, torch.bfloat16, (T, C)),
        "fw": (fw, torch.bfloat16, (C, fw.shape[-1])),
        "cw_f": (cw_f, torch.float32, (fw.shape[-1], E)),
        "text_logits": (text_logits, torch.float32, (T, E)),
        "inv_temp": (inv_temp, torch.float32, (1,)),
        "w1": (w1, torch.bfloat16, (E, C, F)),
        "b1": (b1, torch.float32, (E, F)),
        "w2": (w2, torch.bfloat16, (E, F, C)),
        "b2": (b2, torch.float32, (E, C)),
    }
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
