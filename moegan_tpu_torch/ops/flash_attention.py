"""Flash attention: CUDA kernel wrappers, their plain PyTorch versions, and
the autograd function that joins the forward and the backward.

Counterpart of moegan_tpu/ops/flash_attention.py: the TPU kernel
`_fwd_kernel` (launched by `_flash_forward`) becomes
`csrc/flash_attention.cu`, and `_bwd_fused_kernel` (launched by
`_flash_backward`) becomes `csrc/flash_attention_bwd.cu`. The math is the
TPU kernel's default: q
pre-scaled by log2(e)/sqrt(D) in the input dtype (the scale itself rounded
to that dtype), base-2 softmax, and the denominator summed from the same
p, rounded to v's dtype, that multiplies v. The optional lse is the base-2
logsumexp per row, [B, H, T] float32.

`FlashAttentionFunction` is the differentiable form: its forward launches
the lse variant and saves q, k, v, o and lse; its backward launches the
backward kernel. A forward without grad (the D phase's fake) calls
`flash_attention` directly and writes no lse.

Dispatch: a CPU tensor takes the plain version (`flash_attention_reference`,
`flash_attention_bwd_reference`); a CUDA tensor launches the kernel or
raises. There is no fallback between the two. `flash_plan` picks the
forward's q tile from the shape and the card's SM count.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from moegan_tpu_torch.ops import _build

LOG2E = math.log2(math.e)
LN2 = math.log(2.0)


def flash_plan(B: int, H: int, T: int, D: int, sms: int) -> int:
    """Query rows a block of the flash forward owns, for [B, T, H, D] inputs
    on a card with `sms` streaming multiprocessors.

    Every block runs 4 warps (8 measured slower on the H100: fewer registers
    a thread, fewer blocks an SM), and each warp owns 16 or 32 query rows:
    32 (a 128-row tile) share each K and V fragment between two row strips,
    and are taken for D <= 32 when the grid of 128-row tiles still has a
    block for every SM; otherwise 16 (a 64-row tile) keep more blocks in
    flight, as for the lone served request at res 64 (B*H = 4). The
    backward has no choice to make: its blocks own 64 keys (dk/dv) or 64
    q rows (dq). Each kernel sizes its own shared memory.
    """
    return 128 if D <= 32 and -(-T // 128) * B * H >= sms else 64


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _q_scale(D: int, dtype: torch.dtype) -> float:
    """log2(e)/sqrt(D), rounded to `dtype` as the TPU caller rounds it."""
    return float(torch.tensor(LOG2E / math.sqrt(D), dtype=torch.float32).to(dtype).float())


def flash_attention_reference(q, k, v, with_lse: bool = False):
    """Plain version of the kernel: q, k, v [B, T, H, D] -> o [B, T, H, D] (and lse [B, H, T])."""
    D = q.shape[-1]
    qs = (q.float() * _q_scale(D, q.dtype)).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m).to(v.dtype).float()
    l = p.sum(dim=-1, keepdim=True)  # [B, H, T, 1]
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l.permute(0, 2, 1, 3)
    o = o.to(q.dtype)
    if with_lse:
        return o, (m + torch.log2(l)).squeeze(-1)
    return o


def flash_attention_bwd_reference(q, k, v, do):
    """Plain version of the backward kernel: (dq, dk, dv), the autograd of
    `flash_attention_reference` at (q, k, v) for the cotangent do."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = flash_attention_reference(*leaves)
        return torch.autograd.grad(o, leaves, do.to(o.dtype))


def _check_cuda_inputs(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one [B, T, H, D] shape; got {q.shape}, {k.shape}, {v.shape}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 on CUDA, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride on its last axis")
        if t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3)):
            raise ValueError(f"{name} must be 16-byte aligned with strides that are multiples of 8")
    D = q.shape[-1]
    if D % 16 or D > 64:
        raise ValueError(f"the kernel takes head_dim a multiple of 16 up to 64, got {D}")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError("B*H must be at most 65535 (grid y dimension)")


def _strides(q, k, v):
    """The (b, t, h) strides of q, k, v as the C entry points take them."""
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    return (ctypes.c_longlong * 9)(*qs[:3], *ks[:3], *vs[:3])


_FWD_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_float, ctypes.c_void_p)
_BWD_ARGS = (ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 4 + (
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_void_p)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, with_lse: bool = False):
    """Non-causal softmax(q k^T / sqrt(D)) v over [B, T, H, D] tensors.

    Returns o (bf16 on CUDA), or (o, lse) with `with_lse`. q, k, v may be
    strided views (e.g. last-axis slices of a fused QKV projection).
    """
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    _check_cuda_inputs(q, k, v)
    B, T, H, D = q.shape
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if with_lse else None
    if T == 0 or B * H == 0:
        return (o, lse) if with_lse else o
    block_q = flash_plan(B, H, T, D, _sm_count(q.device))
    lib, fn = _build.entry("flash_attention", "moegan_flash_attention_fwd", _FWD_ARGS)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        B, T, H, D, _strides(q, k, v), block_q, _q_scale(D, q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_attention_fwd")
    flash_attention.launches += 1
    return (o, lse) if with_lse else o


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv) of `flash_attention` at (q, k, v) for the cotangent do.

    o and lse are the forward's outputs (`with_lse=True`). On CUDA all of q,
    k, v, o, do are bf16 [B, T, H, D] (q, k, v may be strided views, as in
    the forward) and dq, dk, dv come back contiguous in bf16.
    """
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, do)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda tensors, got {q.device}")
    _check_cuda_inputs(q, k, v)
    B, T, H, D = q.shape
    o, do = o.contiguous(), do.to(q.dtype).contiguous()
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name}: want {q.dtype} {tuple(q.shape)} on {q.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if lse.shape != (B, H, T) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse: want contiguous float32 {(B, H, T)}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    dq, dk, dv, qp = (torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
                      for _ in range(4))
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    scale = _q_scale(D, q.dtype)
    lib, fn = _build.entry("flash_attention_bwd", "moegan_flash_attention_bwd", _BWD_ARGS)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), qp.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, T, H, D, _strides(q, k, v), scale, scale * LN2, LN2,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable `flash_attention`: q, k, v [B, T, H, D] -> o."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return flash_attention_bwd(*ctx.saved_tensors, do)
