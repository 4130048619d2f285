"""Self/cross attention block with a SparseMoE FFN (counterpart of
moegan_tpu/core/attention.py).

proj_in (1x1 modulated conv) -> LayerNorm + self-attention -> text
projection + cross-attention against the length-1 text sequence ->
LayerNorm + SparseMoE -> proj_out. Residuals bypass the norms.

Self-attention uses one fused [D, 3D] QKV product sliced q|k|v on the last
axis. For T >= 256 it runs through the flash-attention kernels on the card:
`FlashAttentionFunction` (forward with lse, then the backward kernel) when
grad is enabled, `flash_attention` (forward only, no lse) when not. Below
that, plain attention with fp32 logits, probs cast to the compute dtype and
PV accumulated in fp32. Cross-attention over one text
token is exactly the value projection broadcast over every query
(`MOEGAN_CROSS_T1`, on by default in the JAX package), so norm2, wq/wk and
bq/bk are kept as parameters for checkpoint parity but not computed. The
norms are `FusedLayerNorm`, as in the JAX block: the LayerNorm kernels
under `MOEGAN_FUSED_LN=1`, the plain version otherwise.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from moegan_tpu_torch.core import inits
from moegan_tpu_torch.core.modconv import ModulatedConv
from moegan_tpu_torch.core.moe import SparseMoE
from moegan_tpu_torch.ops.flash_attention import FlashAttentionFunction, flash_attention
from moegan_tpu_torch.ops.layernorm import FusedLayerNorm

FLASH_MIN_T = 256


class MultiHeadAttention(nn.Module):
    """torch.nn.MultiheadAttention-equivalent with the JAX package's [in, out] weights."""

    def __init__(self, dim: int, heads: int, compute_dtype=torch.bfloat16,
                 gen: torch.Generator | None = None):
        super().__init__()
        gen = inits.default_generator(gen)
        self.dim, self.heads = dim, heads
        self.compute_dtype = compute_dtype
        for name in ("wq", "wk", "wv"):
            setattr(self, name, nn.Parameter(inits.xavier_uniform((dim, dim), gen)))
        for name in ("bq", "bk", "bv"):
            setattr(self, name, nn.Parameter(torch.zeros(dim)))
        self.wo = nn.Parameter(inits.torch_linear_kernel((dim, dim), gen))
        self.bo = nn.Parameter(torch.zeros(dim))

    def cross_single(self, q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """Attention over one key/value token: the value projection, broadcast over q's T."""
        cd = self.compute_dtype
        vh = kv.to(cd) @ self.wv.to(cd) + self.bv.to(cd)  # [B, 1, D]
        out1 = vh @ self.wo.to(cd) + self.bo.to(cd)
        return out1.expand(q.shape[0], q.shape[1], self.dim).to(q.dtype)

    def self_attention(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, T, D] -> [B, T, D]."""
        cd = self.compute_dtype
        B, T, D = x.shape
        H, hd = self.heads, D // self.heads
        wqkv = torch.cat([self.wq, self.wk, self.wv], dim=1).to(cd)
        bqkv = torch.cat([self.bq, self.bk, self.bv]).to(cd)
        y = x.to(cd) @ wqkv + bqkv
        qh = y[..., :D].unflatten(-1, (H, hd))
        kh = y[..., D:2 * D].unflatten(-1, (H, hd))
        vh = y[..., 2 * D:].unflatten(-1, (H, hd))
        if T >= FLASH_MIN_T and torch.is_grad_enabled():
            out = FlashAttentionFunction.apply(qh, kh, vh)
        elif T >= FLASH_MIN_T:
            out = flash_attention(qh, kh, vh)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * (1.0 / math.sqrt(hd))
            probs = torch.softmax(logits, dim=-1).to(cd)
            out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), vh.float())
        out = out.reshape(B, T, D).to(cd)
        return (out @ self.wo.to(cd) + self.bo.to(cd)).to(x.dtype)


class AttentionBlock(nn.Module):
    def __init__(self, dim: int, text_dim: int = 512, latent_dim: int = 512, heads: int = 8,
                 num_experts: int = 4, router_hidden: int = 128,
                 compute_dtype=torch.bfloat16, gen: torch.Generator | None = None):
        super().__init__()
        gen = inits.default_generator(gen)
        cd = compute_dtype
        self.proj_in = ModulatedConv(dim, dim, 1, latent_dim, compute_dtype=cd, gen=gen)
        self.norm1 = FusedLayerNorm(dim)
        self.self_attn = MultiHeadAttention(dim, heads, cd, gen)
        self.text_proj = nn.Linear(text_dim, dim)
        with torch.no_grad():
            self.text_proj.weight.copy_(inits.torch_linear_kernel((text_dim, dim), gen).t())
            self.text_proj.bias.copy_(inits.torch_linear_bias((dim,), gen, text_dim))
        self.norm2 = FusedLayerNorm(dim)
        self.cross_attn = MultiHeadAttention(dim, heads, cd, gen)
        self.norm3 = FusedLayerNorm(dim)
        self.moe = SparseMoE(dim, latent_dim, num_experts, router_hidden, cd, gen)
        self.proj_out = ModulatedConv(dim, dim, 1, latent_dim, compute_dtype=cd, gen=gen)

    def forward(self, x: torch.Tensor, w: torch.Tensor, text_seq: torch.Tensor,
                training: bool = False, annealing_factor: float | torch.Tensor = 1.0,
                eps=None):
        """x [B, H, W, C]; w [B, latent]; text_seq [B, 1, text_dim] -> (x_out, kl, probs [B, T, E]).

        `training`, `annealing_factor` and the router noise go to the MoE.
        """
        B, Hh, Ww, C = x.shape
        tokens = self.proj_in(x, w).reshape(B, Hh * Ww, C)
        tokens = tokens + self.self_attn.self_attention(self.norm1(tokens))
        tproj = self.text_proj(text_seq)
        # norm2 feeds only the cross-attention query, which a length-1
        # key sequence ignores; the JAX package's compiler drops it too.
        tokens = tokens + self.cross_attn.cross_single(tokens, tproj)
        moe_out, kl, probs = self.moe(self.norm3(tokens), w, training, annealing_factor, eps)
        tokens = tokens + moe_out
        return self.proj_out(tokens.reshape(B, Hh, Ww, C), w), kl, probs
