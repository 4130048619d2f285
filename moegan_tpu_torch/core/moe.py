"""Per-pixel sparse MoE FFN with a Bayesian router (counterpart of
moegan_tpu/core/moe.py) through the fused kernels.

`forward` is the JAX `_fused` glue (moe.py:184-226): router weights (the
posterior means at eval, a reparameterised sample in training), nan_to_num
on x and w, the per-image text logits (w @ tw) @ cw[h:] broadcast over
tokens, inv_temp = 1/clip(temperature * annealing, 0.5, 5), tokens and fw
in the compute dtype, cw[:h] in fp32. Eval routes hard (top-1) through
`fused_moe_ffn`; training routes soft through `FusedMoEFunction`, whose
backward is the MoE backward kernel, and adds the router's KL. The kernels
mask ragged token tiles themselves, so the JAX glue's padding to 256 is not
needed.

Under an ambient mesh (`parallel.mesh.maybe_mesh_context`) whose expert
axis is larger than 1, `_fused_sharded` takes the place of the fused path,
as in the JAX module (moe.py:110-182): the router runs in full on every
rank (`BayesianRouter.forward`, fp32), each rank computes the combine of
its own experts' FFNs with its columns of the probs (`moe_ffn_combine`,
`MoECombineFunction` in training), and the partial sums are added over the
expert group. The module then holds only its rank's slice of w1, b1, w2
and b2 (`parallel.sharding.shard_module_`).
"""

from __future__ import annotations

import torch
from torch import nn

from moegan_tpu_torch.core import inits
from moegan_tpu_torch.core.router import BayesianRouter
from moegan_tpu_torch.ops.fused_moe import (
    FusedMoEFunction,
    MoECombineFunction,
    fused_moe_ffn,
    moe_ffn_combine,
)
from moegan_tpu_torch.parallel.mesh import current_mesh
from moegan_tpu_torch.parallel.sharding import expert_combine, expert_enter, expert_slice


class SparseMoE(nn.Module):
    def __init__(self, dim: int, text_dim: int, num_experts: int = 4, router_hidden: int = 128,
                 compute_dtype=torch.bfloat16, gen: torch.Generator | None = None):
        super().__init__()
        gen = inits.default_generator(gen)
        d, e = dim, num_experts
        self.num_experts = e
        self.compute_dtype = compute_dtype
        self.w1 = nn.Parameter(inits.torch_linear_kernel((e, d, 4 * d), gen))
        self.b1 = nn.Parameter(inits.torch_linear_bias((e, 4 * d), gen, d))
        self.w2 = nn.Parameter(inits.torch_linear_kernel((e, 4 * d, d), gen))
        self.b2 = nn.Parameter(inits.torch_linear_bias((e, d), gen, 4 * d))
        self.router = BayesianRouter(d, text_dim, e, router_hidden, gen)

    def forward(self, x: torch.Tensor, w: torch.Tensor, training: bool = False,
                annealing_factor: float | torch.Tensor = 1.0, eps=None):
        """x [B, T, C] (normalised tokens); w [B, latent].

        Returns (out [B, T, C], kl, probs [B, T, E]); kl is 0 at eval. In
        training the router noise is `eps` (see `BayesianRouter.sample_weights`),
        which a training call must pass.
        """
        if training and eps is None:
            raise ValueError("a training forward needs the router noise eps")
        mesh = self._expert_mesh()
        if mesh is not None:
            out, probs = self._fused_sharded(x, w, training, annealing_factor, eps, mesh)
            kl = self.router.kl_divergence() if training else torch.zeros((), device=x.device)
            return out, kl, probs
        B, T, C = x.shape
        E, h, cd = self.num_experts, self.router.hidden, self.compute_dtype
        fw, tw, cw = self.router.sample_weights(training, eps)
        xt = torch.nan_to_num(x.float(), nan=0.0, posinf=1.0, neginf=-1.0)
        wt = torch.nan_to_num(w.float(), nan=0.0, posinf=1.0, neginf=-1.0)
        text_logits = (wt @ tw) @ cw[h:]  # [B, E]
        tl = text_logits[:, None, :].expand(B, T, E).reshape(B * T, E).contiguous()
        args = (xt.reshape(B * T, C).to(cd), fw.to(cd).contiguous(), cw[:h].float().contiguous(),
                tl, self.router.inv_temperature(annealing_factor),
                self.w1.to(cd), self.b1.float(), self.w2.to(cd), self.b2.float())
        if training:
            out, probs = FusedMoEFunction.apply(*args)
            kl = self.router.kl_divergence()
        else:
            out, probs = fused_moe_ffn(*args, hard=True)
            kl = torch.zeros((), device=x.device)
        return out.reshape(B, T, C).to(x.dtype), kl, probs.reshape(B, T, E)

    def _expert_mesh(self):
        """The ambient mesh when it has an expert axis larger than 1 that divides E."""
        m = current_mesh()
        if m is not None and m.expert_size > 1 and self.num_experts % m.expert_size == 0:
            return m
        return None

    def _fused_sharded(self, x, w, training, annealing_factor, eps, mesh):
        """Expert-parallel path: the full router on every rank, this rank's
        experts' FFN and combine in the combine kernel, the sum over the
        expert group. Returns (out [B, T, C], probs [B, T, E]) with the full probs."""
        B, T, C = x.shape
        E, cd = self.num_experts, self.compute_dtype
        local = expert_slice(mesh, E)
        if self.w1.shape[0] != local.stop - local.start:
            raise ValueError(f"the MoE holds {self.w1.shape[0]} experts; this rank's slice of "
                             f"{E} over {mesh.expert_size} ranks is {local}")
        probs, _ = self.router(x, w, sampling=training, hard=not training,
                               annealing_factor=annealing_factor, eps=eps)
        tokens = expert_enter(x.reshape(B * T, C).to(cd), mesh)
        pt = expert_enter(probs.reshape(B * T, E).float(), mesh)
        args = (tokens.contiguous(), pt[:, local].contiguous(), self.w1.to(cd), self.b1.float(),
                self.w2.to(cd), self.b2.float())
        part = MoECombineFunction.apply(*args) if training else moe_ffn_combine(*args)
        out = expert_combine(part, mesh)
        return out.reshape(B, T, C).to(x.dtype), probs
