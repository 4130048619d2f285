"""Per-pixel sparse MoE FFN with a Bayesian router (counterpart of
moegan_tpu/core/moe.py), through the fused kernels or, with
`use_pallas=False`, the dense mixture.

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

With `use_pallas=False` the module is the JAX `router` + `_mixture` route
(moe.py:84-93, :228-260): the fp32 router (sampled weights and soft routing
in training, the means and the argmax one-hot at eval), then every expert's
FFN on every token, [E, B, T, 4C] in the compute dtype with the exact-erf
GELU, combined over E with fp32 accumulation. Under an expert mesh each rank
mixes its own experts with its columns of the probs between `expert_enter`
and `expert_combine`, as `_fused_sharded` does around the combine kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
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


class SparseExpertFFN(nn.Module):
    """One expert: Linear(d, 4d) -> exact GELU -> Linear(4d, d) (moe.py:33-50);
    the layers carry flax's automatic names, Dense_0 and Dense_1."""

    def __init__(self, dim: int, gen: torch.Generator | None = None):
        super().__init__()
        gen = inits.default_generator(gen)
        self.Dense_0 = inits.torch_linear(dim, 4 * dim, gen)
        self.Dense_1 = inits.torch_linear(4 * dim, dim, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate="none"))


class SparseMoE(nn.Module):
    def __init__(self, dim: int, text_dim: int, num_experts: int = 4, router_hidden: int = 128,
                 compute_dtype=torch.bfloat16, gen: torch.Generator | None = None,
                 use_pallas: bool = True):
        super().__init__()
        gen = inits.default_generator(gen)
        d, e = dim, num_experts
        self.num_experts = e
        self.compute_dtype = compute_dtype
        self.use_pallas = use_pallas
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
        if not self.use_pallas or mesh is not None:
            probs, _ = self.router(x, w, sampling=training, hard=not training,
                                   annealing_factor=annealing_factor, eps=eps)
            if not self.use_pallas:
                out = (self._mixture(x, probs) if mesh is None
                       else self._mixture_sharded(x, probs, mesh))
            else:
                out = self._fused_sharded(x, probs, training, mesh)
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

    def _local_experts(self, mesh) -> slice:
        """This rank's slice of the experts, which must be the experts the module holds."""
        local = expert_slice(mesh, self.num_experts)
        if self.w1.shape[0] != local.stop - local.start:
            raise ValueError(f"the MoE holds {self.w1.shape[0]} experts; this rank's slice of "
                             f"{self.num_experts} over {mesh.expert_size} ranks is {local}")
        return local

    def _fused_sharded(self, x, probs, training, mesh):
        """Expert-parallel path: given the full router's probs (every rank
        routes in full), this rank's experts' FFN and combine in the combine
        kernel, then the sum over the expert group. Returns out [B, T, C]."""
        B, T, C = x.shape
        E, cd = self.num_experts, self.compute_dtype
        local = self._local_experts(mesh)
        tokens = expert_enter(x.reshape(B * T, C).to(cd), mesh)
        pt = expert_enter(probs.reshape(B * T, E).float(), mesh)
        args = (tokens.contiguous(), pt[:, local].contiguous(), self.w1.to(cd), self.b1.float(),
                self.w2.to(cd), self.b2.float())
        part = MoECombineFunction.apply(*args) if training else moe_ffn_combine(*args)
        out = expert_combine(part, mesh)
        return out.reshape(B, T, C).to(x.dtype)

    def _mixture(self, x: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
        """sum_e p_e * FFN_e(x) over the experts the module holds (moe.py:228-260),
        in x's dtype. x [B, T, C]; probs [B, T, E_held]."""
        cd = self.compute_dtype
        h = torch.einsum("btc,ecf->ebtf", x.to(cd), self.w1.to(cd)) + self.b1.to(cd)[:, None, None]
        h = F.gelu(h, approximate="none")
        y = torch.einsum("ebtf,efc->ebtc", h, self.w2.to(cd)) + self.b2.to(cd)[:, None, None]
        out = torch.einsum("bte,ebtc->btc", probs.to(cd).float(), y.float())
        return out.to(x.dtype)

    def _mixture_sharded(self, x, probs, mesh):
        """The mixture under an expert mesh: this rank's experts (the module
        holds only their weights) with their columns of the full probs,
        summed over the expert group."""
        local = self._local_experts(mesh)
        part = self._mixture(expert_enter(x.float(), mesh),
                             expert_enter(probs.float(), mesh)[..., local])
        return expert_combine(part, mesh).to(x.dtype)
