"""Parameter partition rules, batch slicing and the collectives of the
expert-parallel MoE (counterpart of moegan_tpu/parallel/sharding.py).

In the JAX package GSPMD places the parameters by their partition rules
and inserts the collectives itself. Here each rank holds its own shards
and the collectives are explicit:

- the expert-stacked MoE weights (w1, b1, w2, b2 under a MoE scope) keep
  this rank's expert slice, everything else is replicated;
- a batch is cut along the rank's data coordinate;
- the sharded MoE enters through `ExpertEnter` (identity forward, sum over
  the expert group backward) and leaves through `ExpertCombine` (sum over
  the expert group forward, identity backward): the f and g of Megatron's
  tensor parallelism. Without the first, dx and the router's gradients
  would be partial on each rank and the replicated parameters would drift
  apart silently; JAX's `shard_map` gives the same sums ("replicated inputs
  psum their cotangents", moegan_tpu/ops/fused_moe.py:1027-1032).

Sums run in float32 and are rounded once to the input's dtype: for two
ranks this gives the bits of a bf16 psum. Gloo has no all_gather of CUDA
tensors, so gathers are zero-padded all_reduces.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from moegan_tpu_torch.parallel.mesh import Mesh

EXPERT_PARAMS = ("w1", "b1", "w2", "b2")


def param_sharding_rules(name: str, expert_axis: str = "expert") -> str | None:
    """The mesh axis that splits the parameter's leading dimension, or None
    (replicated). `name` is a dotted `named_parameters` name."""
    parts = name.split(".")
    if parts[-1] in EXPERT_PARAMS and any("moe" in p.lower() for p in parts[:-1]):
        return expert_axis
    return None


def expert_slice(mesh: Mesh, num_experts: int) -> slice:
    """This rank's experts of `num_experts`."""
    if num_experts % mesh.expert_size:
        raise ValueError(f"{mesh.expert_size} expert ranks do not divide {num_experts} experts")
    n = num_experts // mesh.expert_size
    return slice(mesh.expert_index * n, (mesh.expert_index + 1) * n)


@torch.no_grad()
def shard_module_(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Keep only this rank's slice of every expert-sharded parameter, in place."""
    if mesh.expert_size == 1:
        return module
    for name, p in list(module.named_parameters()):
        if param_sharding_rules(name, mesh.expert_axis) is None:
            continue
        owner = module.get_submodule(name.rpartition(".")[0])
        local = p[expert_slice(mesh, p.shape[0])].clone()
        setattr(owner, name.rpartition(".")[2], torch.nn.Parameter(local))
    return module


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over `group` in float32, rounded once to t's dtype."""
    if group is None:
        return t
    buf = t.detach().float().clone()
    dist.all_reduce(buf, group=group)
    return buf.to(t.dtype)


@torch.no_grad()
def gather_full(named: dict, mesh: Mesh) -> dict:
    """{name: full tensor} from this rank's {name: tensor} (parameters, or
    tensors of their shapes such as gradients): the expert-sharded ones are
    assembled over the expert group; the rest are returned as they are."""
    out = {}
    for name, t in named.items():
        if mesh.expert_size == 1 or param_sharding_rules(name, mesh.expert_axis) is None:
            out[name] = t
            continue
        n = t.shape[0]
        full = torch.zeros((n * mesh.expert_size, *t.shape[1:]), dtype=torch.float32,
                           device=t.device)
        full[mesh.expert_index * n:(mesh.expert_index + 1) * n] = t.float()
        out[name] = _sum(full, mesh.expert_group).to(t.dtype)
    return out


class ShardedBatch(dict):
    """A batch already cut to this rank's slice (see `shard_batch`)."""


def shard_batch(batch, mesh: Mesh, device=None) -> ShardedBatch:
    """This rank's slice of every leaf of a global batch, on `device` if given.
    A `ShardedBatch` (already this rank's, e.g. from `data.loader.prefetch_to_device`)
    passes through untouched."""
    if isinstance(batch, ShardedBatch):
        return batch
    local = batch_sharding(mesh)
    return ShardedBatch({k: local(torch.as_tensor(v)).to(device) if device is not None
                         else local(torch.as_tensor(v)) for k, v in batch.items()})


def batch_sharding(mesh: Mesh | None):
    """leaf -> this rank's slice of its leading (batch) axis along the data axis
    (the leaf itself without a mesh)."""
    if mesh is None:
        return lambda x: x

    def local(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % mesh.data_size:
            raise ValueError(f"batch of {x.shape[0]} does not split over {mesh.data_size} ranks")
        n = x.shape[0] // mesh.data_size
        return x[mesh.data_index * n:(mesh.data_index + 1) * n]

    return local


@torch.no_grad()
def gather_batch(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The global batch of a leaf cut by `batch_sharding`, on every rank."""
    if mesh is None or mesh.data_size == 1:
        return x
    n = x.shape[0]
    full = torch.zeros((n * mesh.data_size, *x.shape[1:]), dtype=torch.float32, device=x.device)
    full[mesh.data_index * n:(mesh.data_index + 1) * n] = x.float()
    return _sum(full, mesh.data_group).to(x.dtype)


@torch.no_grad()
def data_mean(tensors, mesh: Mesh | None):
    """Each tensor averaged over the data group (one collective for all)."""
    tensors = list(tensors)
    if mesh is None or mesh.data_size == 1:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    flat = _sum(flat, mesh.data_group) / mesh.data_size
    return [v.view_as(t).to(t.dtype) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


class ExpertEnter(torch.autograd.Function):
    """Identity forward; the sum over the expert group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class ExpertCombine(torch.autograd.Function):
    """The sum over the expert group forward (fp32, rounded once); identity backward."""

    @staticmethod
    def forward(ctx, part, group):
        return _sum(part, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class DataSum(torch.autograd.Function):
    """The sum over the data group, forward and backward (its own adjoint).

    For a loss that every data rank computes from the sum (the CV balance of
    the global routing), the backward sum makes each rank's gradient dp
    times its share, so that averaging the gradients over the data group
    gives the global gradient.
    """

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


def expert_enter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x if mesh.expert_size == 1 else ExpertEnter.apply(x, mesh.expert_group)


def expert_combine(part: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return part if mesh.expert_size == 1 else ExpertCombine.apply(part, mesh.expert_group)


def data_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    return x if mesh is None or mesh.data_size == 1 else DataSum.apply(x, mesh.data_group)
