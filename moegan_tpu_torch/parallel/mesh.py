"""The (data x expert) layout of the ranks (counterpart of moegan_tpu/parallel/mesh.py).

The JAX package lays its devices out as a 2-D mesh, `np.asarray(devices)
.reshape(n // ep, ep)`, whose 'data' axis splits the batch and whose
'expert' axis splits the stacked expert weights of every SparseMoE. Here a
rank stands for a device: rank r sits at (r // ep, r % ep). A `Mesh` holds
this rank's coordinates and two `torch.distributed` process groups: its
data group (the ranks with its expert coordinate, over which gradients are
averaged) and its expert group (the ranks with its data coordinate, over
which the MoE partial sums are added).

`maybe_mesh_context` makes a mesh the ambient one, which `SparseMoE` reads
as the JAX module reads `jax.sharding.get_abstract_mesh()`.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass

import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, expert) layout of `world_size` ranks."""

    shape: tuple[int, int]  # (data, expert)
    rank: int
    data_group: object  # ProcessGroup of this rank's expert coordinate, or None
    expert_group: object  # ProcessGroup of this rank's data coordinate, or None
    data_axis: str = "data"
    expert_axis: str = "expert"

    @property
    def data_size(self) -> int:
        return self.shape[0]

    @property
    def expert_size(self) -> int:
        return self.shape[1]

    @property
    def world_size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[1]

    @property
    def expert_index(self) -> int:
        return self.rank % self.shape[1]


def mesh_groups(world_size: int, expert_parallelism: int) -> tuple[list, list]:
    """(data groups, expert groups) as lists of ranks: data group e holds the
    ranks of expert coordinate e, expert group d those of data coordinate d."""
    ep = expert_parallelism
    if ep < 1 or world_size % ep:
        raise ValueError(f"expert_parallelism {ep} does not divide world size {world_size}")
    dp = world_size // ep
    data = [[d * ep + e for d in range(dp)] for e in range(ep)]
    expert = [[d * ep + e for e in range(ep)] for d in range(dp)]
    return data, expert


def create_mesh(world_size: int | None = None, expert_parallelism: int = 1,
                rank: int | None = None, data_axis: str = "data",
                expert_axis: str = "expert") -> Mesh:
    """The mesh of this rank in an initialised process group.

    Every rank must call this, with the same arguments, at the same point:
    it creates every data group and then every expert group with
    `dist.new_group`, in the same order on every rank (a group creation that
    some rank skips or reorders hangs the others). A group of one rank is
    not created; its collectives are skipped.
    """
    world_size = dist.get_world_size() if world_size is None else world_size
    rank = dist.get_rank() if rank is None else rank
    data_lists, expert_lists = mesh_groups(world_size, expert_parallelism)
    ep = expert_parallelism
    data_group = expert_group = None
    for e, ranks in enumerate(data_lists):
        group = dist.new_group(ranks) if len(ranks) > 1 else None
        if rank % ep == e:
            data_group = group
    for d, ranks in enumerate(expert_lists):
        group = dist.new_group(ranks) if len(ranks) > 1 else None
        if rank // ep == d:
            expert_group = group
    return Mesh((world_size // ep, ep), rank, data_group, expert_group, data_axis, expert_axis)


def auto_expert_parallelism(world_size: int, num_experts: int) -> int:
    """Largest expert-axis size that divides both the world size and num_experts."""
    return math.gcd(world_size, num_experts)


_current: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar("moegan_mesh", default=None)


def current_mesh() -> Mesh | None:
    """The ambient mesh (set by `maybe_mesh_context`), or None."""
    return _current.get()


@contextlib.contextmanager
def maybe_mesh_context(mesh: Mesh | None):
    """Make `mesh` the ambient mesh inside the block; no-op when it is None."""
    if mesh is None:
        yield
        return
    token = _current.set(mesh)
    try:
        yield
    finally:
        _current.reset(token)
