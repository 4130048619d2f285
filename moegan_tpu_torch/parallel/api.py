"""Distributed training entry points (counterpart of moegan_tpu/parallel/api.py).

Data-parallel batches and expert-sharded MoE weights over a (data, expert)
layout of `torch.distributed` ranks, one device each. In the JAX package
GSPMD inserts the collectives from sharding annotations; here the step and
the sharded MoE issue them (`parallel.sharding`).

The default route is NCCL with one card per rank (`cuda:LOCAL_RANK`),
started by `torchrun --nproc_per_node=N`. A caller that wants another
backend asks for it: the CPU tests and chip_smoke.py use gloo, which also
carries CUDA tensors (through the host), so two ranks can share one card.
There is no automatic fallback from one backend to the other.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from moegan_tpu_torch.config import TrainConfig
from moegan_tpu_torch.parallel.mesh import Mesh, auto_expert_parallelism, create_mesh
from moegan_tpu_torch.parallel.sharding import shard_batch
from moegan_tpu_torch.train.state import TrainState, create_train_state
from moegan_tpu_torch.train.step import make_train_step

__all__ = ["expert_parallelism", "setup_distributed_training", "shard_batch"]


def expert_parallelism(cfg: TrainConfig, world_size: int) -> int:
    """cfg.mesh.expert_parallelism, or, when it is <= 0, the largest size that
    divides both the world size and num_experts (api.py:50-52)."""
    ep = cfg.mesh.expert_parallelism
    if ep <= 0:
        ep = auto_expert_parallelism(world_size, cfg.generator.num_experts)
    if world_size % ep or cfg.generator.num_experts % ep:
        raise ValueError(f"expert_parallelism {ep} must divide the world size {world_size} "
                         f"and num_experts {cfg.generator.num_experts}")
    return ep


def setup_distributed_training(cfg: TrainConfig, *, device=None, backend: str | None = None,
                               steps_per_epoch: int | None = None,
                               ) -> tuple[Mesh, TrainState, object]:
    """(mesh, this rank's state, step_fn) for training over the process group.

    Takes an initialised process group, or initialises one from the
    environment `torchrun` sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    with `backend` (default "nccl"). `device` defaults to `cuda:LOCAL_RANK`.
    step_fn is `make_train_step`'s step; it takes the global batch (or this
    rank's `ShardedBatch`) and updates this rank's state.
    """
    if not dist.is_initialized():
        dist.init_process_group(backend or "nccl")
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    world = dist.get_world_size()
    mesh = create_mesh(world, expert_parallelism(cfg, world), data_axis=cfg.mesh.data_axis,
                       expert_axis=cfg.mesh.expert_axis)
    state = create_train_state(cfg, device=device, mesh=mesh)
    return mesh, state, make_train_step(cfg, steps_per_epoch)
