"""Process groups for the tests of the port's distributed path, on the CPU over gloo.

`spawn` starts `world_size` processes with the spawn start method, each
running one of the rank functions below under an initialised gloo process
group, and returns what each rank returned. The children import this
module, torch and the port only: no JAX and no tests/conftest.py.

Nothing may hang a test run: every process group has a 60 s timeout, and
the parent waits at most `timeout` seconds for the children, then
terminates them and fails.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn_name: str, world_size: int, timeout: float = 150.0, **kwargs) -> list:
    """[rank 0's result, rank 1's, ...] of `fn_name(rank, world_size, **kwargs)`."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="moegan_dist_") as tmp:
        procs = [ctx.Process(target=_child, args=(fn_name, r, world_size, port, tmp, kwargs))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join(5)
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                errors.append(f"rank {r}:\n{open(err).read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if hung:
            errors.insert(0, f"ranks {hung} still ran after {timeout} s and were terminated")
        if errors:
            raise AssertionError("\n".join(errors))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]


def _child(fn_name, rank, world_size, port, tmp, kwargs):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world_size, timeout=timedelta(seconds=60))
        result = globals()[fn_name](rank, world_size, **kwargs)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy (not a view of a parameter that a later step updates in place)."""
    return t.detach().float().cpu().numpy().copy()


# --- rank functions ----------------------------------------------------------------------


def mesh_info(rank, world_size, expert_parallelism):
    """This rank's coordinates and the members of its two groups (found by summing
    one-hot rank vectors over each group)."""
    from moegan_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(world_size, expert_parallelism)
    members = {}
    for name, group in (("data", mesh.data_group), ("expert", mesh.expert_group)):
        v = torch.zeros(world_size)
        v[rank] = 1.0
        if group is not None:
            dist.all_reduce(v, group=group)
        members[name] = [int(i) for i in torch.nonzero(v).flatten()]
    return dict(shape=mesh.shape, data_index=mesh.data_index, expert_index=mesh.expert_index,
                members=members)


def sharded_moe(rank, world_size, module_args, state_dict, x, w, eps, annealing, dout, dprobs,
                kl_weight, use_pallas=True):
    """The expert-sharded SparseMoE at (data 1 x expert world_size): the eval
    forward, and a training forward and backward of
    sum(out * dout) + sum(probs * dprobs) + kl_weight * kl.
    Returns the outputs and the gathered gradients of the inputs and parameters."""
    from moegan_tpu_torch.core.moe import SparseMoE
    from moegan_tpu_torch.parallel.mesh import create_mesh, maybe_mesh_context
    from moegan_tpu_torch.parallel.sharding import gather_full, shard_module_

    mesh = create_mesh(world_size, world_size)
    m = SparseMoE(*module_args, compute_dtype=torch.float32, use_pallas=use_pallas)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    # The partition rules name a MoE by its scope, as in a generator.
    holder = torch.nn.Module()
    holder.moe = m
    shard_module_(holder, mesh)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    out = {}
    with maybe_mesh_context(mesh):
        with torch.no_grad():
            o, kl, p = m(xt, wt, training=False)
        out.update(eval_out=_np(o), eval_kl=_np(kl), eval_probs=_np(p))
        xg, wg = xt.clone().requires_grad_(True), wt.clone().requires_grad_(True)
        o, kl, p = m(xg, wg, training=True, annealing_factor=annealing,
                     eps=tuple(torch.from_numpy(e) for e in eps))
        loss = (o * torch.from_numpy(dout)).sum() + (p * torch.from_numpy(dprobs)).sum() \
            + kl_weight * kl
        names = [n for n, _ in holder.named_parameters()]
        grads = torch.autograd.grad(loss, [xg, wg, *holder.parameters()])
    out.update(train_out=_np(o), train_kl=_np(kl), train_probs=_np(p), dx=_np(grads[0]),
               dw=_np(grads[1]))
    full = gather_full(dict(zip(names, grads[2:])), mesh)
    out["grads"] = {k.removeprefix("moe."): _np(v) for k, v in full.items()}
    return out


def _named_views(flat: torch.Tensor, module: torch.nn.Module) -> dict:
    sizes = [p.numel() for p in module.parameters()]
    return {n: v.view_as(p) for v, (n, p) in zip(flat.split(sizes), module.named_parameters())}


def full_state(state) -> dict:
    """{"g" | "d": {name: ndarray}} of the whole (unsharded) parameters."""
    from moegan_tpu_torch.parallel.sharding import gather_full

    out = {}
    for key, module in (("g", state.generator), ("d", state.discriminator)):
        named = dict(module.named_parameters())
        out[key] = {k: _np(v) for k, v in
                    (gather_full(named, state.mesh) if state.mesh else named).items()}
    return out


def first_moments(state) -> dict:
    """{"g" | "d": {name: ndarray}} of Adam's first moment, per whole parameter."""
    from moegan_tpu_torch.parallel.sharding import gather_full

    out = {}
    for key, module, opt in (("g", state.generator, state.g_opt),
                             ("d", state.discriminator, state.d_opt)):
        named = _named_views(opt.mu, module)
        out[key] = {k: _np(v) for k, v in
                    (gather_full(named, state.mesh) if state.mesh else named).items()}
    return out


def train_steps(rank, world_size, cfg_dict, seed, batches, noises, schedule, moments_after=1,
                router_scale=None):
    """`setup_distributed_training` on the CPU, then one step per global batch with
    the given noise. Returns the metrics of each step, Adam's first moments after
    step `moments_after` (under gradient accumulation the first step that
    applies an update), the whole parameters after each step, and the
    optimizer counts at the end. With `router_scale` every router's
    combined_mu is scaled by it first (as `tests.torch_helpers.decisive_router`)."""
    from moegan_tpu_torch.config import TrainConfig
    from moegan_tpu_torch.parallel.api import setup_distributed_training

    cfg = TrainConfig.from_dict(cfg_dict).replace(seed=seed)
    mesh, state, step = setup_distributed_training(cfg, device="cpu")
    if router_scale is not None:
        with torch.no_grad():
            for name, p in state.generator.named_parameters():
                if name.endswith("combined_mu"):
                    p.mul_(router_scale)
    metrics, moments, params = [], None, []
    for i, (batch, noise) in enumerate(zip(batches, noises)):
        state, m = step(state, batch, schedule, noise=noise)
        metrics.append({k: _np(v) for k, v in m.items()})
        if i + 1 == moments_after:
            moments = first_moments(state)
        params.append(full_state(state))
    counts = [[int(o.count), int(o.notfinite_count)] + ([] if o.mini_step is None
                                                       else [int(o.mini_step)])
              for o in (state.g_opt, state.d_opt)]
    return dict(metrics=metrics, moments=moments, params=params[-1], params_each=params,
                counts=counts, mesh=(mesh.shape, mesh.data_index, mesh.expert_index))


class ListLogger:
    """A MetricLogger that keeps its lines and metrics in lists."""

    def __init__(self):
        self.lines, self.metrics = [], []

    def log_line(self, msg):
        self.lines.append(msg)

    def log_metric(self, name, value, step=None):
        self.metrics.append((name, float(value), step))

    def log_metrics(self, metrics, step=None):
        for k, v in metrics.items():
            self.log_metric(k, v, step)

    def log_vector(self, name, values, step=None):
        self.lines.append(f"{name}: {values}")


def run_loop(cfg_dict, n_train, n_val, stop_after_epoch, distributed):
    """`train_aurora_gan` on synthetic datasets, on the CPU; the callback stops
    training after `stop_after_epoch`. Returns (state, logger, callback epochs)."""
    from moegan_tpu_torch.config import TrainConfig
    from moegan_tpu_torch.data.datasets import synthetic_dataset
    from moegan_tpu_torch.train.loop import train_aurora_gan

    cfg = TrainConfig.from_dict(cfg_dict)
    res = cfg.generator.max_resolution
    train = synthetic_dataset(n_train, res, seed=1)
    val = synthetic_dataset(n_val, res, seed=2)
    log, seen = ListLogger(), []

    def callback(epoch, metrics):
        seen.append((epoch, dict(metrics)))
        return epoch < stop_after_epoch

    state = train_aurora_gan(train, val, cfg=cfg, metric_callback=callback,
                             distributed=distributed, device="cpu", logger=log)
    return state, log, seen


def train_loop(rank, world_size, cfg_dict, n_train, n_val, stop_after_epoch):
    """The mesh's groups (as `mesh_info`), then `run_loop` distributed."""
    from moegan_tpu_torch.config import TrainConfig

    info = mesh_info(rank, world_size, TrainConfig.from_dict(cfg_dict).mesh.expert_parallelism)
    state, log, seen = run_loop(cfg_dict, n_train, n_val, stop_after_epoch, True)
    return dict(mesh=info, params=full_state(state), lines=log.lines, metrics=log.metrics,
                seen=seen, steps=state.step)


def adam_moments(state) -> dict:
    """{"g" | "d": {"mu" | "nu": {name: ndarray}}} of the whole (unsharded) moments."""
    from moegan_tpu_torch.parallel.sharding import gather_full

    out = {}
    for key, module, opt in (("g", state.generator, state.g_opt),
                             ("d", state.discriminator, state.d_opt)):
        out[key] = {}
        for m in ("mu", "nu"):
            named = _named_views(getattr(opt, m), module)
            out[key][m] = {k: _np(v) for k, v in
                           (gather_full(named, state.mesh) if state.mesh else named).items()}
        out[key]["count"] = int(opt.count)
        if opt.acc is not None:
            named = _named_views(opt.acc, module)
            out[key]["acc"] = {k: _np(v) for k, v in
                               (gather_full(named, state.mesh) if state.mesh else named).items()}
            out[key]["mini_step"] = int(opt.mini_step)
    return out


def resume_loop(rank, world_size, cfg_dict, n_train, n_val, interrupted_dir, whole_dir,
                distributed=True, first_epochs=2):
    """`train_aurora_gan` for `first_epochs` epochs saving to `interrupted_dir`, then
    resumed from there to 3 epochs, beside an uninterrupted 3-epoch run saving to
    `whole_dir`. Returns the whole parameters, Adam's moments (and accumulators)
    and the step of both runs."""
    from moegan_tpu_torch.config import TrainConfig
    from moegan_tpu_torch.data.datasets import synthetic_dataset
    from moegan_tpu_torch.train.loop import train_aurora_gan

    cfg = TrainConfig.from_dict(cfg_dict)
    res = cfg.generator.max_resolution
    train = synthetic_dataset(n_train, res, seed=1)
    val = synthetic_dataset(n_val, res, seed=2)
    out = {}
    runs = (("whole", 3, whole_dir, False), ("first", first_epochs, interrupted_dir, False),
            ("resumed", 3, interrupted_dir, True))
    for name, epochs, save_dir, resume in runs:
        log = ListLogger()
        state = train_aurora_gan(train, val, cfg=cfg.replace(num_epochs=epochs),
                                 save_dir=save_dir, resume=resume, distributed=distributed,
                                 device="cpu", logger=log)
        out[name] = dict(params=full_state(state), moments=adam_moments(state), step=state.step,
                         lines=log.lines)
    return out


def progressive_run(cfg_dict, stages, distributed):
    """`train_progressive` on synthetic sets on the CPU. Returns ([(resolution,
    state), ...], logger)."""
    from moegan_tpu_torch.config import TrainConfig
    from moegan_tpu_torch.data.datasets import synthetic_dataset
    from moegan_tpu_torch.train.progressive import train_progressive

    cfg = TrainConfig.from_dict(cfg_dict)
    res = max(r for r, _ in stages)
    log = ListLogger()
    _, stage_states = train_progressive(
        synthetic_dataset(8, res, seed=1), synthetic_dataset(4, res, seed=2), cfg=cfg,
        stages=stages, logger=log, device="cpu", distributed=distributed)
    return stage_states, log


def progressive_ranks(rank, world_size, cfg_dict, stages):
    """`progressive_run` over the process group: each rank grafts its own slices.
    Returns each stage's whole parameters, the log lines and the last stage's
    generator shapes on this rank."""
    stage_states, log = progressive_run(cfg_dict, stages, True)
    last = stage_states[-1][1].generator.state_dict()
    return dict(stages=[full_state(s) for _, s in stage_states], lines=log.lines,
                steps=[s.step for _, s in stage_states],
                shapes={k: tuple(v.shape) for k, v in last.items()})
