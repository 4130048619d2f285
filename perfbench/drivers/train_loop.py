"""A closed loop of training steps through the port's entry points.

Set-up: `create_train_state` at the configuration, every weight replaced by
the seed's draw on the card (`harness.weights`); a synthetic split made on
the host from the seed, fed through the port's `BatchLoader` (epoch
reshuffles, the native gather on its thread) and `prefetch_to_device`;
`make_train_step(cfg, steps_per_epoch)`; the epoch-0 schedule; the step's
noise drawn by the benchmark from the seed on the card and passed as
`noise=`. The first CHECK_STEPS steps run through the window's own call
and feed on rows that all differ; their losses, step 1's optimizer moments
and the parameters after them are what the reference is held to. Then
`warmup_steps` more, so that every shape has run before the window.

Set-up prints each block's share of tokens per top-1 expert in step 1 (the
step's own `expert_top1` metric), so that a routing collapsed onto one
expert under the scaled router shows.

Window: steps are issued back to back with no synchronisation until the
host clock reaches the window's length, then one `torch.cuda.synchronize()`
closes it. A traced run spends `trace_share` of the window untraced (the
host-clock readings), then runs `trace_steps` steps with only the CUDA API
traced (the host's own cost of the step call, `harness.trace.host_cost`),
then profiles `trace_steps` whole steps.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from perfbench.harness import judge
from perfbench.harness import trace as trace_mod
from perfbench.harness import weights as W
from perfbench.harness.runner import Window

CHECK_STEPS = 3


def compile(device) -> float:
    """Build the port's CUDA libraries and its native batcher where missing; seconds."""
    t0 = time.perf_counter()
    from moegan_tpu_torch.data import native

    if torch.device(device).type == "cuda":
        from moegan_tpu_torch.ops import _build

        _build.build_all()
    native.build()
    return time.perf_counter() - t0


def epoch0_schedule(loss: dict) -> dict:
    """The losses' schedule at epoch 0: router temperature factor max(1, 3 - 0.1 e)
    and KL weight kl_weight * (1e-5 + (1 - 1e-5) min(1, (e / anneal)^2))."""
    return {"temperature_factor": 3.0, "effective_kl_weight": loss["kl_weight"] * 1e-5}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, fault=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.batch = traffic["batch"]
        self.fault = fault

    # --- set-up ----------------------------------------------------------------------

    def setup(self) -> None:
        from moegan_tpu_torch.config import TrainConfig
        from moegan_tpu_torch.data.datasets import ImageTextDataset
        from moegan_tpu_torch.data.loader import BatchLoader, prefetch_to_device
        from moegan_tpu_torch.train.state import create_train_state
        from moegan_tpu_torch.train.step import make_train_step

        tc = dict(self.config["train_config"], batch_size=self.batch)
        self.cfg = TrainConfig.from_dict(tc)
        self.state = create_train_state(self.cfg, device=self.device)
        named = (list(self.state.generator.named_parameters(prefix="G"))
                 + list(self.state.discriminator.named_parameters(prefix="D")))
        self.stats = W.template_stats(named)
        weights = W.make_weights(self.stats, self.seed, self.device, self.config["router_scale"])
        W.load_into(self.state.generator, weights, "G.")
        W.load_into(self.state.discriminator, weights, "D.")
        self.start = {k: v.detach().clone() for k, v in named}
        del weights

        t = self.traffic
        rng = np.random.default_rng(W.subseed(self.seed, "data"))
        R = self.cfg.generator.max_resolution
        images = rng.random((t["split"], R, R, 3), dtype=np.float32)
        images *= 2.0
        images -= 1.0
        text = rng.standard_normal((t["split"], self.cfg.generator.text_embedding_dim),
                                   dtype=np.float32)
        self.loader = BatchLoader(ImageTextDataset(images, text), self.batch, shuffle=True,
                                  seed=W.subseed(self.seed, "loader"))
        self._epochs = self._epoch_stream()
        self.feed = prefetch_to_device(self._epochs, self.device)
        self.step_fn = make_train_step(self.cfg, steps_per_epoch=self.loader.steps_per_epoch)
        self.schedule = epoch0_schedule(self.config["train_config"]["loss"])
        self.noise = W.NoiseStream(self.config, self.batch, self.seed, self.device)

        self.checked, losses = [], []
        for i in range(CHECK_STEPS):
            batch, noise = next(self.feed), self.noise.next()
            metrics = self._step(batch, noise)
            self.checked.append({"batch": {k: v.cpu() for k, v in batch.items()},
                                 "noise": judge.to_device(noise, "cpu")})
            losses.append({k: float(metrics[k]) for k in judge.TERMS})
            if i == 0:
                grad = self._first_grad()
                print_shares(metrics)
        change = {k: float((p.detach() - self.start[k]).norm()) for k, p in self._named()}
        self.candidate = {"losses": losses, "grad": grad, "change": change}
        del self.start
        for _ in range(t["warmup_steps"]):
            self._step(next(self.feed), self.noise.next())
        _sync(self.device)

    def _epoch_stream(self):
        epoch = 0
        while True:
            yield from self.loader.epoch(epoch)
            epoch += 1

    def _named(self):
        return (list(self.state.generator.named_parameters(prefix="G"))
                + list(self.state.discriminator.named_parameters(prefix="D")))

    def _first_grad(self) -> dict:
        """Per leaf, the norm of step 1's clipped gradient: m_1 / (1 - beta1)."""
        out = {}
        for prefix, module, opt in (("G", self.state.generator, self.state.g_opt),
                                    ("D", self.state.discriminator, self.state.d_opt)):
            named = list(module.named_parameters())
            parts = (opt.mu / (1.0 - self.cfg.beta1)).split([p.numel() for _, p in named])
            for (k, _), g in zip(named, parts):
                out[f"{prefix}.{k}"] = float(g.norm())
        return out

    # --- the timed call --------------------------------------------------------------

    def _step(self, batch, noise):
        if self.fault == "half_batch":
            h = self.batch // 2
            batch = {k: v[:h] for k, v in batch.items()}
            perm = noise["perm"]
            noise = {**noise, "z": noise["z"][:h], "perm": perm[perm < h]}
        if self.fault in ("frozen", "altered"):
            before = [p.detach().clone() for _, p in self._named()]
            opts = [(o, dict(vars(o))) for o in (self.state.g_opt, self.state.d_opt)]
        _, metrics = self.step_fn(self.state, batch, self.schedule, noise=noise)
        if self.fault == "frozen":  # the step returns its state unchanged
            with torch.no_grad():
                for (_, p), b in zip(self._named(), before):
                    p.copy_(b)
            for o, saved in opts:
                vars(o).update(saved)
        elif self.fault == "altered":  # one leaf's update applied twice
            with torch.no_grad():
                (_, p), b = self._named()[0], before[0]
                p.add_(p - b)
        return metrics

    def window(self, seconds: float, trace: bool) -> Window:
        t = self.traffic
        host_s = seconds * (1.0 - t["trace_share"]) if trace else seconds
        counts0 = int(self.state.d_opt.count)
        waits, calls, steps = [], [], 0
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            batch = next(self.feed)
            b = time.perf_counter()
            noise = self.noise.next()
            c = time.perf_counter()
            self._step(batch, noise)
            d = time.perf_counter()
            waits.append(b - a)
            calls.append(d - c)
            steps += 1
            if d - t0 >= host_s:
                break
        _sync(self.device)
        host = {"units": steps, "seconds": time.perf_counter() - t0, "batch": self.batch,
                "loader_wait_s": waits, "step_call_s": calls}
        traced, extra = None, {}
        if trace:
            marks = []
            with trace_mod.api_stretch() as api:
                for _ in range(t["trace_steps"]):
                    batch, noise = next(self.feed), self.noise.next()
                    a = time.time_ns()
                    self._step(batch, noise)
                    marks.append((a, time.time_ns()))
                    steps += 1
            extra["host_cost"] = trace_mod.host_cost(api.profile, marks)
            launches0 = _wrapper_launches()
            with trace_mod.stretch() as held:
                for _ in range(t["trace_steps"]):
                    with torch.profiler.record_function("perfbench.loader_next"):
                        batch = next(self.feed)
                    with torch.profiler.record_function("perfbench.noise"):
                        noise = self.noise.next()
                    with torch.profiler.record_function("perfbench.train_step"):
                        self._step(batch, noise)
                    steps += 1
            traced = trace_mod.read(held.profile, t["trace_steps"])
            extra["wrapper_launches"] = {k: v - launches0[k]
                                         for k, v in _wrapper_launches().items()}
        updates = int(self.state.d_opt.count) - counts0
        return Window(attempted=steps, failed=steps - updates, host=host, trace=traced,
                      extra=extra)

    # --- after the window ------------------------------------------------------------

    def release(self) -> None:
        self.feed.close()
        self._epochs.close()
        del self.state, self.step_fn, self.feed, self._epochs, self.loader
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        weights = W.make_weights(self.stats, self.seed, self.device, self.config["router_scale"])
        ref = judge.reference_training(self.config, weights, self.checked, self.schedule,
                                       self.traffic["split"] // self.batch, self.device)
        numbers, notes = judge.training_numbers(self.candidate, ref)
        self.notes = notes
        return numbers


def print_shares(metrics) -> None:
    """Each block's share of tokens per top-1 expert, and its mean routing
    probability per expert, from a step's metrics, on stderr."""
    top1 = metrics["expert_top1"].float().cpu().tolist()
    util = metrics["expert_util"].float().cpu().tolist()
    for i, (t, u) in enumerate(zip(top1, util)):
        print(f"routing block {i}: top-1 share {[round(x, 4) for x in t]} "
              f"mean prob {[round(x, 4) for x in u]}", file=sys.stderr, flush=True)


def _wrapper_launches() -> dict:
    """The hand kernels' wrappers' own launch counters."""
    from moegan_tpu_torch.ops import flash_attention as tfa
    from moegan_tpu_torch.ops import fused_moe as tfm

    return {"flash_fwd": tfa.flash_attention.launches,
            "flash_bwd": tfa.flash_attention_bwd.launches,
            "moe_fwd": tfm.fused_moe_ffn.launches, "moe_bwd": tfm.fused_moe_bwd.launches}
