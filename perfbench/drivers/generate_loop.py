"""A closed loop of one caller generating images through `Sampler.sample_raw`.

Set-up: the generator's weights drawn on the card from the seed
(`harness.weights`) and handed to the port's `Sampler`; a pool of
`embedding_pool` text embeddings made from the seed; `warmup_calls` calls.

Each call: z [batch, latent] drawn on the host from the seed, embeddings
drawn from the pool, psi the traffic's; the call runs from the moment
`sample_raw` is started to the moment its images are a numpy array on the
host (`.float().cpu().numpy()`, as `MicroBatcher._run` takes them). Calls
follow one another with no pause. A reservoir sample of `check_calls`
calls, drawn from the seed, keeps its inputs, images and routing for the
check; the routing is brought to the host after the call's clock stops.
Set-up prints each block's share of tokens per expert in the last warm-up
call (the port's `expert_utilization_stats`), so that a routing collapsed
onto one expert under the scaled router shows. A traced run spends
`trace_share` of the window untraced, then runs `trace_calls` calls with
only the CUDA API traced (the host's own cost of `sample_raw`,
`harness.trace.host_cost`), then profiles `trace_calls` calls and counts,
from their own routing, the experts each block's tokens selected.
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


def compile(device) -> float:
    """Build the port's CUDA libraries where missing; seconds."""
    t0 = time.perf_counter()
    if torch.device(device).type == "cuda":
        from moegan_tpu_torch.ops import _build

        _build.build_all()
    return time.perf_counter() - t0


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, fault=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.batch = traffic["batch"]
        self.fault = fault

    def setup(self) -> None:
        from moegan_tpu_torch.config import GeneratorConfig
        from moegan_tpu_torch.infer.sample import Sampler
        from moegan_tpu_torch.models.generator import AuroraGenerator

        g = self.config["train_config"]["generator"]
        self.gcfg = GeneratorConfig.from_dict(g)
        self.stats = W.template_stats(AuroraGenerator(self.gcfg).named_parameters())
        weights = W.make_weights(self.stats, self.seed, self.device, self.config["router_scale"])
        self.sampler = Sampler(self.gcfg, weights, device=self.device)
        del weights
        t = self.traffic
        rng = np.random.default_rng(W.subseed(self.seed, "inputs"))
        self.pool = rng.standard_normal((t["embedding_pool"], g["text_embedding_dim"]),
                                        dtype=np.float32)
        self.rng = rng
        self.pick = np.random.default_rng(W.subseed(self.seed, "sample"))
        self.psi = np.full(self.batch, t["psi"], np.float32)
        self.prev = None
        for _ in range(t["warmup_calls"]):
            _, routing, _ = self._call(self._inputs())
        print_shares(routing)
        self.kept, self.calls = [], 0

    def _inputs(self) -> dict:
        z = self.rng.standard_normal((self.batch, self.gcfg.latent_dim), dtype=np.float32)
        idx = self.rng.integers(0, len(self.pool), self.batch)
        return {"z": z, "text": self.pool[idx], "psi": self.psi}

    def _call(self, inp):
        """One timed call: (images on the host, routing on the card, the interval of
        `sample_raw` by `time.time_ns()`)."""
        a = time.time_ns()
        images, routing = self.sampler.sample_raw(inp["z"], inp["text"], inp["psi"])
        b = time.time_ns()
        if self.fault == "stale" and self.prev is not None:
            images = self.prev  # the previous call's answer
        elif self.fault == "half_batch":
            h = self.batch // 2
            images = torch.cat([images[:h], images[:h]])
        elif self.fault == "altered":
            images = images.clone()
            images[0] = -images[0]
        self.prev = images
        host = images.float().cpu().numpy()
        return host, routing, (a, b)

    def _keep(self, inp, host, routing) -> None:
        """Reservoir sampling of check_calls calls over all the window's calls."""
        k = self.traffic["check_calls"]
        self.calls += 1
        slot = len(self.kept) if len(self.kept) < k else int(self.pick.integers(0, self.calls))
        if slot < k:
            entry = {**inp, "images": host, "routing": [r.cpu() for r in routing]}
            if slot == len(self.kept):
                self.kept.append(entry)
            else:
                self.kept[slot] = entry

    def window(self, seconds: float, trace: bool) -> Window:
        t = self.traffic
        host_s = seconds * (1.0 - t["trace_share"]) if trace else seconds
        latency, returns, calls = [], [], 0
        t0 = time.perf_counter()
        while True:
            inp = self._inputs()
            a = time.perf_counter()
            host, routing, (ra, rb) = self._call(inp)
            b = time.perf_counter()
            latency.append(b - a)
            returns.append((rb - ra) * 1e-9)
            calls += 1
            self._keep(inp, host, routing)
            if b - t0 >= host_s:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        host = {"units": calls, "seconds": time.perf_counter() - t0, "batch": self.batch,
                "latency_s": latency, "sample_raw_s": returns}
        traced, extra = None, {}
        if trace:
            marks = []
            with trace_mod.api_stretch() as api:
                for _ in range(t["trace_calls"]):
                    inp = self._inputs()
                    host_img, routing, mark = self._call(inp)
                    marks.append(mark)
                    calls += 1
                    self._keep(inp, host_img, routing)
            extra["host_cost"] = trace_mod.host_cost(api.profile, marks)
            routings = []
            with trace_mod.stretch() as held:
                for _ in range(t["trace_calls"]):
                    inp = self._inputs()
                    with torch.profiler.record_function("perfbench.generate_call"):
                        host_img, routing, _ = self._call(inp)
                    routings.append(routing)
                    calls += 1
                    self._keep(inp, host_img, routing)
            traced = trace_mod.read(held.profile, t["trace_calls"])
            extra["selections"] = [[(float((r > 0).sum()), int((r > 0).any(0).any(0).sum()))
                                    for r in routing] for routing in routings]
        return Window(attempted=calls, failed=0, host=host, trace=traced, extra=extra)

    def release(self) -> None:
        del self.sampler, self.prev
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        weights = W.make_weights(self.stats, self.seed, self.device, self.config["router_scale"])
        return judge.generation_numbers(self.config, weights, self.kept, self.device)


def print_shares(routing) -> None:
    """Each block's share of tokens per expert and mean routing weight, on stderr."""
    from moegan_tpu_torch.infer.sample import expert_utilization_stats

    for block, s in expert_utilization_stats(routing).items():
        print(f"routing {block}: top-1 share {[round(x, 4) for x in s['top1_fraction']]} "
              f"mean prob {[round(x, 4) for x in s['mean_prob']]}", file=sys.stderr, flush=True)
