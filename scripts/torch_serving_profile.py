#!/usr/bin/env python3
"""Where a served generator call's time goes, for the PyTorch port on one GPU.

Builds the default 64x64 generator from a seed on the card (the same model
and router scaling as chip_smoke.py) and times `Sampler.sample_raw` at the
micro-batcher's two batch sizes (4 and 16): host wall time per call around
a CUDA synchronize (median of 5 after 2 warm-ups), then one call under
`torch.profiler` for the device time by kernel and the device's busy share.

Run from the repository root on a machine with a CUDA device:
    python3 scripts/torch_serving_profile.py [--top 15]
It prints one JSON line per batch size.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import ROUTER_SCALE, SEED
    from moegan_tpu_torch.config import GeneratorConfig
    from moegan_tpu_torch.infer.sample import Sampler
    from moegan_tpu_torch.models.generator import AuroraGenerator

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    cfg = GeneratorConfig()
    gen = AuroraGenerator(cfg, gen=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("combined_mu"):
                p.mul_(ROUTER_SCALE)
    sampler = Sampler(cfg, gen.state_dict(), device="cuda")
    rng = np.random.default_rng(SEED)
    for n in (4, 16):
        z = rng.standard_normal((n, 512)).astype(np.float32)
        txt = rng.standard_normal((n, 512)).astype(np.float32)
        psi = np.full((n,), 0.7, np.float32)

        def call():
            images, _ = sampler.sample_raw(z, txt, psi)
            torch.cuda.synchronize()
            return images

        for _ in range(2):
            call()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            call()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            prof_wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:args.top]
        print(json.dumps({
            "batch": n, "wall_ms_median": statistics.median(walls), "wall_ms": walls,
            "profiled_wall_ms": prof_wall, "device_ms": device_ms,
            "device_busy_share": device_ms / prof_wall,
            # the fused-MoE kernels (every kernel of ops/csrc/fused_moe*.cu names "moe")
            "moe_device_ms": sum(e.self_device_time_total for e in events
                                 if "moe" in e.key) / 1e3,
            "kernels": [{"name": e.key[:90], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3} for e in top],
        }), flush=True)


if __name__ == "__main__":
    main()
