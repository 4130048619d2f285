#!/usr/bin/env python3
"""Where a training step's time goes, for the PyTorch port on one GPU.

Builds the default 64x64 `TrainConfig` state from a seed on the card and
runs `make_train_step` at batch 64 on a synthetic batch (as chip_smoke.py
does): 3 warm-up steps, host wall time per step around a CUDA synchronize
(median of 5), then one step under `torch.profiler` for the device time by
kernel and the device's busy share.

Run from the repository root on a machine with a CUDA device:
    python3 scripts/torch_train_profile.py [--batch 64] [--top 20]
It prints the card's name and power limit, then one JSON line. The opt-in
kernel configuration (the LayerNorm kernels and the legacy three-kernel MoE
backward) is profiled with `MOEGAN_FUSED_LN=1 MOEGAN_PALLAS_MOE_BWD=3` in the
environment; the JSON line names the two flags as it found them, and gives the
MoE kernels' device time (`moe_device_ms`, `moe_bwd_device_ms`) and the
LayerNorm kernels' (`ln_device_ms`).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import SEED, epoch0_schedule, synthetic_batch
    from moegan_tpu_torch.config import TrainConfig
    from moegan_tpu_torch.train.state import create_train_state
    from moegan_tpu_torch.train.step import make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    cfg = TrainConfig(batch_size=args.batch)
    state = create_train_state(cfg, device="cuda", seed=SEED)
    step = make_train_step(cfg)
    batch = synthetic_batch(cfg.batch_size, cfg.generator.max_resolution, SEED + 3, "cuda")
    sched = epoch0_schedule(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def call():
        step(state, batch, sched, generator=gen)
        torch.cuda.synchronize()

    for _ in range(3):
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
        "batch": cfg.batch_size,
        "flags": {k: os.environ.get(k) for k in ("MOEGAN_FUSED_LN", "MOEGAN_PALLAS_MOE_BWD")},
        "wall_ms_median": statistics.median(walls), "wall_ms": walls,
        "images_per_s": cfg.batch_size / statistics.median(walls) * 1e3,
        "profiled_wall_ms": prof_wall, "device_ms": device_ms,
        "device_busy_share": device_ms / prof_wall,
        # the fused-MoE kernels (every kernel of ops/csrc/fused_moe*.cu names "moe")
        "moe_device_ms": sum(e.self_device_time_total for e in events
                             if "moe" in e.key) / 1e3,
        # their backward alone: all but the forward's two kernels
        "moe_bwd_device_ms": sum(e.self_device_time_total for e in events
                                 if "moe" in e.key and "moe_fwd_kernel" not in e.key
                                 and "moe_split_sum_kernel" not in e.key) / 1e3,
        # the LayerNorm kernels under MOEGAN_FUSED_LN=1 (csrc/layer_norm.cu names them ln_*)
        "ln_device_ms": sum(e.self_device_time_total for e in events
                            if re.search(r"(^|::|\s)ln_\w*kernel", e.key)) / 1e3,
        "kernel_launches": sum(e.count for e in events),
        "kernels": [{"name": e.key[:90], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3} for e in top],
    }), flush=True)


if __name__ == "__main__":
    main()
