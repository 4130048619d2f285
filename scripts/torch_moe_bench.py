#!/usr/bin/env python3
"""Time the fused-MoE CUDA kernels of one tree of the port at the 64x64
generator's MoE shapes.

For each of the five MoE blocks (res 4-64, C = 512-32, F = 4C, E = 4, router
width 128): the soft forward at training batch 64 (`fused_moe_ffn`, hard=False),
the backward at batch 64 (`fused_moe_bwd`), the hard forward at serving batch
16, and the expert-parallel combine forward and backward at batch 64 with 2
local experts. Where the tree's `fused_moe_bwd` takes the forward's routing
(`probs=`, as `FusedMoEFunction` calls it), the backward is also timed so;
in this tree the call without `probs` first runs the forward kernel for the
routing.
The legacy backward's three entry points (`MOEGAN_PALLAS_MOE_BWD=3`) at
batch 64: `moe_bwd_dx`, `moe_bwd_dw2` and `moe_bwd_dw1`, each called without
the routing (the only call every tree takes: the first port's kernels compute
it themselves, this tree's entry points run the forward kernel for it); where
the tree's entry point takes the forward's routing (`probs=`, as
`FusedMoEFunction` calls them under =3), also so, with its plan.
`--what legacy` times these alone.
Each is timed with CUDA events over a run of calls (`ms`, the host's cost
per call included) and as the same calls replayed from one CUDA graph
(`device_ms`). Inputs are made on the card from a seed.

`--root` names the tree whose `moegan_tpu_torch` is imported and built (by
default this script's own), so one call can time two trees in turns:
    python3 scripts/torch_moe_bench.py --root .smoke/parent
    python3 scripts/torch_moe_bench.py
It prints the card's name and power limit, one JSON line per shape and a
last JSON line with the sums over the five blocks.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKS = ((4, 512), (8, 256), (16, 128), (32, 64), (64, 32))  # (res, C)


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after two warm-up calls (CUDA events)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device ms per call: `reps` calls captured in one CUDA graph, one replay timed."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def moe_args(dev, C, T, seed, E=4, hidden=128):
    """Inputs at the init scales, the router's weights scaled by 100 as
    chip_smoke.py scales them (routing clear of bf16 noise)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    F = 4 * C

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def ru(*shape, bound):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * bound

    return [rn(T, C).to(torch.bfloat16), rn(C, hidden, scale=0.01).to(torch.bfloat16),
            rn(hidden, E, scale=1.0), rn(T, E, scale=0.05), torch.full((1,), 0.25, device=dev),
            ru(E, C, F, bound=C ** -0.5).to(torch.bfloat16), ru(E, F, bound=C ** -0.5),
            ru(E, F, C, bound=F ** -0.5).to(torch.bfloat16), ru(E, C, bound=F ** -0.5)]


def both(fn, reps):
    return {"ms": time_ms(fn, reps), "device_ms": graph_ms(fn, reps)}


def add_sums(sums: dict, row: dict) -> None:
    for key, val in row.items():
        if isinstance(val, dict):
            for k, v in val.items():
                sums[f"{key}_{k}"] = sums.get(f"{key}_{k}", 0.0) + v


def legacy_rows(tfm, row, a, dout, C, reps) -> None:
    """The legacy entry points at one block, batch 64, into `row`."""
    x = a[0]
    dx_args, dw1_args, dw2_args = a, a[:8], a[:7]
    row["legacy_dx"] = both(lambda: tfm.moe_bwd_dx(*dx_args, dout), reps)
    row["legacy_dw2"] = both(lambda: tfm.moe_bwd_dw2(*dw2_args, dout), reps)
    row["legacy_dw1"] = both(lambda: tfm.moe_bwd_dw1(*dw1_args, dout), reps)
    p = tfm.fused_moe_ffn(*a, hard=False)[1]
    for name, fn, args in (("dx", tfm.moe_bwd_dx, dx_args), ("dw2", tfm.moe_bwd_dw2, dw2_args),
                           ("dw1", tfm.moe_bwd_dw1, dw1_args)):
        if "probs" not in inspect.signature(fn).parameters:
            continue
        row[f"legacy_{name}_given_probs"] = both(lambda: fn(*args, dout, probs=p), reps)
        if name != "dx":
            row[f"legacy_{name}_plan"] = list(tfm.legacy_kernel_plan(name, x.shape[0], C, 4 * C,
                                                                     4, x.device))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="the tree whose moegan_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--what", choices=("all", "legacy"), default="all",
                    help="all kernels, or the legacy backward's entry points alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from moegan_tpu_torch.ops import _build
    from moegan_tpu_torch.ops import fused_moe as tfm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"root {os.path.abspath(args.root)}; module {tfm.__file__}; build "
          f"{_build.build_all():.1f} s", flush=True)
    dev = torch.device("cuda")
    sums: dict[str, float] = {}
    for res, C in BLOCKS:
        row = {"res": res, "C": C}
        T = 64 * res * res
        a = moe_args(dev, C, T, seed=res)
        dout = (torch.randn((T, C), device=dev, generator=torch.Generator(device=dev)
                            .manual_seed(res + 1)) * 0.1).to(torch.bfloat16)
        legacy_rows(tfm, row, a, dout, C, max(2, args.reps // 2))
        if args.what == "legacy":
            del a, dout
            torch.cuda.empty_cache()
            add_sums(sums, row)
            print(json.dumps(row), flush=True)
            continue
        row["fwd_soft_b64"] = both(lambda: tfm.fused_moe_ffn(*a, hard=False), args.reps)
        row["bwd_b64"] = both(lambda: tfm.fused_moe_bwd(*a, dout), max(2, args.reps // 2))
        if "probs" in inspect.signature(tfm.fused_moe_bwd).parameters:
            # as FusedMoEFunction launches it where it can: with the forward's routing
            p = tfm.fused_moe_ffn(*a, hard=False)[1]
            row["bwd_b64_given_probs"] = both(lambda: tfm.fused_moe_bwd(*a, dout, probs=p),
                                              max(2, args.reps // 2))
        x, _, _, _, _, w1, b1, w2, b2 = a
        probs = torch.softmax(torch.randn((T, 4), device=dev) * 2, -1)[:, :2].contiguous()
        comb = (x, probs, w1[:2].contiguous(), b1[:2].contiguous(), w2[:2].contiguous(),
                b2[:2].contiguous())
        row["combine_fwd_b64_e2"] = both(lambda: tfm.moe_ffn_combine(*comb), args.reps)
        row["combine_bwd_b64_e2"] = both(lambda: tfm.moe_ffn_combine_bwd(*comb, dout),
                                         max(2, args.reps // 2))
        del a, dout, comb
        a = moe_args(dev, C, 16 * res * res, seed=res + 100)
        row["fwd_hard_b16"] = both(lambda: tfm.fused_moe_ffn(*a, hard=True), args.reps)
        del a
        torch.cuda.empty_cache()
        add_sums(sums, row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"sums_over_five_blocks": sums, "device": smi}), flush=True)


if __name__ == "__main__":
    main()
