#!/usr/bin/env python3
"""Time the LayerNorm CUDA kernels of one tree of the port at the 64x64
training step's five norm shapes (`MOEGAN_FUSED_LN=1`).

Runs chip_smoke.py's phase 10 (a) (`layer_norm_phase`, this tree's) on the
`moegan_tpu_torch` of `--root`: at each shape (x [64 * res^2, C] bf16, res
4-64, C 512-32) both kernels against their plain twins, two calls
bit-identical, then `ms` (CUDA events, the host's cost per call included),
`device_ms` (the calls replayed from one CUDA graph, inputs hot in L2) and
`cold_device_ms` (the same over rotating input copies that move at least
100 MB a pass, so reads come from device memory), beside `F.layer_norm`'s,
and `host_us` (host time a call, enqueued without a synchronize). Inputs
are made on the card from a seed.

`--root` names the tree whose `moegan_tpu_torch` is imported and built (by
default this script's own), so one call can time two trees in turns:
    python3 scripts/torch_layernorm_bench.py --root .smoke/parent
    python3 scripts/torch_layernorm_bench.py
It prints the card's name and power limit, one JSON line per kernel and
shape, and a last JSON line with the sums over the five shapes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="the tree whose moegan_tpu_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke  # this tree's phase, before --root comes first on the path

    sys.path.insert(0, os.path.abspath(args.root))
    from moegan_tpu_torch.ops import _build
    from moegan_tpu_torch.ops import layernorm as tln

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"root {os.path.abspath(args.root)}; module {tln.__file__}; build "
          f"{_build.build_all():.1f} s", flush=True)
    fwd_rows, bwd_rows = chip_smoke.layer_norm_phase(torch.device("cuda"), tln)
    sums = {}
    for name, rows in (("fwd", fwd_rows), ("bwd", bwd_rows)):
        for key in ("ms", "device_ms", "cold_device_ms", "host_us", "library_ms",
                    "library_device_ms", "library_cold_device_ms", "plain_ms", "bound_ms"):
            sums[f"{name}_{key}"] = sum(r[key] for r in rows)
    print(json.dumps({"sums_over_five_shapes": sums, "device": smi}), flush=True)


if __name__ == "__main__":
    main()
