"""Readings that the limits of a cell's comparison are set from, on the card.

    python3 perfbench/controls/readings.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...] [--seconds 2]

For each of `--seeds`: a run of the cell as the benchmark makes it (set-up,
a short window at the cell's own load, the check), and its numbers. For
each of `--control-seeds`: the control, the reference itself put in the
program's place at float8 (e4m3) products (`reference.precision.FP8`), on
the inputs that seed gives, judged as the program is. For each of
`--fault-seeds`: a run with each fault the cell can have planted in the
timed path (`FAULTS`). One JSON line a reading on standard output.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

FAULTS = {"train_loop": ("frozen", "half_batch", "altered"),
          "generate_loop": ("stale", "half_batch", "altered")}


def control_numbers(parts: dict, seed: int, seconds: float, device) -> dict:
    """The FP8 reference in the program's place, on the seed's inputs."""
    from perfbench.harness import judge
    from perfbench.harness import weights as W
    from perfbench.harness.runner import BENCH_DIR, load_module
    from perfbench.reference.precision import PRECISIONS

    traffic, config = parts["traffic"], parts["config"]
    drv_mod = load_module(BENCH_DIR / "drivers" / f"{traffic['driver']}.py",
                          "perfbench_driver_" + traffic["driver"])
    drv = drv_mod.Driver(config, traffic, seed, device)
    drv.setup()
    if traffic["driver"] == "generate_loop":
        drv.window(seconds, False)
    drv.release()
    weights = W.make_weights(drv.stats, seed, device, config["router_scale"])
    fp8 = PRECISIONS["fp8"]
    if traffic["driver"] == "train_loop":
        steps = traffic["split"] // traffic["batch"]
        ref = judge.reference_training(config, weights, drv.checked, drv.schedule, steps, device)
        low = judge.reference_training(config, weights, drv.checked, drv.schedule, steps, device,
                                       fp8)
        return judge.training_numbers(low, ref)[0]
    calls = judge.reference_calls(config, weights, drv.kept, device, fp8)
    return judge.generation_numbers(config, weights, calls, device)


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from perfbench.harness import runner

    bench = runner.load_json(runner.ROOT / "BENCHMARK.json")
    parts = runner.cell_parts(bench, args.workload)
    runner.set_cache_dirs()
    faults = FAULTS[parts["traffic"]["driver"]]
    jobs = ([("program", s, None) for s in args.seeds]
            + [("control_fp8", s, None) for s in args.control_seeds]
            + [(f"fault_{f}", s, f) for s in args.fault_seeds for f in faults])
    for kind, seed, fault in jobs:
        t0 = time.perf_counter()
        if kind == "control_fp8":
            numbers = control_numbers(parts, seed, args.seconds, args.device)
            notes = {}
        else:
            out = runner.run_cell(parts, seed, args.seconds, False, args.device, t0, fault=fault,
                                  log=lambda *a, **k: None)
            numbers, notes = out["numbers"], out["notes"]
        print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                          "numbers": numbers, "notes": {k: v for k, v in notes.items()
                                                        if k != "left_out"},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))))
    sys.exit(main(sys.argv[1:]))
