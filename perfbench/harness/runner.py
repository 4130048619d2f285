"""One run of one cell: set up, measure, check, print the result line.

Everything here is general. The cell's entry in BENCHMARK.json names its
configuration (`file`), its traffic mix (`perfbench/traffic/<traffic>.json`,
which names its driver, `perfbench/drivers/<driver>.py`), and the metrics
it reports (`perfbench/metrics/<metric>.py`, each with `read(ctx)`); the
limits of its comparison are `perfbench/limits/<cell>.json`. Adding a
cell, a configuration, a traffic mix or a metric adds files and entries
and edits none of these.

A driver module has `compile()` (build what the program builds; returns
seconds) and `Driver(config, traffic, seed, device, fault)` with
`setup()`, `window(seconds, trace) -> Window`, `release()` and
`check() -> {number: value}`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
CACHE = ROOT / ".perfbench_cache"  # a fixed place inside the checkout


@dataclass
class Window:
    attempted: int
    failed: int
    host: dict  # host-clock readings for the metric readers
    trace: object | None  # harness.trace.Trace in a traced run
    extra: dict | None = None  # anything else the readers of this driver read


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_parts(bench: dict, workload: str) -> dict:
    """The cell's entry and everything it names, loaded by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": load_json(BENCH_DIR / "limits" / f"{workload}.json")}


def reported_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off): those that list it under
    `workloads`, and those that list no cells, which every cell reports; or its
    per-layer metrics (trace on): those that list it. A per-layer metric lists
    its cells."""
    if not trace:
        return [m for m in bench["end_to_end"] if workload in m.get("workloads", (workload,))]
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise KeyError(f"per-layer metric {m['name']!r} lists no workloads")
    return [m for m in bench["per_layer"] if workload in m["workloads"]]


def read_metrics(specs: list[dict], ctx) -> dict:
    out = {}
    for m in specs:
        if m["name"] == "setup_s":
            continue
        reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                             "perfbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def set_cache_dirs() -> None:
    """Kernel and extension caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def run_cell(parts: dict, seed: int, seconds: float, trace: bool, device, t0: float,
             fault: str | None = None, log=print) -> dict:
    """Set up, measure and check one cell on `device`; returns the pieces of the
    result line (without `device`'s card fields)."""
    import torch

    traffic, config = parts["traffic"], parts["config"]
    for var in traffic.get("unset_env", ()):
        if os.environ.get(var) is not None:
            raise RuntimeError(f"{var}={os.environ[var]} is set: the traffic mix runs the "
                               f"default kernel route, with it unset")
    drv_mod = load_module(BENCH_DIR / "drivers" / f"{traffic['driver']}.py",
                          "perfbench_driver_" + traffic["driver"])
    compile_s = drv_mod.compile(device)
    driver = drv_mod.Driver(config, traffic, seed, device, fault)
    driver.setup()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0 - compile_s
    log(f"setup_s {setup_s} compile_s {compile_s}", file=sys.stderr, flush=True)
    window = driver.window(seconds, trace)
    if torch.device(device).type == "cuda":
        from perfbench.harness.device import smi_now

        log(f"card after the window: {smi_now()}", file=sys.stderr, flush=True)
    log(host_summary(window.host), file=sys.stderr, flush=True)
    peak = (torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda"
            else 0)
    driver.release()
    numbers = driver.check()
    return {"setup_s": setup_s, "compile_s": compile_s, "window": window,
            "memory_peak_bytes": int(peak), "numbers": numbers,
            "notes": getattr(driver, "notes", {})}


def host_summary(host: dict) -> str:
    """One line of the window's host clock: each per-unit list's median, 90th
    percentile and largest value, in ms."""
    import numpy as np

    parts = [f"host: {host['units']} units in {host['seconds']:.3f} s"]
    for k, v in host.items():
        if isinstance(v, list) and v:
            a = np.asarray(v) * 1e3
            parts.append(f"{k} ms p50 {np.median(a):.2f} p90 {np.percentile(a, 90):.2f} "
                         f"max {a.max():.2f}")
    return "; ".join(parts)


def compare(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each limited number against its limit (value <= limit); a limited number
    that the check did not give, or that is not finite, fails."""
    compared, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        good = math.isfinite(value) and value <= limit
        ok &= good
        compared[name] = {"value": value, "limit": limit}
    return ok, compared


def result_line(parts: dict, out: dict, specs: list[dict], trace: bool, device: dict) -> dict:
    """The result line: correct, attempted, failed, metrics, device, breakdown (traced
    runs), and last the compared numbers with their limits."""
    window = out["window"]
    ctx = SimpleNamespace(config=parts["config"], traffic=parts["traffic"], host=window.host,
                          trace=window.trace, extra=window.extra or {})
    metrics = read_metrics(specs, ctx)
    if not trace:
        metrics["setup_s"] = {"value": out["setup_s"], "unit": "s"}
    correct, compared = compare(out["numbers"], parts["limits"])
    device = {**device, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": window.attempted, "failed": window.failed,
              "metrics": metrics, "device": device}
    if trace and window.trace is not None:
        device["busy_s"] = window.trace.busy_s
        device["window_s"] = window.trace.window_s
        result["breakdown"] = window.trace.breakdown
    result["compared"] = compared
    return result


def main(argv, t0: float) -> int:
    p = argparse.ArgumentParser(description="Run one benchmark cell on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    parts = cell_parts(bench, args.workload)
    specs = reported_metrics(bench, args.workload, bool(args.trace))
    set_cache_dirs()

    import torch

    from perfbench.harness import device as dev_mod

    chips = parts["cell"]["chips"]
    try:
        dev_mod.require_cards(chips)
    except dev_mod.NoCard as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    card = dev_mod.smi()
    # One intra-op CPU thread, as torchrun starts each worker: the loader's gather
    # threads and the main thread issuing launches then share the cores with no
    # pool of spinning workers.
    torch.set_num_threads(1)
    out = run_cell(parts, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    bad = dev_mod.forbidden_loaded()
    if bad:
        print(f"perfbench: the process holds modules of the JAX stack: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips, **card}
    result = result_line(parts, out, specs, bool(args.trace), device)
    for name, note in out["notes"].items():
        print(f"note {name} {note}", file=sys.stderr)
    for name, value in (out["window"].extra or {}).items():
        print(f"traced {name} {value}", file=sys.stderr)
    for name, v in sorted(out["numbers"].items()):
        if name not in result["compared"]:
            print(f"reading {name} {v} (not compared)", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
