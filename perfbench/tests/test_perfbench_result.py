"""A whole run of each cell's harness at the tiny configuration on the CPU
(the look for a card skipped): the shape of the result line, and `correct`
false when the timed path is broken underneath or the control is put in the
program's place."""

from __future__ import annotations

import json
import math
import time

import pytest

from perfbench.controls.readings import FAULTS, control_numbers
from perfbench.harness import runner, trace
from perfbench.tests.tiny import tiny_parts

BENCH = runner.load_json(runner.ROOT / "BENCHMARK.json")
CELLS = [c["name"] for c in BENCH["workloads"]]
SEED = 2**31 + 12345  # more than 32 signed bits hold


def _run(cell, trace, fault=None, seed=SEED):
    parts = tiny_parts(BENCH, cell)
    out = runner.run_cell(parts, seed, 0.3, trace, "cpu", time.perf_counter(), fault=fault,
                          log=lambda *a, **k: None)
    specs = runner.reported_metrics(BENCH, cell, trace)
    return runner.result_line(parts, out, specs, trace, {"platform": "cpu", "count": 1})


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line_shape(cell, trace):
    res = _run(cell, trace)
    line = json.loads(json.dumps(res))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "compared"
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    names = set(line["metrics"])
    if trace:
        assert "setup_s" not in names and "breakdown" in line
        assert {"busy_s", "window_s"} <= set(line["device"])
        per_layer = {m["name"] for m in runner.reported_metrics(BENCH, cell, True)}
        assert names <= per_layer
        # the device-trace readers find nothing on the CPU and leave their metric out
        assert not any("roofline" in n or "idle" in n or "launches" in n for n in names)
    else:
        e2e = {m["name"] for m in runner.reported_metrics(BENCH, cell, False)}
        assert names == e2e
    for c in line["compared"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c, d in (("aurora64.train.b256", "train_loop"),
                                                            ("aurora64.generate.b256",
                                                             "generate_loop"))
                                        for f in FAULTS[d]])
def test_broken_timed_path_is_not_correct(cell, fault):
    assert _run(cell, False, fault)["correct"] is False


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("cell", ["aurora64.train.b256", "aurora64.generate.b256"])
def test_fp8_control_is_not_correct(cell, seed):
    parts = tiny_parts(BENCH, cell)
    ok, _ = runner.compare(control_numbers(parts, seed, 0.3, "cpu"), parts["limits"])
    assert ok is False


class _Event:
    def __init__(self, name, start_us, dur_us, device="DeviceType.CPU"):
        self._n, self._s, self._d, self._dev = name, int(start_us * 1e3), int(dur_us * 1e3), device

    def name(self):
        return self._n

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_host_cost_leaves_out_the_waits_for_the_card():
    """A launch that blocks on a full queue, a synchronisation and a driver call
    nested in a runtime call: only what lies beyond a typical launch is waiting."""
    events = [_Event("cudaLaunchKernel", t, 5) for t in (10, 20, 30, 40)]
    events += [_Event("cudaLaunchKernel", 50, 1005),  # blocked 1000 us
               _Event("cuLaunchKernel", 51, 1000),  # inside the call above
               _Event("cudaStreamSynchronize", 2000, 2005),  # blocked 2000 us
               _Event("flash_fwd_kernel", 60, 900, "DeviceType.CUDA"),
               _Event("cudaLaunchKernel", 9000, 5000)]  # outside the marked call
    prof = type("P", (), {})()
    prof.profiler = type("K", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: events})()
    c = trace.host_cost(prof, [(0, 5_000_000)])
    assert c["units"] == 1 and c["calls"] == 6
    assert c["typical_launch_us"] == 5
    assert c["blocked_s"] == pytest.approx(3000e-6)
    assert c["own_s"] == pytest.approx(5000e-6 - 3000e-6)
    assert trace.host_cost(None, [(0, 1)]) is None
