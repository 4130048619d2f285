"""BENCHMARK.json: every name resolves to its file, and names, units and
keys keep the benchmark's rules."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PB = ROOT / "perfbench"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    configs = {c["name"]: c for c in BENCH["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    assert {"train_config", "router_scale"} <= set(config)
    traffic = json.loads((PB / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (PB / "drivers" / f"{traffic['driver']}.py").is_file()
    limits = json.loads((PB / "limits" / f"{cell['name']}.json").read_text())
    assert limits and all(v > 0 for v in limits.values())
    from perfbench.harness import runner

    e2e = {m["name"] for m in runner.reported_metrics(BENCH, cell["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert runner.reported_metrics(BENCH, cell["name"], True)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("perfbench/") and (ROOT / config["file"]).is_file()
    assert config["reduced"] == []
    assert 1 <= len(config["source"]) <= 200 and "\n" not in config["source"]
    assert json.loads((ROOT / config["file"]).read_text())["source"] == config["source"]


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= METRIC_KEYS | {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= METRIC_KEYS | {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert metric["workloads"], "a per-layer metric lists its cells"
        assert 1 <= len(metric["layer"]) <= 200
    for w in metric.get("workloads", ()):
        assert w in {c["name"] for c in BENCH["workloads"]}
    if metric["name"] != "setup_s":
        path = PB / "metrics" / f"{metric['name']}.py"
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)
    if metric["unit"] == "%" and ("roofline" in metric["name"] or "mfu" in metric["name"]):
        assert metric["better"] == "higher"


def test_names_unique_and_plain():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for path in PB.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel
