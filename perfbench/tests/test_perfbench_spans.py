"""The readers of the program's spans (`harness.spans` and the metrics that
use it): nothing to read gives no metric, the upsample's least bytes at the
configurations' widths, and the entries of BENCHMARK.json that name them."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from perfbench.counts import kernels
from perfbench.harness import runner, spans
from perfbench.reference.model import channels

BENCH = runner.load_json(runner.ROOT / "BENCHMARK.json")
SPAN_METRICS = ["upsample_roofline.train.aurora64", "upsample_roofline.train.flagship",
                "upsample_roofline.gen", "d_phase_ms.train.aurora64",
                "d_phase_ms.train.flagship", "g_phase_ms.train.aurora64",
                "g_phase_ms.train.flagship", "adamw_ms.train.aurora64",
                "adamw_ms.train.flagship"]
UPSAMPLES = (8, 16, 32, 64)


def _config(name):
    path = runner.ROOT / "perfbench" / "configs" / f"{name}.json"
    return json.loads(path.read_text())


def _reader(name):
    return runner.load_module(runner.BENCH_DIR / "metrics" / f"{name}.py", "m_" + name)


def _ctx(config="aurora64"):
    return SimpleNamespace(config=_config(config), host={"batch": 256, "units": 3},
                           trace=None, extra={})


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_is_silent_with_nothing_recorded(name, monkeypatch):
    reader = _reader(name)
    assert reader.read(_ctx()) is None  # no card here
    for recorded in ({}, {"moegan.step": {"count": 3, "host_ms": 1.0, "device_ms": None,
                                          "self_device_ms": None}}):
        monkeypatch.setattr(spans, "recorded", lambda r=recorded: r)
        assert reader.read(_ctx()) is None


def test_program_without_a_recorder_reads_nothing(monkeypatch):
    from moegan_tpu_torch.utils import profiling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delattr(profiling, "summary")
    assert spans.recorded() is None


@pytest.mark.parametrize("config,need_ms,elements", [("aurora64", 0.0939, 122_880),
                                                     ("flagship", 0.1815, 237_568)])
def test_upsample_need_a_forward(config, need_ms, elements):
    g = _config(config)["train_config"]["generator"]
    ch = channels(g)
    assert sum((r // 2) ** 2 * ch[r // 2] for r in UPSAMPLES) == elements
    one = sum(spans.upsample_bytes(256, r, ch) for r in UPSAMPLES) / kernels.PEAK_BYTES * 1e3
    assert one == pytest.approx(need_ms, rel=1e-3)
    # two forwards a step, each upsample span 5 ms of device time
    recorded = {f"moegan.g.r{r}.upsample": {"count": 2, "host_ms": 1.0, "device_ms": 10.0,
                                           "self_device_ms": 10.0} for r in UPSAMPLES}
    share = spans.upsample_roofline(recorded, g, 256)
    assert share == pytest.approx(100.0 * 2 * one / 40.0, rel=1e-9)


def test_phase_readers_divide_by_the_root_spans(monkeypatch):
    def entry(count, ms):
        return {"count": count, "host_ms": ms, "device_ms": ms, "self_device_ms": ms}

    recorded = {"moegan.step": entry(6, 1800.0), "moegan.step.d_phase": entry(6, 900.0),
                "moegan.step.g_phase": entry(6, 600.0), "moegan.step.d_adamw": entry(6, 12.0),
                "moegan.step.g_adamw": entry(6, 18.0), "moegan.sample": entry(2, 50.0)}
    monkeypatch.setattr(spans, "recorded", lambda: recorded)
    for config in ("aurora64", "flagship"):
        ctx = _ctx(config)
        assert _reader(f"d_phase_ms.train.{config}").read(ctx) == 150.0
        assert _reader(f"g_phase_ms.train.{config}").read(ctx) == 100.0
        assert _reader(f"adamw_ms.train.{config}").read(ctx) == 5.0
    assert spans.device_ms_per_root(recorded, spans.SAMPLE, ("moegan.step.d_phase",)) == 450.0
    assert spans.device_ms_per_root(recorded, "moegan.none", ("moegan.step.d_phase",)) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_entry_lists_its_cells_and_what_it_moves(name):
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert m["source"] == "device_trace" and m["workloads"]
    config = "aurora64" if name.endswith((".aurora64", ".gen")) else "flagship"
    cells = {c["name"]: c for c in BENCH["workloads"]}
    for w in m["workloads"]:
        assert cells[w]["config"] == config
        e2e = {e["name"] for e in runner.reported_metrics(BENCH, w, False)}
        assert m["moves"] in e2e
    assert BENCH["per_layer"][-len(SPAN_METRICS):] == [
        m for n in SPAN_METRICS for m in BENCH["per_layer"] if m["name"] == n]
