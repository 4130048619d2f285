"""Nothing the benchmark loads is of the JAX stack, and the reference loads
nothing of the program. Each check runs in a fresh interpreter, so that
what the test runner itself has imported does not count."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import sys, time
sys.path.insert(0, {root!r})
from perfbench.harness import device, runner
from perfbench.tests.tiny import tiny_parts
bench = runner.load_json(runner.ROOT / "BENCHMARK.json")
for cell in bench["workloads"]:
    parts = tiny_parts(bench, cell["name"])
    out = runner.run_cell(parts, 7, 0.2, True, "cpu", time.perf_counter(),
                          log=lambda *a, **k: None)
    specs = runner.reported_metrics(bench, cell["name"], True)
    runner.result_line(parts, out, specs, True, {{"platform": "cpu"}})
    runner.read_metrics(runner.reported_metrics(bench, cell["name"], False), __import__(
        "types").SimpleNamespace(config=parts["config"], traffic=parts["traffic"],
        host=out["window"].host, trace=None, extra={{}}))
import perfbench.controls.readings
print("LOADED", " ".join(device.forbidden_loaded()))
print("PROGRAM", any(m.split(".")[0] == "moegan_tpu_torch" for m in sys.modules))
"""

REFERENCE = """
import sys
sys.path.insert(0, {root!r})
import perfbench.reference.model, perfbench.reference.train, perfbench.reference.precision
import perfbench.counts.model, perfbench.counts.kernels
print("PROGRAM", sorted(m for m in sys.modules
                        if m.split(".")[0] in ("moegan_tpu_torch", "moegan_tpu", "jax")))
"""


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_a_run_loads_no_jax():
    out = _run(RUN)
    assert "LOADED \n" in out or out.split("LOADED", 1)[1].split("\n")[0].strip() == ""
    # the port itself is loaded: moegan_tpu_torch only begins with moegan_tpu
    assert "PROGRAM True" in out


def test_reference_loads_nothing_of_the_program():
    assert "PROGRAM []" in _run(REFERENCE)


def test_forbidden_names_compare_whole():
    from perfbench.harness import device

    sys.modules.setdefault("moegan_tpu_torch_lookalike", sys)
    try:
        assert "moegan_tpu_torch_lookalike" not in device.forbidden_loaded()
    finally:
        del sys.modules["moegan_tpu_torch_lookalike"]
