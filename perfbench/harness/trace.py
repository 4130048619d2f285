"""The profiled stretch at the end of a traced run, read from torch.profiler.

The driver runs a whole number of steps or calls inside `stretch()`, which
synchronises the card at both ends inside a span named STRETCH; the
stretch's window is that span. From the trace:
  - kernels: every kernel the card ran in the window (name, start, end);
  - busy_s: the union of the intervals in which any device operation
    (kernel, copy, set) ran, within the window;
  - the breakdown: the kernels that took most device time, by name, and
    the longest idle gaps, each labelled by the benchmark's span and the
    innermost host operation running when the gap began.
A second stretch, `api_stretch()`, traces only the CUDA API calls, for the
host's own cost of a call (`host_cost`, below).
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass

import torch

STRETCH = "perfbench.stretch"
TOP = 10


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list  # [(name, start_ns, end_ns)]
    units: int  # steps or calls in the window
    breakdown: dict

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches `pattern` (re.search)."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.kernels if rx.search(n)) * 1e-9



@contextlib.contextmanager
def stretch():
    """Profile the block; yields a holder whose `.profile` is set on exit."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    holder = type("Holder", (), {})()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(STRETCH):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            yield holder
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    holder.profile = prof


def short_name(name: str) -> str:
    """A kernel's name without its argument list, anonymous namespaces or a
    leading 'void '."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name.removeprefix("void ")[:160]


def _kind(name: str, on_card: bool, annotation: bool) -> str | None:
    """"kernel", "device" (a copy or set), "annotation" (a span) or "op" (a host
    operation); None for the card's copies of host spans."""
    if on_card:
        if annotation or name.startswith("perfbench."):
            return None
        return "device" if name.startswith(("Memcpy", "Memset")) else "kernel"
    return "annotation" if annotation or name.startswith("perfbench.") else "op"


def _events(prof):
    """[(kind, name, start_ns, end_ns)] of the profiled stretch (see `_kind`)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_card = str(e.device_type()).rsplit(".", 1)[-1] == "CUDA"
        is_annotation = getattr(e, "is_user_annotation", None)
        kind = _kind(name, on_card, bool(is_annotation()) if is_annotation else False)
        if kind is not None:
            out.append((kind, name, e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _union(intervals, lo, hi):
    """Merged [s, e) intervals clipped to [lo, hi)."""
    merged = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(t: int, annotations, ops) -> str:
    """The innermost benchmark span and host operation running at time t."""
    def innermost(events):
        best = None
        for name, s, e in events:
            if s <= t < e and (best is None or s > best[1]):
                best = (name, s)
        return best[0] if best else "-"

    return f"{innermost(annotations)} / {innermost(ops)}"


def read(prof, units: int) -> Trace:
    events = _events(prof)
    windows = [(s, e) for k, n, s, e in events if k == "annotation" and n == STRETCH]
    if not windows:
        raise RuntimeError(f"the trace holds no {STRETCH} span")
    lo, hi = windows[0]
    kernels = sorted((n, s, e) for k, n, s, e in events if k == "kernel" and s < hi and e > lo)
    device = [(s, e) for k, n, s, e in events if k in ("kernel", "device")]
    busy = _union(device, lo, hi)
    busy_ns = sum(e - s for s, e in busy)
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    by_name: dict[str, float] = {}
    for n, s, e in kernels:
        key = short_name(n)
        by_name[key] = by_name.get(key, 0.0) + (min(e, hi) - max(s, lo)) * 1e-9
    annotations = [(n, s, e) for k, n, s, e in events if k == "annotation" and n != STRETCH]
    ops = [(n, s, e) for k, n, s, e in events if k == "op"]
    longest = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:TOP]
    breakdown = {
        "device_ops": [[n, v] for n, v in sorted(by_name.items(), key=lambda x: -x[1])[:TOP]],
        "idle_gaps": [[_label(s, annotations, ops), (e - s) * 1e-9] for s, e in longest],
    }
    return Trace(window_s=(hi - lo) * 1e-9, busy_s=busy_ns * 1e-9, kernels=kernels, units=units,
                 breakdown=breakdown)


# --- the host's own cost of a call --------------------------------------------------------
#
# A host clock around a call that is never synchronised reads the card's pace
# once the launch queue is full: the host then blocks inside the launching call
# until the card has room. So the host's own cost is read from a second stretch
# that traces only the CUDA API calls (CUPTI, about a microsecond a call; no
# host-op recording, whose cost per op would inflate what is read): the call's
# wall time on the host, less the part of each CUDA API call inside it that
# lies beyond a typical kernel launch's cost (the median launch call of the
# stretch). That part is time the host spent waiting for the card: a full
# queue, a synchronisation, a copy that waits for its data.

LAUNCH = re.compile(r"LaunchKernel")


@contextlib.contextmanager
def api_stretch():
    """Trace the CUDA API calls of the block; yields a holder whose `.profile` is
    set on exit (None without a card). Profiler events and `time.time_ns()` share
    one clock, so intervals marked with `time.time_ns()` inside the block locate
    the calls."""
    holder = type("Holder", (), {})()
    holder.profile = None
    if not torch.cuda.is_available():
        yield holder
        return
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        yield holder
        torch.cuda.synchronize()
    holder.profile = prof


def _api_calls(prof):
    """[(name, start_ns, end_ns)] of the outermost CUDA runtime and driver API
    calls (a driver call made inside a runtime call is left out)."""
    calls = []
    for e in prof.profiler.kineto_results.events():
        on_card = str(e.device_type()).rsplit(".", 1)[-1] == "CUDA"
        name = e.name()
        if not on_card and re.match(r"cu[A-Z]|cuda[A-Z]", name):
            calls.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
    out = []
    for c in sorted(calls, key=lambda c: (c[1], -c[2])):
        if not out or c[1] >= out[-1][2]:
            out.append(c)
    return out


def host_cost(prof, intervals) -> dict | None:
    """The host's own cost of the calls marked by `intervals` ([(start_ns, end_ns)],
    from `time.time_ns()`): {"wall_s", "blocked_s", "own_s", "typical_launch_us",
    "calls", "units", "blocked_by_call": {name: s}}; None where the trace holds
    no kernel launch inside them (no card, or a profiler that recorded no API
    call)."""
    if prof is None:
        return None
    calls = [c for c in _api_calls(prof) if any(a <= c[1] < b for a, b in intervals)]
    launches = sorted(e - s for n, s, e in calls if LAUNCH.search(n))
    if not launches:
        return None
    typical = launches[len(launches) // 2]
    blocked, by_call = 0, {}
    for n, s, e in calls:
        a, b = next((a, b) for a, b in intervals if a <= s < b)
        extra = max(0, min(e, b) - s - typical)
        blocked += extra
        by_call[n] = by_call.get(n, 0.0) + extra * 1e-9
    wall = sum(b - a for a, b in intervals)
    return {"wall_s": wall * 1e-9, "blocked_s": blocked * 1e-9,
            "own_s": (wall - blocked) * 1e-9, "typical_launch_us": typical * 1e-3,
            "calls": len(calls), "units": len(intervals),
            "blocked_by_call": dict(sorted(by_call.items(), key=lambda x: -x[1])[:TOP])}
