"""Profiling and device memory telemetry (counterpart of moegan_tpu/utils/profiling.py).

- `enable_debug_mode(nans=True)`: autograd's anomaly mode with NaN checks,
  which traps a NaN where the backward creates it (not in a forward).
- `trace(logdir)`: a `torch.profiler` trace of the CPU and, when there is
  a card, CUDA activity, written to `logdir` as a Chrome trace.
- `device_memory_stats()`: the JAX module's per-device keys, from
  `torch.cuda`.
- `MemoryMonitor`: watermarks every `interval` steps, with a warning above
  `limit_fraction` of the card's memory.
- `span(name)`: the program's layer spans, recorded while a torch profiler
  session runs (`trace` here, or any other `torch.profiler.profile`) and a
  shared no-op otherwise; `count(name, value)`: always-on named sums;
  `summary()`: count, host ms, device ms and self device ms by span name,
  and the counters; `reset()`.

Span names (each built once, when its module is constructed):
  moegan.step                       one training step (`train/step.py`), with
    .d_phase (.r1, .d_backward), .d_adamw, .g_phase (.g_backward), .g_adamw,
    .metrics
  moegan.g                          one generator forward, with .mapping and
    moegan.g.r{r}                   one generative block and its RGB tap, with
      .upsample .conv .self_attn .cross_attn .moe .to_rgb
  moegan.d                          one discriminator forward
  moegan.loader.gather              the loader's worker thread (host only)
  moegan.loader.wait / .to_device   the consumer's queue wait; pin + copy
  moegan.sample                     `Sampler.sample_raw`
  moegan.serve.dispatch             `MicroBatcher._run`
Counters: serve.requests, serve.queue_wait_s (`infer/serving.py`).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time

import torch
from torch.profiler import record_function

logger = logging.getLogger("moegan_tpu_torch")


def enable_debug_mode(nans: bool = True) -> None:
    """With `nans`, turn on `torch.autograd.set_detect_anomaly(True, check_nan=True)`:
    a backward function that returns a NaN raises, naming the forward
    operation that made it. Unlike `jax_debug_nans`, a NaN made by a forward
    operation is not trapped until it reaches a backward."""
    if nans:
        torch.autograd.set_detect_anomaly(True, check_nan=True)


@contextlib.contextmanager
def trace(logdir: str = "moegan_trace"):
    """Profile the block: `with trace(dir): step(...)` writes a Chrome trace
    (`trace_<pid>.json`) and the block's span summary (`spans_<pid>.json`,
    `summary()` of the spans the block recorded) into `dir` and yields `dir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    first = len(RECORDER.records)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))
    with open(os.path.join(logdir, f"spans_{os.getpid()}.json"), "w") as f:
        json.dump(RECORDER.summary(first), f, indent=1)


def device_memory_stats() -> list[dict]:
    """One dict per CUDA device with the JAX keys `device`, `bytes_in_use`,
    `peak_bytes_in_use` and `bytes_limit` (bytes); on a run without a card,
    one entry for the CPU with None values."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": None, "peak_bytes_in_use": None,
                 "bytes_limit": None}]
    return [{"device": f"cuda:{i}", "bytes_in_use": torch.cuda.memory_allocated(i),
             "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
             "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
            for i in range(torch.cuda.device_count())]


class MemoryMonitor:
    """Log device memory watermarks every `interval` steps; `peak` keeps the
    largest peak bytes seen. `device` limits the watch to one device."""

    def __init__(self, interval: int = 10, limit_fraction: float = 0.8, device=None):
        self.interval = interval
        self.limit_fraction = limit_fraction
        self.device = torch.device(device) if device is not None else None
        self.peak = 0

    def step(self, step_idx: int):
        """The stats of `device_memory_stats` at every `interval`-th step, else None."""
        if step_idx % self.interval:
            return None
        stats = device_memory_stats()
        if self.device is not None:
            name = (f"cuda:{self.device.index or 0}" if self.device.type == "cuda"
                    else self.device.type)
            stats = [s for s in stats if s["device"] == name]
        for s in stats:
            used, limit = s["bytes_in_use"], s["bytes_limit"]
            if used is None:
                continue
            self.peak = max(self.peak, s["peak_bytes_in_use"] or used)
            if limit and used > self.limit_fraction * limit:
                logger.warning("device memory high-water: %s using %.2f/%.2f GB",
                               s["device"], used / 1e9, limit / 1e9)
        return stats


# --- layer spans --------------------------------------------------------------------------
#
# A span costs nothing measurable unless a torch profiler session runs: one
# bool read, then the shared no-op context. While one runs, a span enters
# `record_function(name)` (the kineto trace then names the span on the device
# trace's clock; the profiler is thread-local, so spans of threads it was not
# started on reach only this recorder), keeps its host interval by
# `time.time_ns()` (the clock kineto's events share) and, on the card, two
# pooled timing events on a stream. A root span with `device` asks once
# whether and where the card can time it (CUDA initialised, the current
# stream, not being captured into a graph); its spans inherit the stream,
# since each stream query costs as much as an event record. Device times are read at
# `summary()`, which synchronises once and returns the events to the pool.

SPAN_CAP = 200_000  # records kept; later spans are counted in `dropped`

_OFF = contextlib.nullcontext()

if hasattr(torch.autograd.profiler, "_is_profiler_enabled"):
    _autograd_profiler = torch.autograd.profiler

    def profiler_on() -> bool:
        """Whether a torch profiler session runs (a plain bool torch keeps)."""
        return _autograd_profiler._is_profiler_enabled
else:  # pragma: no cover - older or newer torch without the Python flag
    profiler_on = torch._C._autograd._profiler_enabled


class _Span:
    """One span: its context manager while open, then its record."""

    __slots__ = ("recorder", "name", "device", "rf", "stack", "parent", "root", "thread",
                 "stream", "t0", "t1", "events", "device_ms")

    def __init__(self, recorder, name, device=True):
        self.recorder, self.name, self.device = recorder, name, device
        self.t1 = self.events = self.device_ms = None

    def __enter__(self):
        rec = self.recorder
        stack = self.stack = rec._stack()
        parent = self.parent = stack[-1] if stack else None
        self.thread = threading.get_ident()
        if parent is None:  # a root asks once whether and where the card can time it
            self.root = next(rec._roots)
            self.stream = (torch.cuda.current_stream() if self.device
                           and torch.cuda.is_initialized()
                           and not torch.cuda.is_current_stream_capturing() else None)
        else:
            self.root, self.stream = parent.root, parent.stream
        if rec._keep(self) and self.device and self.stream is not None:
            self.events = rec._event_pair()
        stack.append(self)
        self.rf = record_function(self.name)
        self.t0 = time.time_ns()
        self.rf.__enter__()
        if self.events is not None:
            self.events[0].record(self.stream)

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.stream)
        self.rf.__exit__(*exc)
        self.t1 = time.time_ns()
        self.stack.pop()
        self.rf = self.stack = None
        return False


class SpanRecorder:
    """In-memory span records (name, parent, root id, thread, host interval,
    device interval) and named sums. The module keeps one, `RECORDER`."""

    def __init__(self, cap: int = SPAN_CAP):
        self.cap = cap
        self._local = threading.local()
        self._lock = threading.Lock()
        self._pool: list = []
        self.reset()

    def reset(self) -> None:
        """Forget every record, counter and drop."""
        self.records: list = []
        self.counters: dict = {}
        self.dropped = 0
        self._roots = itertools.count(1)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _keep(self, r) -> bool:
        if len(self.records) >= self.cap:
            self.dropped += 1
            return False
        self.records.append(r)
        return True

    def _event_pair(self):
        try:
            return self._pool.pop()
        except IndexError:
            return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def count(self, name: str, value: float = 1) -> None:
        """Add `value` to the named sum (always on: per request or batch only)."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def summary(self, first: int = 0) -> dict:
        """{"spans": {name: {"count", "host_ms", "device_ms", "self_device_ms"}},
        "counters", "dropped"} over the closed records from index `first` on.
        Device times (None for a name no record timed on the card) come from the
        records' timing events, after one synchronisation; a span's self time
        is its time less the time of its child spans."""
        records = [r for r in self.records[first:] if r.t1 is not None]
        timed = [r for r in records if r.events is not None]
        if timed:
            torch.cuda.synchronize()
            for r in timed:
                r.device_ms = r.events[0].elapsed_time(r.events[1])
                self._pool.append(r.events)
                r.events = None
        children: dict = {}
        for r in records:
            if r.parent is not None and r.device_ms is not None:
                children[id(r.parent)] = children.get(id(r.parent), 0.0) + r.device_ms
        spans: dict = {}
        for r in records:
            s = spans.setdefault(r.name, {"count": 0, "host_ms": 0.0, "device_ms": None,
                                          "self_device_ms": None})
            s["count"] += 1
            s["host_ms"] += (r.t1 - r.t0) * 1e-6
            if r.device_ms is not None:
                s["device_ms"] = (s["device_ms"] or 0.0) + r.device_ms
                s["self_device_ms"] = ((s["self_device_ms"] or 0.0) + r.device_ms
                                       - children.get(id(r), 0.0))
        with self._lock:
            counters = dict(self.counters)
        return {"spans": spans, "counters": counters, "dropped": self.dropped}


RECORDER = SpanRecorder()


def span(name: str, device: bool = True):
    """A context manager around one layer call, recorded in `RECORDER` while a
    profiler session runs; otherwise one bool read and the shared no-op.
    `device`: also time it on the card (where its root span can)."""
    if not profiler_on():
        return _OFF
    return _Span(RECORDER, name, device)


count = RECORDER.count
summary = RECORDER.summary
reset = RECORDER.reset
