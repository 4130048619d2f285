"""Profiling and device memory telemetry (counterpart of moegan_tpu/utils/profiling.py).

- `enable_debug_mode(nans=True)`: autograd's anomaly mode with NaN checks,
  which traps a NaN where the backward creates it (not in a forward).
- `trace(logdir)`: a `torch.profiler` trace of the CPU and, when there is
  a card, CUDA activity, written to `logdir` as a Chrome trace.
- `device_memory_stats()`: the JAX module's per-device keys, from
  `torch.cuda`.
- `MemoryMonitor`: watermarks every `interval` steps, with a warning above
  `limit_fraction` of the card's memory.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch

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
    (`trace_<pid>.json`) into `dir` and yields `dir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


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
