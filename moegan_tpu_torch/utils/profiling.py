"""Device memory watermarks (the port's part of moegan_tpu/utils/profiling.py).

`MemoryMonitor` reads `torch.cuda.memory_stats` every `interval` steps and
warns when the allocated bytes pass a share of the card's memory. The
trace helpers of the JAX module are not ported yet (the port's profiles
are `scripts/torch_*_profile.py`).
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger("moegan_tpu_torch")
HIGH_WATER = 0.8  # share of the card's memory above which a step warns


class MemoryMonitor:
    """Log device memory watermarks every `interval` steps."""

    def __init__(self, interval: int = 10, device=None):
        self.interval = interval
        self.device = device

    def step(self, step_idx: int):
        """The memory stats of the device at every `interval`-th step (None
        otherwise, and on a CPU-only run)."""
        if step_idx % self.interval or not torch.cuda.is_available():
            return None
        dev = torch.device(self.device) if self.device is not None else None
        if dev is not None and dev.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(dev)
        used = stats.get("allocated_bytes.all.current", 0)
        limit = torch.cuda.get_device_properties(dev or torch.cuda.current_device()).total_memory
        if used > HIGH_WATER * limit:
            logger.warning("device memory high-water: %.2f/%.2f GB", used / 1e9, limit / 1e9)
        return stats
