"""Metric logging (counterpart of moegan_tpu/utils/metrics.py): EMA loss
meters, the `[METRIC] name: value` stdout lines that the HPO harness
scrapes, and an optional jsonl sink (`metrics.jsonl` in the training CLI's
save_dir): one {"ts", "name", "value"[, "step"]} record per metric or vector.

Under torch.distributed only rank 0 writes; the other ranks' loggers are
silent, so a distributed run prints each line once.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Mapping

import torch.distributed as dist

logger = logging.getLogger("moegan_tpu_torch")


class EMAMeter:
    """Exponential-moving-average meters (decay 0.9)."""

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self.values: dict[str, float] = {}

    def update(self, metrics: Mapping[str, float]) -> dict[str, float]:
        for k, v in metrics.items():
            v = float(v)
            if k in self.values:
                self.values[k] = self.decay * self.values[k] + (1 - self.decay) * v
            else:
                self.values[k] = v
        return dict(self.values)

    def __getitem__(self, k):
        return self.values[k]


def is_writer() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class MetricLogger:
    """[METRIC] lines on stdout, other lines on stderr, and records appended to
    `jsonl_path` when given; rank 0 only."""

    def __init__(self, jsonl_path: str | None = None):
        self.enabled = is_writer()
        self._fh = open(jsonl_path, "a") if jsonl_path and self.enabled else None

    def _record(self, name: str, value, step: int | None) -> None:
        if self._fh:
            rec = {"ts": time.time(), "name": name, "value": value}
            if step is not None:
                rec["step"] = step
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def log_metric(self, name: str, value: float, step: int | None = None):
        """One `[METRIC] name: value` line (the HPO regex contract)."""
        if self.enabled:
            print(f"[METRIC] {name}: {float(value):.6f}", flush=True)
            self._record(name, float(value), step)

    def log_metrics(self, metrics: Mapping[str, float], step: int | None = None):
        for k, v in metrics.items():
            self.log_metric(k, v, step)

    def log_vector(self, name: str, values, step: int | None = None):
        """A vector signal (per-block expert utilization) as a readable stderr
        line, not a [METRIC] line (the HPO regex takes scalars)."""
        vals = [[round(float(x), 6) for x in row] if hasattr(row, "__len__")
                else round(float(row), 6) for row in values]
        self.log_line(f"{name}: {vals}")
        self._record(name, vals, step)

    def log_line(self, msg: str):
        if self.enabled:
            logger.info(msg)
            print(msg, file=sys.stderr, flush=True)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
