"""The card the run uses, and the checks around it: a run without a card, or
with fewer cards than the cell asks for, stops before any work; the JAX
stack must not be loaded in the process that prints the result."""

from __future__ import annotations

import subprocess
import sys

import torch

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "moegan_tpu")


class NoCard(RuntimeError):
    pass


def require_cards(count: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device is available: the benchmark measures the card only")
    if torch.cuda.device_count() < count:
        raise NoCard(f"the cell asks for {count} cards, the machine has "
                     f"{torch.cuda.device_count()}")


def smi() -> dict:
    """The card's name and power limit as nvidia-smi reads them ({} without nvidia-smi)."""
    query = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits"]
    try:
        out = subprocess.run(query, capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    name, limit, clock = (x.strip() for x in out.splitlines()[0].split(","))
    return {"smi_name": name, "power_limit_w": float(limit), "sm_clock_max_mhz": float(clock)}


def smi_now() -> str:
    """The card's SM clock, power draw and temperature now, as nvidia-smi reads them."""
    query = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"]
    try:
        return subprocess.run(query, capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unread"


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES, whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)
