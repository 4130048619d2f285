"""Feature-flag store (counterpart of moegan_tpu/orchestration/flags.py) — local analog of the reference's SSM Parameter
Store booleans gating the CodeBuild pipeline (skip-build, upload-data,
run-hpo, skip-training; buildspec.yml:24-26 etc.). JSON file-backed so
flags survive across runs like SSM parameters do."""

from __future__ import annotations

import json
import os

DEFAULT_FLAGS = {
    "skip-build": False,
    "upload-data": False,
    "run-hpo": False,
    "skip-training": False,
}


class FlagStore:
    def __init__(self, path: str = ".moegan_flags.json"):
        self.path = path

    def _load(self) -> dict:
        if os.path.exists(self.path):
            with open(self.path) as f:
                return {**DEFAULT_FLAGS, **json.load(f)}
        return dict(DEFAULT_FLAGS)

    def get(self, name: str) -> bool:
        return bool(self._load().get(name, False))

    def set(self, name: str, value: bool):
        flags = self._load()
        flags[name] = bool(value)
        with open(self.path, "w") as f:
            json.dump(flags, f, indent=2)

    def reset(self, name: str):
        """Pipeline stages reset their flag after consuming it
        (tuning-buildspec.yml:58-80 pattern)."""
        self.set(name, False)

    def all(self) -> dict:
        return self._load()
