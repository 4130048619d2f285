"""Staged CI/CD pipeline (counterpart of moegan_tpu/orchestration/pipeline.py) — local analog of the reference's CodeBuild
chain (buildspec.yml + preprocessing/tuning/training/deployment
buildspecs): flag-gated stages preprocessing -> hpo -> training ->
deployment, with best-hyperparameter handoff and model_metrics.json
publication (deployment-buildspec.yml:95-127)."""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

from moegan_tpu_torch.orchestration.flags import FlagStore

STAGES = ("preprocessing", "hpo", "training", "deployment")


class Pipeline:
    """Runs flag-gated stages; each stage is a callable(context) -> dict
    merged into the shared context (the buildspec env-var handoff)."""

    def __init__(
        self,
        work_dir: str = "./pipeline",
        flags: Optional[FlagStore] = None,
    ):
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.flags = flags or FlagStore(os.path.join(work_dir, "flags.json"))
        self._stages: dict[str, Callable] = {}

    def register(self, stage: str, fn: Callable):
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage}; expected one of {STAGES}")
        self._stages[stage] = fn
        return fn

    def gate_open(self, stage: str) -> bool:
        """Flag semantics mirror the reference buildspecs: preprocessing
        runs when upload-data is SET; hpo when run-hpo is SET; training
        unless skip-training is SET; deployment always."""
        if stage == "preprocessing":
            return self.flags.get("upload-data")
        if stage == "hpo":
            return self.flags.get("run-hpo")
        if stage == "training":
            return not self.flags.get("skip-training")
        return True

    def run(self, context: Optional[dict] = None) -> dict:
        ctx = dict(context or {})
        ctx.setdefault("work_dir", self.work_dir)
        history = []
        for stage in STAGES:
            if stage not in self._stages:
                continue
            if not self.gate_open(stage):
                history.append({"stage": stage, "status": "SKIPPED"})
                continue
            t0 = time.time()
            try:
                out = self._stages[stage](ctx) or {}
                ctx.update(out)
                history.append(
                    {"stage": stage, "status": "SUCCEEDED", "seconds": time.time() - t0}
                )
            except Exception as e:
                history.append({"stage": stage, "status": "FAILED", "error": str(e)})
                break
            finally:
                # one-shot flags reset after consumption (ref tuning-
                # buildspec.yml:58-80)
                if stage == "preprocessing":
                    self.flags.reset("upload-data")
                if stage == "hpo":
                    self.flags.reset("run-hpo")
        ctx["history"] = history
        with open(os.path.join(self.work_dir, "pipeline_run.json"), "w") as f:
            json.dump({"history": history}, f, indent=2, default=str)
        return ctx


def publish_model_metrics(
    metrics: dict, out_path: str, training_job: str = "", hyperparameters: dict | None = None
) -> dict:
    """Write the model_metrics.json the /metrics endpoint serves
    (deployment-buildspec.yml:95-127 / MetricsLambda contract)."""
    doc = {
        "model_name": "moegan-tpu",
        "training_job": training_job,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "hyperparameters": {k: str(v) for k, v in (hyperparameters or {}).items()},
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=2)
    return doc
