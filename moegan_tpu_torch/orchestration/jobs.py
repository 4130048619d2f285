"""Local job runner — the SageMaker-job analog (counterpart of
moegan_tpu/orchestration/jobs.py).

The reference launches processing/training/HPO jobs through boto3
(scripts/launch_processing_job.py, start_training_job.py), each a managed
container with hyperparameters JSON, env vars, an artifact output path,
a max-runtime cap, and a status poller. This runner reproduces that
contract with subprocesses: jobs get a working dir, a hyperparameters
JSON (string-valued, SageMaker-style), captured stdout (for [METRIC]
scraping), a runtime cap, and a describe()-style status record.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import uuid
from typing import Optional

from moegan_tpu_torch.hpo.search import parse_metric_lines


@dataclasses.dataclass
class JobSpec:
    name: str
    command: list  # argv; {job_dir}/{hyperparameters} templates expanded
    hyperparameters: dict = dataclasses.field(default_factory=dict)
    environment: dict = dataclasses.field(default_factory=dict)
    max_runtime_seconds: int = 5 * 24 * 3600  # ref 5-day cap (:73-75)


@dataclasses.dataclass
class JobRecord:
    job_name: str
    status: str  # InProgress | Completed | Failed | Stopped
    job_dir: str
    exit_code: Optional[int] = None
    stdout_path: str = ""
    started_at: float = 0.0
    ended_at: Optional[float] = None

    def describe(self) -> dict:
        """describe_training_job-shaped record."""
        return {
            "TrainingJobName": self.job_name,
            "TrainingJobStatus": self.status,
            "OutputDataConfig": {"S3OutputPath": self.job_dir},
            "ExitCode": self.exit_code,
        }


class JobRunner:
    def __init__(self, base_dir: str = "./jobs"):
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)
        self._jobs: dict[str, tuple[JobRecord, subprocess.Popen]] = {}

    def submit(self, spec: JobSpec) -> JobRecord:
        job_name = f"{spec.name}-{time.strftime('%y%m%d%H%M%S')}-{uuid.uuid4().hex[:6]}"
        job_dir = os.path.join(self.base_dir, job_name)
        os.makedirs(job_dir, exist_ok=True)

        # SageMaker contract: hyperparameters arrive as a JSON of strings
        # at a well-known path (ref sagemaker_train.py:83).
        hp_path = os.path.join(job_dir, "hyperparameters.json")
        with open(hp_path, "w") as f:
            json.dump({k: str(v) for k, v in spec.hyperparameters.items()}, f)

        argv = [
            str(a).format(job_dir=job_dir, hyperparameters=hp_path)
            for a in spec.command
        ]
        stdout_path = os.path.join(job_dir, "stdout.log")
        env = {**os.environ, **{k: str(v) for k, v in spec.environment.items()},
               "JOB_DIR": job_dir, "HYPERPARAMETERS_PATH": hp_path}
        with open(stdout_path, "wb") as out:
            proc = subprocess.Popen(argv, stdout=out, stderr=subprocess.STDOUT, env=env)
        rec = JobRecord(job_name, "InProgress", job_dir,
                        stdout_path=stdout_path, started_at=time.time())
        self._jobs[job_name] = (rec, proc)
        return rec

    def poll(self, job_name: str) -> JobRecord:
        rec, proc = self._jobs[job_name]
        if rec.status == "InProgress":
            code = proc.poll()
            if code is not None:
                rec.exit_code = code
                rec.status = "Completed" if code == 0 else "Failed"
                rec.ended_at = time.time()
        return rec

    def wait(self, job_name: str, poll_seconds: float = 1.0,
             max_runtime_seconds: Optional[float] = None) -> JobRecord:
        """Blocking waiter with runtime cap (ref start_training_job.py:89-101)."""
        rec, proc = self._jobs[job_name]
        deadline = rec.started_at + (max_runtime_seconds or 5 * 24 * 3600)
        while self.poll(job_name).status == "InProgress":
            if time.time() > deadline:
                proc.terminate()
                rec.status = "Stopped"
                rec.ended_at = time.time()
                break
            time.sleep(poll_seconds)
        return rec

    def stop(self, job_name: str) -> JobRecord:
        """Terminate a running job (StopTrainingJob analog; also how HPO
        early-stopping ends a trailing trial)."""
        rec, proc = self._jobs[job_name]
        if rec.status == "InProgress" and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            rec.status = "Stopped"
            rec.exit_code = proc.returncode
            rec.ended_at = time.time()
        return rec

    def metrics(self, job_name: str, metric_name: str) -> list[float]:
        """Scrape [METRIC] lines from the job's stdout (HPO contract)."""
        rec, _ = self._jobs[job_name]
        if not os.path.exists(rec.stdout_path):
            return []
        with open(rec.stdout_path) as f:
            return parse_metric_lines(f.read(), metric_name)


def python_job(name: str, module: str, *args, **spec_kw) -> JobSpec:
    """JobSpec running `python -m module ...` in this interpreter."""
    return JobSpec(name=name, command=[sys.executable, "-m", module, *args], **spec_kw)
