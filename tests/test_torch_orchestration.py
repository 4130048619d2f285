"""The port's orchestration (`orchestration/flags.py`, `jobs.py`,
`pipeline.py`) and managed training job (`cli/job_train.py`) against the
JAX package's, and the refusal of the MLOps CLIs without a card.

The flag store, job runner and pipeline run the same calls in both packages
and must leave the same records. The managed job runs as a job-runner
process on the CPU at the tiny configuration; the JAX package's loader
must read the generator file it writes.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from moegan_tpu.orchestration import flags as jax_flags
from moegan_tpu.orchestration import jobs as jax_jobs
from moegan_tpu.orchestration import pipeline as jax_pipeline
from moegan_tpu.utils.checkpoint import load_generator_params as jax_load_params
from moegan_tpu_torch.cli import job_train, process_data, tune
from moegan_tpu_torch.config import GeneratorConfig
from moegan_tpu_torch.convert import torch_to_jax
from moegan_tpu_torch.data.datasets import ProcessedMSCOCODataset, synthetic_dataset
from moegan_tpu_torch.models.generator import AuroraGenerator
from moegan_tpu_torch.orchestration import flags, jobs, pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ECHO = ("import json,os;hp=json.load(open(os.environ['HYPERPARAMETERS_PATH']));"
        "print('[METRIC] val_clip_loss:', hp['lr']);print('[METRIC] val_clip_loss: 0.5')")


def test_flag_store_round_trip_reads_as_jax(tmp_path):
    path = str(tmp_path / "flags.json")
    fs, theirs = flags.FlagStore(path), jax_flags.FlagStore(path)
    assert fs.all() == theirs.all() and fs.get("run-hpo") is False
    fs.set("run-hpo", True)
    fs.set("upload-data", 1)
    assert theirs.get("run-hpo") is True and theirs.all() == fs.all()
    fs.reset("run-hpo")
    assert theirs.get("run-hpo") is False and fs.get("upload-data") is True
    assert set(fs.all()) == set(jax_flags.DEFAULT_FLAGS)


def test_job_runner_lifecycle_and_failure_match_jax(tmp_path):
    """A job that reads its stringified hyperparameters and prints [METRIC]
    lines, and one that exits 3: the same records in both runners."""
    records = []
    for mod in (jobs, jax_jobs):
        runner = mod.JobRunner(str(tmp_path / mod.__name__))
        ok = runner.submit(mod.JobSpec("echo-job", [sys.executable, "-c", ECHO],
                                       hyperparameters={"lr": 0.75}))
        bad = runner.submit(mod.JobSpec("bad", [sys.executable, "-c", "raise SystemExit(3)"]))
        ok, bad = (runner.wait(r.job_name, poll_seconds=0.05, max_runtime_seconds=60)
                   for r in (ok, bad))
        with open(os.path.join(ok.job_dir, "hyperparameters.json")) as f:
            hp = json.load(f)
        records.append((ok.status, ok.exit_code, hp, runner.metrics(ok.job_name, "val_clip_loss"),
                        bad.status, bad.exit_code,
                        {k for k in ok.describe() if k != "OutputDataConfig"}))
    assert records[0] == records[1]
    assert records[0][:6] == ("Completed", 0, {"lr": "0.75"}, [0.75, 0.5], "Failed", 3)


def test_job_runner_stop_and_runtime_cap(tmp_path):
    runner = jobs.JobRunner(str(tmp_path))
    sleeper = [sys.executable, "-c", "import time; time.sleep(60)"]
    rec = runner.submit(jobs.JobSpec("stop-me", sleeper))
    rec = runner.stop(rec.job_name)
    assert rec.status == "Stopped" and rec.exit_code is not None and rec.ended_at
    capped = runner.submit(jobs.JobSpec("capped", sleeper))
    capped = runner.wait(capped.job_name, poll_seconds=0.05, max_runtime_seconds=0.3)
    assert capped.status == "Stopped"
    runner.stop(capped.job_name)


def _stages(calls, fail=False):
    def training(ctx):
        if fail:
            raise RuntimeError("nope")
        calls.append("train")
        return {"ckpt": "x"}

    return {"preprocessing": lambda ctx: calls.append("pre"),
            "hpo": lambda ctx: (calls.append("hpo"), {"best_lr": 3e-4})[1],
            "training": training,
            "deployment": lambda ctx: calls.append(("deploy", ctx.get("ckpt")))}


def _run_both(tmp_path, fail, set_flags):
    out = []
    for mod in (pipeline, jax_pipeline):
        p = mod.Pipeline(str(tmp_path / mod.__name__))
        calls = []
        for stage, fn in _stages(calls, fail).items():
            p.register(stage, fn)
        for name in set_flags:
            p.flags.set(name, True)
        ctx = p.run({"seed": 1})
        with open(os.path.join(p.work_dir, "pipeline_run.json")) as f:
            history = json.load(f)["history"]
        assert history == [{k: v for k, v in h.items()} for h in ctx["history"]]
        out.append((calls, [{k: v for k, v in h.items() if k != "seconds"} for h in history],
                    {k: v for k, v in ctx.items() if k not in ("history", "work_dir")},
                    p.flags.all()))
    assert out[0] == out[1]
    return out[0]


@pytest.mark.parametrize("fail", [False, True], ids=["handoff", "failure"])
def test_pipeline_gates_and_handoff_match_jax(tmp_path, fail):
    """Default flags (preprocessing and hpo skipped), then both one-shot flags
    set (every stage runs, the flags reset); a failing stage stops the chain."""
    calls, history, ctx, _ = _run_both(tmp_path / "default", fail, ())
    assert [h["status"] for h in history] == (
        ["SKIPPED", "SKIPPED", "SUCCEEDED", "SUCCEEDED"] if not fail
        else ["SKIPPED", "SKIPPED", "FAILED"])
    calls, history, ctx, flag_state = _run_both(tmp_path / "set", fail,
                                                ("upload-data", "run-hpo"))
    assert calls == (["pre", "hpo", "train", ("deploy", "x")] if not fail else ["pre", "hpo"])
    assert ctx.get("best_lr") == 3e-4 and flag_state["upload-data"] is False
    assert flag_state["run-hpo"] is False
    if fail:
        assert history[-1] == {"stage": "training", "status": "FAILED", "error": "nope"}


def test_publish_model_metrics_matches_jax(tmp_path):
    args = ({"val_clip_loss": 0.8099, "val_d_loss": np.float32(1.9575)},)
    kw = dict(training_job="gan-train-x", hyperparameters={"lr": 6.7e-4, "tiny": True})
    ours = pipeline.publish_model_metrics(*args, str(tmp_path / "a" / "m.json"), **kw)
    theirs = jax_pipeline.publish_model_metrics(*args, str(tmp_path / "b" / "m.json"), **kw)
    ours.pop("timestamp"), theirs.pop("timestamp")
    assert ours == theirs
    with open(tmp_path / "a" / "m.json") as f:
        written = json.load(f)
    assert written.pop("timestamp") and written == theirs


def test_job_train_as_a_job_writes_what_jax_reads(tmp_path):
    """`cli.job_train --device cpu` as a job-runner process on a tiny processed
    directory (use_percentage 0.5 of 24 train images: one step at batch 8):
    the [METRIC] lines, metrics.jsonl, a checkpoint, and a generator file
    that the JAX package's loader reads with the port's parameter tree."""
    data = tmp_path / "data"
    train, val = synthetic_dataset(24, 16, seed=3), synthetic_dataset(8, 16, seed=4)
    for ds, split in ((train, "train"), (val, "validation")):
        ProcessedMSCOCODataset(ds.images, ds.text_embeddings).save(str(data), split)
    hp = {"epochs": "1", "batch_size": "8", "tiny": "true", "max_resolution": "16",
          "no_clip_loss": "true", "learning_rate": "0.0003", "use_percentage": "0.5"}
    runner = jobs.JobRunner(str(tmp_path / "jobs"))
    env = {"DATA_DIR": str(data), "PYTHONPATH": ROOT, "MPLBACKEND": "Agg"}
    rec = runner.submit(jobs.python_job("train", "moegan_tpu_torch.cli.job_train", "--device",
                                        "cpu", hyperparameters=hp, environment=env))
    rec = runner.wait(rec.job_name, poll_seconds=0.2, max_runtime_seconds=240)
    with open(rec.stdout_path) as f:
        log = f.read()
    assert rec.status == "Completed", log
    assert runner.metrics(rec.job_name, "val_d_loss") and "saved " in log
    with open(os.path.join(rec.job_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert {r["step"] for r in records if r["name"] == "val_d_loss"} == {1}
    assert os.listdir(os.path.join(rec.job_dir, "checkpoints"))
    model_dir = os.path.join(rec.job_dir, "model")
    with open(os.path.join(model_dir, "generator_config.json")) as f:
        cfg = GeneratorConfig.from_dict(json.load(f))
    assert cfg.max_resolution == 16 and cfg.router_hidden == 8
    got = jax_load_params(os.path.join(model_dir, "aurora_model_final.msgpack"))

    def flat(tree, prefix=""):
        for k, v in tree.items():
            yield from flat(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]

    got = {k: np.shape(v) for k, v in flat(got)}
    want = {k: v.shape for k, v in torch_to_jax(AuroraGenerator(cfg).state_dict()).items()}
    assert got == want


@pytest.mark.parametrize("cli", ["process_data", "tune", "job_train"])
def test_mlops_clis_refuse_without_a_card(cli, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("JOB_DIR", str(tmp_path / "job"))
    argv = {"process_data": ["--synthetic", "4", "--output_dir", str(tmp_path / "out")],
            "tune": ["--config", str(tmp_path / "missing.json"), "--synthetic"],
            "job_train": []}[cli]
    main = {"process_data": process_data, "tune": tune, "job_train": job_train}[cli].main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert os.listdir(tmp_path) == []
