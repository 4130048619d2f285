"""The port's hyperparameter search (`hpo/search.py`) and tuning CLI
(`cli/tune.py`) against the JAX package's (`hpo/search.py`, `cli/tune.py`).

The search is numpy in both packages: the same seed and objective must give
the same trials, trial by trial. The CLI runs in-process on the CPU at the
tiny configuration, with a toy tower pack in place of the ViT-B/32 towers
(as tests/test_torch_cli.py does); its files are held to the keys the JAX
package's functions write.
"""

import json
import os
import time

import numpy as np
import pytest

from moegan_tpu.hpo import search as jax_search
from moegan_tpu.orchestration.pipeline import publish_model_metrics as jax_publish
from moegan_tpu_torch.cli import tune
from moegan_tpu_torch.hpo import search
from moegan_tpu_torch.models import clip
from moegan_tpu_torch.models.toy_clip import as_tower_pack, init_toy_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SCHEMA = {
    "hyperparameter_ranges": {
        "learning_rate": {"min_value": 1e-4, "max_value": 5e-4, "scaling_type": "Logarithmic"},
        "r1_gamma": {"min_value": 5.0, "max_value": 15.0, "scaling_type": "Linear"},
    },
    "integer_parameter_ranges": {
        "kl_annealing_epochs": {"min_value": 2, "max_value": 4, "scaling_type": "Auto"}
    },
    "static_hyperparameters": {"epochs": "6", "batch_size": "8"},
    "objective_metric": {"name": "val_clip_loss", "type": "Minimize"},
}
NO_INTEGERS = {k: v for k, v in REF_SCHEMA.items() if k != "integer_parameter_ranges"}


def _quadratic(params):
    return float((np.log10(params["learning_rate"]) - np.log10(3e-4)) ** 2
                 + ((params["r1_gamma"] - 10.0) / 10.0) ** 2
                 + 0.01 * params.get("kl_annealing_epochs", 0))


@pytest.mark.parametrize("cfg", [REF_SCHEMA, NO_INTEGERS], ids=["reference", "no_integers"])
def test_search_space_matches_jax(cfg, tmp_path):
    """Parsed fields, then 20 samples and 20 perturbations from one seed."""
    path = tmp_path / "space.json"
    path.write_text(json.dumps(cfg))
    ours, theirs = search.SearchSpace.from_json_file(str(path)), jax_search.SearchSpace.from_config(cfg)
    assert vars(ours) == vars(theirs)
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(20):
        p = ours.sample(r1)
        assert p == theirs.sample(r2)
        assert ours.perturb(p, r1) == theirs.perturb(p, r2)
    assert ("kl_annealing_epochs" in p) == (cfg is REF_SCHEMA)


def test_parse_metric_lines_matches_jax():
    out = ("log line\n[METRIC] val_clip_loss: 0.8123\n[METRIC] val_d_loss: 1.900000\n"
           "rank0 [METRIC] val_clip_loss: -7.5e-01 trailing\n[METRIC] val_clip_loss_16: 3\n")
    for name in ("val_clip_loss", "val_d_loss", "val_g_loss", "val_clip_loss_16"):
        assert search.parse_metric_lines(out, name) == jax_search.parse_metric_lines(out, name)
    assert search.parse_metric_lines(out, "val_clip_loss") == [0.8123, -0.75]


@pytest.mark.parametrize("strategy", ["tpe", "perturb"])
def test_run_hpo_matches_jax_trial_by_trial(strategy):
    """One trial at a time, so the proposals see the same completed trials."""
    def train_fn(params, report):
        obj = _quadratic(params)
        for epoch in range(3):
            if not report(epoch, {"val_clip_loss": obj + 0.1 * (2 - epoch)}):
                break
        return {"val_clip_loss": obj}

    results = []
    for mod in (search, jax_search):
        space = mod.SearchSpace.from_config(REF_SCHEMA)
        results.append(mod.run_hpo(space, train_fn, max_jobs=10, warmup_jobs=3,
                                   max_parallel_jobs=1, seed=7, strategy=strategy))
    (best, trials), (jbest, jtrials) = results
    assert [(t.params, t.objective, t.history, t.status) for t in trials] == [
        (t.params, t.objective, t.history, t.status) for t in jtrials]
    assert best.trial_id == jbest.trial_id
    assert search.describe_best(best) == jax_search.describe_best(jbest)


@pytest.mark.parametrize("offset", [0.0, -5.0], ids=["positive", "negative"])
def test_early_stop_matches_jax(offset):
    """Trial 0 sets the incumbent; later flat trials that trail it stop after
    `patience` epochs without improvement, for objectives of either sign."""
    runs = []
    for mod in (search, jax_search):
        epochs_run = {}

        def train_fn(params, report, _n=epochs_run):
            idx = len(_n)
            val = offset + (0.1 if idx == 0 else 3.0)
            ran = 0
            for epoch in range(8):
                ran += 1
                if not report(epoch, {"val_clip_loss": val}):
                    break
            _n[idx] = ran
            return {"val_clip_loss": val}

        best, _ = mod.run_hpo(mod.SearchSpace.from_config(REF_SCHEMA), train_fn, max_jobs=3,
                              warmup_jobs=3, max_parallel_jobs=1, seed=0, patience=2)
        runs.append((epochs_run, best.objective))
    assert runs[0] == runs[1]
    assert runs[0][0] == {0: 8, 1: 3, 2: 3}


def test_parallel_trials_overlap():
    """max_parallel_jobs=2 runs two trials at once."""
    def train_fn(params, report):
        time.sleep(0.15)
        return {"val_clip_loss": params["r1_gamma"]}

    t0 = time.time()
    best, trials = search.run_hpo(search.SearchSpace.from_config(REF_SCHEMA), train_fn,
                                  max_jobs=6, warmup_jobs=6, max_parallel_jobs=2, seed=0)
    assert time.time() - t0 < 6 * 0.15
    tl = search.trial_timeline(trials)
    assert any(a["started_at"] < b["ended_at"] and b["started_at"] < a["ended_at"]
               for a in tl for b in tl if a["trial_id"] < b["trial_id"])
    assert best.objective == min(t["objective"] for t in tl)


def test_tune_cli_in_process_writes_the_jax_files(tmp_path, monkeypatch):
    """`cli.tune --device cpu` in-process on the synthetic fixture: two tiny
    trials in parallel, each one epoch with the CLIP loss (a toy tower pack);
    the three files carry the keys the JAX functions write."""
    cfg = json.load(open(os.path.join(ROOT, "configs", "hyperparameter_config.json")))
    cfg["static_hyperparameters"].update(epochs="1", tiny="true")
    path = tmp_path / "space.json"
    path.write_text(json.dumps(cfg))
    loaded = []

    def toy_towers(device="cuda", **_):
        loaded.append(device)
        return as_tower_pack(init_toy_params(16))

    monkeypatch.setattr(clip, "load_clip_params", toy_towers)
    out = tmp_path / "hpo"
    info = tune.main(["--config", str(path), "--max_jobs", "2", "--max_parallel_jobs", "2",
                      "--warmup_jobs", "2", "--synthetic", "--out_dir", str(out),
                      "--device", "cpu"])
    assert loaded == ["cpu"]
    best = json.load(open(out / "best_hyperparameters.json"))
    timeline = json.load(open(out / "trial_timeline.json"))
    metrics = json.load(open(out / "model_metrics.json"))
    assert best == info
    assert len(timeline) == 2 and all(t["status"] == "COMPLETED" for t in timeline)
    assert all(np.isfinite(t["objective"]) for t in timeline)
    # the keys the JAX functions write for a trial of the same kind
    trial = jax_search.Trial(0, best["FinalHyperParameters"], best["FinalObjectiveValue"])
    assert set(best) == set(jax_search.describe_best(trial))
    assert all(set(t) == set(jax_search.trial_timeline([trial])[0]) for t in timeline)
    want = jax_publish({"val_clip_loss": trial.objective}, str(tmp_path / "jax.json"),
                       training_job=best["BestTrainingJob"], hyperparameters=trial.params)
    assert metrics.keys() == want.keys()
    assert {k: metrics[k] for k in want if k != "timestamp"} == {
        k: want[k] for k in want if k != "timestamp"}
    assert best["FinalHyperParameters"]["tiny"] == "true"
