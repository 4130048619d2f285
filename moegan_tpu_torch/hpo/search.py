"""Hyperparameter search (the port's numpy copy of moegan_tpu/hpo/search.py).

It reads the reference's search-space JSON (configs/hyperparameter_config.json:
continuous ranges with Linear or Logarithmic scaling, integer ranges, static
hyperparameters, an objective metric; every section optional), runs up to
`max_parallel_jobs` trials at a time, scrapes the `[METRIC] name: value`
lines of a trial's output, stops trials that trail the best one (for
objectives of either sign) and keeps the best on the objective
(val_clip_loss, Minimize).

Proposals: random warm-up, then a tree-structured Parzen estimator (the
completed trials split at the gamma quantile into good and bad, a Gaussian
KDE per dimension, log-space for Logarithmic ranges, candidates scored by
the density ratio), or a Gaussian move around the incumbent ("perturb").
The same seed and objective give the JAX package's trials, trial by trial.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import threading
import time
import traceback
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Mapping, Optional

import numpy as np


def parse_metric_lines(stdout: str, name: str) -> list[float]:
    """Extract `[METRIC] <name>: value` values (HPO regex contract)."""
    out = []
    for line in stdout.splitlines():
        if "[METRIC]" not in line:
            continue
        m = re.match(rf".*\[METRIC\]\s+{re.escape(name)}: ([0-9eE\.\+\-]+).*", line)
        if m:
            out.append(float(m.group(1)))
    return out


@dataclasses.dataclass
class SearchSpace:
    continuous: dict  # name -> (lo, hi, log?)
    integer: dict  # name -> (lo, hi)
    static: dict
    objective_name: str = "val_clip_loss"
    objective_minimize: bool = True

    @classmethod
    def from_config(cls, cfg: Mapping) -> "SearchSpace":
        cont = {}
        for name, spec in cfg.get("hyperparameter_ranges", {}).items():
            log = str(spec.get("scaling_type", "Linear")).lower().startswith("log")
            cont[name] = (float(spec["min_value"]), float(spec["max_value"]), log)
        ints = {}
        for name, spec in cfg.get("integer_parameter_ranges", {}).items():
            ints[name] = (int(spec["min_value"]), int(spec["max_value"]))
        static = dict(cfg.get("static_hyperparameters", {}))
        obj = cfg.get("objective_metric", {})
        return cls(
            continuous=cont,
            integer=ints,
            static=static,
            objective_name=obj.get("name", "val_clip_loss"),
            objective_minimize=str(obj.get("type", "Minimize")).lower() != "maximize",
        )

    @classmethod
    def from_json_file(cls, path: str) -> "SearchSpace":
        with open(path) as f:
            return cls.from_config(json.load(f))

    def sample(self, rng: np.random.Generator) -> dict:
        params = dict(self.static)
        for name, (lo, hi, log) in self.continuous.items():
            if log:
                params[name] = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
            else:
                params[name] = float(rng.uniform(lo, hi))
        for name, (lo, hi) in self.integer.items():
            params[name] = int(rng.integers(lo, hi + 1))
        return params

    def perturb(self, base: dict, rng: np.random.Generator, scale: float = 0.15) -> dict:
        """Local Gaussian move around an incumbent (log-space when log)."""
        params = dict(base)
        for name, (lo, hi, log) in self.continuous.items():
            v = float(base[name])
            if log:
                lv = math.log(v) + rng.normal(0, scale * (math.log(hi) - math.log(lo)))
                params[name] = float(np.clip(math.exp(lv), lo, hi))
            else:
                params[name] = float(np.clip(v + rng.normal(0, scale * (hi - lo)), lo, hi))
        for name, (lo, hi) in self.integer.items():
            step = rng.integers(-1, 2)
            params[name] = int(np.clip(int(base[name]) + step, lo, hi))
        return params


@dataclasses.dataclass
class Trial:
    trial_id: int
    params: dict
    objective: Optional[float] = None
    history: tuple = ()
    status: str = "PENDING"
    started_at: Optional[float] = None
    ended_at: Optional[float] = None


# ---------------------------------------------------------------------------
# TPE surrogate
# ---------------------------------------------------------------------------

def _kde_logpdf(x: np.ndarray, obs: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """log density of a Gaussian-mixture KDE over ``obs`` evaluated at x,
    Scott-style bandwidth floored at 1% of the range."""
    span = max(hi - lo, 1e-12)
    bw = max(span / max(np.sqrt(len(obs)), 1.0), 0.01 * span)
    diffs = (x[:, None] - obs[None, :]) / bw
    log_comp = -0.5 * diffs**2 - math.log(bw * math.sqrt(2 * math.pi))
    m = log_comp.max(axis=1, keepdims=True)
    return (m + np.log(np.exp(log_comp - m).mean(axis=1, keepdims=True)))[:, 0]


def tpe_propose(
    space: SearchSpace,
    trials: list[Trial],
    rng: np.random.Generator,
    *,
    n_candidates: int = 24,
    gamma: float = 0.25,
) -> dict:
    """Propose params by the TPE density ratio over completed trials."""
    done = [t for t in trials if t.objective is not None and np.isfinite(t.objective)]
    if len(done) < 2:
        return space.sample(rng)
    sign = 1.0 if space.objective_minimize else -1.0
    ranked = sorted(done, key=lambda t: sign * t.objective)
    n_good = max(1, int(np.ceil(gamma * len(ranked))))
    good, bad = ranked[:n_good], ranked[n_good:]

    dims: list[tuple[str, float, float, bool, bool]] = [
        (name, lo, hi, log, False) for name, (lo, hi, log) in space.continuous.items()
    ] + [(name, float(lo), float(hi), False, True) for name, (lo, hi) in space.integer.items()]

    cand_scores = np.zeros(n_candidates)
    cand_values: dict[str, np.ndarray] = {}
    for name, lo, hi, log, is_int in dims:
        tf = (lambda v: math.log(v)) if log else (lambda v: float(v))
        tlo, thi = tf(lo), tf(hi)
        g_obs = np.array([tf(t.params[name]) for t in good])
        span = max(thi - tlo, 1e-12)
        bw = max(span / max(np.sqrt(len(g_obs)), 1.0), 0.01 * span)
        # Sample candidates from the good-KDE (pick a component, jitter).
        centers = g_obs[rng.integers(0, len(g_obs), n_candidates)]
        x = np.clip(centers + rng.normal(0, bw, n_candidates), tlo, thi)
        l_log = _kde_logpdf(x, g_obs, tlo, thi)
        if bad:
            b_obs = np.array([tf(t.params[name]) for t in bad])
            g_log = _kde_logpdf(x, b_obs, tlo, thi)
        else:
            g_log = np.full(n_candidates, -math.log(span))  # uniform
        cand_scores += l_log - g_log
        cand_values[name] = x

    idx = int(np.argmax(cand_scores))
    params = dict(space.static)
    for name, lo, hi, log, is_int in dims:
        v = float(cand_values[name][idx])
        v = math.exp(v) if log else v
        if is_int:
            params[name] = int(np.clip(round(v), lo, hi))
        else:
            params[name] = float(np.clip(v, lo, hi))
    return params


# ---------------------------------------------------------------------------
# Trial execution
# ---------------------------------------------------------------------------

def _make_reporter(space: SearchSpace, history: list, best_fn, early_stopping: bool, patience: int):
    """Per-trial metric callback: records the objective each epoch and
    (sign-safely) stops trials that trail the incumbent.

    Stop when BOTH (a) the trial hasn't improved for ``patience`` epochs
    and (b) its best value so far trails the incumbent by more than 50% of
    the incumbent's absolute scale — correct for objectives of either sign
    (the old rule multiplied the incumbent by 1.5, which inverts for
    negative values)."""
    sign = 1.0 if space.objective_minimize else -1.0

    def report(epoch: int, metrics: dict) -> bool:
        v = metrics.get(space.objective_name)
        if v is None:
            return True
        history.append(float(v))
        best = best_fn()
        if not early_stopping or best is None or best.objective is None:
            return True
        signed = [sign * h for h in history]
        best_so_far = min(signed)
        since_improve = len(signed) - 1 - int(np.argmin(signed))
        incumbent = sign * best.objective
        margin = 0.5 * abs(incumbent) + 1e-9
        trailing = best_so_far > incumbent + margin
        return not (since_improve >= patience and trailing)

    return report


def run_hpo(
    space: SearchSpace,
    train_fn: Callable[[dict, Callable[[int, dict], bool]], dict],
    *,
    max_jobs: int = 10,
    warmup_jobs: int = 4,
    max_parallel_jobs: int = 2,
    seed: int = 0,
    early_stopping: bool = True,
    patience: int = 2,
    strategy: str = "tpe",
) -> tuple[Trial, list[Trial]]:
    """Run up to max_jobs trials, max_parallel_jobs at a time (reference
    MaxParallelTrainingJobs=2, hyperparameter_tuning.py:82); return
    (best, all).

    train_fn(params, report) trains one trial and returns its final val
    metrics dict; it should call report(epoch, metrics) each epoch (the
    metric_callback protocol) and honor a False return as early-stop —
    exactly the surface train_aurora_gan exposes. It must be thread-safe
    when max_parallel_jobs > 1 (e.g. a JobRunner subprocess per trial).
    """
    rng = np.random.default_rng(seed)
    max_parallel_jobs = max(1, max_parallel_jobs)
    sign = 1.0 if space.objective_minimize else -1.0
    trials: list[Trial] = []
    lock = threading.Lock()
    state: dict = {"best": None}

    def best_fn() -> Optional[Trial]:
        with lock:
            return state["best"]

    def propose(t: int) -> dict:
        with lock:
            snapshot = list(trials)
        have_done = any(tr.objective is not None for tr in snapshot)
        if t < warmup_jobs or not have_done:
            return space.sample(rng)
        if strategy == "tpe":
            return tpe_propose(space, snapshot, rng)
        return space.perturb(best_fn().params, rng)

    def run_one(trial: Trial):
        history: list[float] = []
        report = _make_reporter(space, history, best_fn, early_stopping, patience)
        trial.status = "RUNNING"
        trial.started_at = time.time()
        try:
            final_metrics = train_fn(trial.params, report) or {}
            obj = final_metrics.get(space.objective_name)
        except Exception:  # the trial fails; the search goes on
            traceback.print_exc()
            obj = None
        if obj is None and history:
            obj = history[-1]
        trial.objective = float(obj) if obj is not None else None
        trial.history = tuple(history)
        trial.status = "COMPLETED" if trial.objective is not None else "FAILED"
        trial.ended_at = time.time()
        with lock:
            best = state["best"]
            if trial.objective is not None and (
                best is None or sign * trial.objective < sign * best.objective
            ):
                state["best"] = trial
        return trial

    with ThreadPoolExecutor(max_workers=max(1, max_parallel_jobs)) as pool:
        pending = set()
        submitted = 0
        while submitted < max_jobs or pending:
            while submitted < max_jobs and len(pending) < max_parallel_jobs:
                trial = Trial(trial_id=submitted, params=propose(submitted))
                with lock:
                    trials.append(trial)
                pending.add(pool.submit(run_one, trial))
                submitted += 1
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for f in done:
                f.result()  # surface worker crashes

    best = state["best"]
    if best is None:
        raise RuntimeError("no successful HPO trials")
    return best, trials


def describe_best(best: Trial) -> dict:
    """get_best_model.py-shaped summary (:7-55)."""
    return {
        "BestTrainingJob": f"trial-{best.trial_id}",
        "FinalHyperParameters": best.params,
        "FinalObjectiveValue": best.objective,
    }


def trial_timeline(trials: list[Trial]) -> list[dict]:
    """Start/end records proving trial concurrency (tune run artifact)."""
    return [
        {
            "trial_id": t.trial_id,
            "status": t.status,
            "objective": t.objective,
            "started_at": t.started_at,
            "ended_at": t.ended_at,
        }
        for t in trials
    ]
