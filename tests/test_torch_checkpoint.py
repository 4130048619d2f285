"""The port's training checkpoints (`utils/checkpoint.py`, `train/state.py::
state_payload`) and the loop's `save_dir` / `resume` (`train/loop.py`).

A run interrupted after 2 epochs and resumed for a third must equal the
uninterrupted 3-epoch run bit for bit on the CPU: parameters, AdamW moments,
counts and step. Within the 3 warm-up epochs the learning rate does not
depend on the run's length, and each step's noise and each epoch's data order
are seeded by the step and the epoch. The same holds at data 1 x expert 2
over gloo (ranks spawned from `tests/torch_dist_helpers.py`), and the sharded
run's checkpoint restores into a single-process state.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from moegan_tpu.utils import checkpoint as jax_checkpoint
from moegan_tpu_torch.config import DiscriminatorConfig, GeneratorConfig, MeshConfig, TrainConfig
from moegan_tpu_torch.train.state import create_train_state
from moegan_tpu_torch.train.step import draw_noise, make_train_step
from moegan_tpu_torch.utils import checkpoint
from tests import torch_dist_helpers as dh
from tests.torch_helpers import TINY_KW, randn, t

B = 4
CFG = TrainConfig(generator=GeneratorConfig(compute_dtype="float32", **TINY_KW),
                  discriminator=DiscriminatorConfig(max_resolution=16, compute_dtype="float32"),
                  lr=1e-3, batch_size=B, log_interval=1)
SCHED = {"temperature_factor": 2.5, "effective_kl_weight": 1e-3}


def _trained_state(steps=2, seed=3):
    state = create_train_state(CFG, device="cpu", seed=seed)
    step = make_train_step(CFG)
    for i in range(steps):
        batch = {"image": t(np.tanh(randn(80 + i, B, 16, 16, 3))), "text": t(randn(90 + i, B, 512))}
        state, _ = step(state, batch, SCHED, noise=draw_noise(
            state.generator, B, torch.Generator().manual_seed(100 + i)))
    return state


def _assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in ((a.generator, b.generator), (a.discriminator, b.discriminator)):
        for (name, p), q in zip(x.named_parameters(), y.parameters()):
            assert torch.equal(p, q), name
    for x, y in ((a.g_opt, b.g_opt), (a.d_opt, b.d_opt)):
        for f in ("count", "mu", "nu", "notfinite_count"):
            assert torch.equal(getattr(x, f), getattr(y, f)), f


def test_save_keep_three_and_restore(tmp_path):
    d = str(tmp_path / "ckpt")
    fresh = create_train_state(CFG, device="cpu", seed=4)
    assert checkpoint.latest_step(d) is None
    assert checkpoint.restore_checkpoint(d, fresh) == (fresh, 0)
    state = _trained_state()
    for epoch in range(4):  # one state, saved after four epochs under four step numbers
        state.step = 10 * (epoch + 1)
        checkpoint.save_checkpoint(d, state, epoch)
    assert checkpoint.latest_step(d) == 40
    assert sorted(os.listdir(d)) == ["checkpoint_20.pt", "checkpoint_30.pt", "checkpoint_40.pt",
                                     "model_math_version.txt"]
    with open(os.path.join(d, "model_math_version.txt")) as f:
        assert int(f.read()) == checkpoint.MODEL_MATH_VERSION == jax_checkpoint.MODEL_MATH_VERSION
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a matching sidecar does not warn
        restored, start = checkpoint.restore_checkpoint(d, fresh)
    assert start == 4 and restored is fresh
    _assert_states_equal(restored, state)
    payload = torch.load(os.path.join(d, "checkpoint_40.pt"), weights_only=True)
    assert set(payload) == {"step", "epoch", "generator", "discriminator", "optimizer_g",
                            "optimizer_d"}
    assert payload["optimizer_g"]["mu"].keys() == dict(state.generator.named_parameters()).keys()


@pytest.mark.parametrize("sidecar", ["1\n", "garbage", None], ids=["older", "unreadable", "absent"])
def test_math_version_sidecar_warns(tmp_path, sidecar):
    state = _trained_state(steps=1)
    checkpoint.save_checkpoint(str(tmp_path), state, 0)
    path = tmp_path / "model_math_version.txt"
    if sidecar is None:
        path.unlink()
    else:
        path.write_text(sidecar)
    with pytest.warns(UserWarning, match="model-math version"):
        checkpoint.restore_checkpoint(str(tmp_path), create_train_state(CFG, device="cpu"))


def test_restore_refuses_another_architecture(tmp_path):
    checkpoint.save_checkpoint(str(tmp_path), _trained_state(steps=1), 0)
    other = TrainConfig(generator=GeneratorConfig(max_resolution=8, channels={4: 32, 8: 24},
                                                  router_hidden=8, compute_dtype="float32"),
                        discriminator=CFG.discriminator)
    with pytest.raises(ValueError, match="differ from the model"):
        checkpoint.restore_checkpoint(str(tmp_path), create_train_state(other, device="cpu"))


def _assert_runs_equal(got, want):
    assert got["step"] == want["step"]
    for net in ("g", "d"):
        for k, v in want["params"][net].items():
            np.testing.assert_array_equal(got["params"][net][k], v, err_msg=k)
        assert got["moments"][net]["count"] == want["moments"][net]["count"]
        for m in ("mu", "nu"):
            for k, v in want["moments"][net][m].items():
                np.testing.assert_array_equal(got["moments"][net][m][k], v, err_msg=f"{m} {k}")


def test_resumed_run_equals_uninterrupted(tmp_path):
    out = dh.resume_loop(0, 1, CFG.to_dict(), 8, 4, str(tmp_path / "a"), str(tmp_path / "b"),
                         distributed=False)
    assert out["first"]["step"] == 4 and out["whole"]["step"] == 6
    assert any("Resumed from" in line and "at epoch 2" in line
               for line in out["resumed"]["lines"])
    _assert_runs_equal(out["resumed"], out["whole"])
    assert checkpoint.latest_step(str(tmp_path / "a")) == 6


def test_sharded_resume_equals_uninterrupted(tmp_path):
    """data 1 x expert 2: the resumed sharded run against the uninterrupted one, and
    the sharded checkpoint restored into one process."""
    cfg = CFG.replace(mesh=MeshConfig(expert_parallelism=2))
    ranks = dh.spawn("resume_loop", 2, cfg_dict=cfg.to_dict(), n_train=8, n_val=4,
                     interrupted_dir=str(tmp_path / "a"), whole_dir=str(tmp_path / "b"))
    for got in ranks:
        _assert_runs_equal(got["resumed"], got["whole"])
    single = create_train_state(CFG, device="cpu", seed=11)
    single, start = checkpoint.restore_checkpoint(str(tmp_path / "b"), single)
    assert start == 3 and single.step == 6
    assert dh.full_state(single).keys() == ranks[0]["whole"]["params"].keys()
    _assert_runs_equal({"params": dh.full_state(single), "moments": dh.adam_moments(single),
                        "step": single.step}, ranks[0]["whole"])


def test_resume_mid_accumulation_equals_uninterrupted(tmp_path):
    """gradient_accumulation_steps=2 at 3 steps an epoch: the first run stops after
    epoch 1, in the middle of an accumulation round (mini-step 1), and its
    checkpoint carries each optimizer's accumulator and mini-step, so the
    resumed run equals the uninterrupted one bit for bit."""
    cfg = CFG.replace(gradient_accumulation_steps=2)
    out = dh.resume_loop(0, 1, cfg.to_dict(), 12, 4, str(tmp_path / "a"), str(tmp_path / "b"),
                         distributed=False, first_epochs=1)
    assert out["first"]["step"] == 3 and out["whole"]["step"] == 9
    payload = torch.load(str(tmp_path / "a" / "checkpoint_3.pt"), weights_only=True)
    assert payload["optimizer_g"]["mini_step"] == payload["optimizer_d"]["mini_step"] == 1
    assert payload["optimizer_g"]["count"] == 1
    first = out["first"]["moments"]
    assert first["g"]["mini_step"] == 1 and any(v.any() for v in first["g"]["acc"].values())
    _assert_runs_equal(out["resumed"], out["whole"])
    for net in ("g", "d"):
        got, want = out["resumed"]["moments"][net], out["whole"]["moments"][net]
        assert got["mini_step"] == want["mini_step"] == 1 and want["count"] == 4
        for k, v in want["acc"].items():
            np.testing.assert_array_equal(got["acc"][k], v, err_msg=f"acc {k}")
