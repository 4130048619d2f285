"""The port's training and validation steps with the multi-level CLIP loss against
the JAX package's (`train/step.py`, with_clip=True), at the tiny configuration of
`tests/test_torch_train_step.py`, float32 on both sides, with the toy tower pack
(`models/toy_clip.py`) carried across with `convert.py`.

One jit runs the JAX training step under clip_stop_gradient=False (gradients
through the tower) and the JAX validation step on the same initial state. The
port's step under clip_stop_gradient=True must then give the same CLIP losses and
exactly the update of the step without a tower pack: the loss is monitored and
moves no weight.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.flatten_util import ravel_pytree

from moegan_tpu.config import LossConfig as JaxLossConfig
from moegan_tpu.train import step as jax_step_module
from moegan_tpu.train.state import TrainState as JaxTrainState
from moegan_tpu.train.step import make_eval_step as jax_make_eval_step
from moegan_tpu.train.step import make_train_step as jax_make_train_step
from moegan_tpu_torch.config import TrainConfig
from moegan_tpu_torch.convert import torch_to_jax
from moegan_tpu_torch.models.toy_clip import as_tower_pack, init_toy_params
from moegan_tpu_torch.train.state import create_train_state
from moegan_tpu_torch.train.step import make_eval_step, make_train_step
from tests.test_torch_train_step import B, JAX_CFG, SCHED, _raveled_optimizers, _router_noise
from tests.torch_helpers import decisive_router, randn, router_noise_interceptor, t, unflatten

CLIP_WEIGHTS = {16: 0.1, 8: 0.05}
JAX_CLIP_CFG = dataclasses.replace(JAX_CFG, loss=JaxLossConfig(clip_weights=CLIP_WEIGHTS,
                                                             clip_stop_gradient=False))
CLIP_NAMES = ["clip_loss_8", "clip_loss_16"]


def _state(cfg):
    state = create_train_state(cfg, device="cpu", seed=3)
    decisive_router(state.generator)  # hard routing at eval, clear of rounding
    return state


@pytest.fixture(scope="module")
def run():
    cfg = TrainConfig.from_dict(JAX_CLIP_CFG.to_dict())
    assert cfg.loss.clip_weights == CLIP_WEIGHTS and not cfg.loss.clip_stop_gradient
    toy = init_toy_params(16, seed=2)
    toy_jax = unflatten(torch_to_jax(toy.state_dict()))
    state = _state(cfg)
    before = {"g": {k: v.clone() for k, v in state.generator.state_dict().items()},
              "d": {k: v.clone() for k, v in state.discriminator.state_dict().items()}}
    batch = {"image": np.tanh(randn(70, B, 16, 16, 3)), "text": randn(71, B, 512)}
    rng, erng = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    k_z, _, _, k_shuffle = jax.random.split(rng, 4)
    eps = _router_noise(state, 72)
    noise = {"z": t(jax.random.normal(k_z, (B, 512), jnp.float32)),
             "perm": torch.from_numpy(np.array(jax.random.permutation(k_shuffle, B))).long(),
             **{ph: {r: tuple(t(e) for e in v) for r, v in eps[ph].items()} for ph in eps}}
    ek_z, ek_shuffle = jax.random.split(erng)
    eval_noise = {"z": t(jax.random.normal(ek_z, (B, 512), jnp.float32)),
                  "perm": torch.from_numpy(np.array(jax.random.permutation(ek_shuffle, B))).long()}

    with mock.patch.object(jax_step_module, "make_optimizers", _raveled_optimizers):
        jstep, (g_tx, d_tx) = jax_make_train_step(JAX_CLIP_CFG, 20, with_clip=True,
                                                  jit_compile=False)
    jeval = jax_make_eval_step(JAX_CLIP_CFG, with_clip=True).__wrapped__
    g_params = unflatten(torch_to_jax(before["g"]))
    d_params = unflatten(torch_to_jax(before["d"]))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), g_params=g_params, d_params=d_params,
                           g_opt_state=g_tx.init(g_params), d_opt_state=d_tx.init(d_params))
    intercept, calls = router_noise_interceptor([eps["eps_d"], eps["eps_g"]])

    @jax.jit
    def train_and_eval(jstate, batch, sched, clip):
        vm = jeval(jstate, batch, erng, sched, clip)
        return jstep(jstate, batch, rng, sched, clip) + (vm,)

    with fnn.intercept_methods(intercept):
        jsched = {k: jnp.float32(v) for k, v in SCHED.items()}
        jstate, jm, jvm = train_and_eval(jstate, batch, jsched, {"toy": toy_jax})
    assert sorted(calls.values()) == [2, 2, 2]
    return dict(cfg=cfg, toy=toy, before=before, batch={k: t(v) for k, v in batch.items()},
                noise=noise, eval_noise=eval_noise, jstate=jstate, jm=jm, jvm=jvm)


def _port_step(run, stop_gradient=None, with_tower=True):
    cfg = run["cfg"]
    if stop_gradient is not None:
        cfg = cfg.replace(loss=cfg.loss.replace(clip_stop_gradient=stop_gradient))
    state = _state(cfg)
    pack = as_tower_pack(run["toy"]) if with_tower else None
    state, metrics = make_train_step(cfg)(state, run["batch"], SCHED, noise=run["noise"],
                                          clip_params=pack)
    return state, metrics


@pytest.fixture(scope="module")
def through_tower(run):
    return _port_step(run)


@pytest.mark.parametrize("name", ["d_loss", "g_total", "g_loss", "balance_loss", *CLIP_NAMES])
def test_clip_step_metrics_match_jax(run, through_tower, name):
    # test_torch_train_step.py's tolerance
    np.testing.assert_allclose(through_tower[1][name].numpy(), np.asarray(run["jm"][name]),
                               rtol=1e-4, atol=1e-7)


def _moments(opt, module) -> dict:
    sizes = [p.numel() for p in module.parameters()]
    return torch_to_jax({n: m.view_as(p) for m, (n, p) in
                         zip(opt.mu.split(sizes), module.named_parameters())})


@pytest.mark.parametrize("net", ["g", "d"])
def test_clip_step_gradients_match_jax(run, through_tower, net):
    """Adam's first moment after one step against the JAX step's, with
    test_torch_train_step.py::test_step_gradients_match_jax's tolerances; here the
    generator's gradient includes the CLIP loss's, through the toy tower."""
    state = through_tower[0]
    module, opt = ((state.generator, state.g_opt) if net == "g"
                   else (state.discriminator, state.d_opt))
    jparams = run["jstate"].g_params if net == "g" else run["jstate"].d_params
    jopt = run["jstate"].g_opt_state if net == "g" else run["jstate"].d_opt_state
    got = _moments(opt, module)
    (want_flat,) = [s.mu for s in jax.tree_util.tree_leaves(
        jopt, is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu")) if hasattr(s, "mu")]
    want = {"/".join(p.key for p in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(ravel_pytree(jparams)[1](want_flat))[0]}
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    share = {k: float((np.abs(got[k] - w) > 1e-3 * np.abs(w).max() + 1e-6 * top).mean())
             for k, w in want.items()}
    diff = np.sqrt(sum(np.sum((got[k] - w) ** 2) for k, w in want.items()))
    rel = diff / np.sqrt(sum(np.sum(w ** 2) for w in want.values()))
    print(f"{net}: largest share outside {max(share.values())}, relative L2 error {rel}")
    assert max(share.values()) <= 1e-2 and rel <= 1e-3


def test_stop_gradient_monitors_and_moves_nothing(run, through_tower):
    """clip_stop_gradient=True: the same CLIP losses, and exactly the update of the
    step without a tower pack."""
    state, metrics = _port_step(run, stop_gradient=True)
    plain_state, plain = _port_step(run, stop_gradient=True, with_tower=False)
    for name in CLIP_NAMES:
        np.testing.assert_allclose(metrics[name].numpy(), through_tower[1][name].numpy(),
                                   rtol=1e-6)
        assert name not in plain
    clip_sum = sum(CLIP_WEIGHTS[int(n.rsplit("_", 1)[1])] * metrics[n] for n in CLIP_NAMES)
    np.testing.assert_allclose(metrics["g_total"].numpy(), (plain["g_total"] + clip_sum).numpy(),
                               rtol=1e-6)
    for a, b in ((state.generator, plain_state.generator),
                 (state.discriminator, plain_state.discriminator)):
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(p, q), name
    for a, b in ((state.g_opt, plain_state.g_opt), (state.d_opt, plain_state.d_opt)):
        assert torch.equal(a.mu, b.mu) and torch.equal(a.nu, b.nu)
    # and the generator did move: the step differs from the one through the tower
    assert not torch.equal(state.g_opt.mu, through_tower[0].g_opt.mu)


def test_clip_eval_step_matches_jax(run):
    state = _state(run["cfg"])
    got = make_eval_step(run["cfg"])(state, run["batch"], SCHED, noise=run["eval_noise"],
                                     clip_params=as_tower_pack(run["toy"]))
    want = run["jvm"]
    assert set(got) == set(want) == {"val_d_loss", "val_g_loss", "val_clip_loss_8",
                                     "val_clip_loss_16", "val_clip_loss"}
    for k, v in want.items():
        # test_torch_train_eval.py's tolerance
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
