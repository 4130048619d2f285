"""The port's training step against the JAX package's (`train/step.py`), one step
at a tiny configuration, float32 on both sides.

The JAX step runs through `make_train_step(..., with_clip=False,
jit_compile=False)` on the port's seeded weights, carried across with
`convert.py`. Both steps take the same batch, z and shuffle (from the JAX
step's own `jax.random.split(rng, 4)`) and the same router noise: the JAX
routers get it through `flax.linen.intercept_methods`, which replaces
`BayesianRouter.sample_weights(True)` by `reparameterize(mu, rho, eps)` on
the test's eps, keyed by the router's path and its call count (the D-phase
forward first, then the G phase).

The JAX step's optimizers are its own optax chains, run over the raveled
parameter vector instead of the parameter tree: the same arithmetic
(the global norm of one vector is the global norm of the tree), but XLA on
the CPU compiles it in a second instead of the ~30 s it takes over the
tiny generator's 192 leaves, which keeps this file inside its time budget.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from jax.flatten_util import ravel_pytree

from moegan_tpu.config import DiscriminatorConfig as JaxDiscriminatorConfig
from moegan_tpu.config import GeneratorConfig as JaxGeneratorConfig
from moegan_tpu.config import TrainConfig as JaxTrainConfig
from moegan_tpu.train import step as jax_step_module
from moegan_tpu.train.state import TrainState as JaxTrainState
from moegan_tpu.train.state import make_optimizers as jax_make_optimizers
from moegan_tpu.train.step import make_train_step as jax_make_train_step
from moegan_tpu_torch.config import TrainConfig
from moegan_tpu_torch.convert import torch_to_jax
from moegan_tpu_torch.train.state import clipped_adamw_update, create_train_state, init_adamw
from moegan_tpu_torch.train.step import draw_noise, make_train_step
from tests.torch_helpers import TINY_KW, randn, router_noise_interceptor, t, unflatten

B = 4
LR = 1e-3
SCHED = {"temperature_factor": 2.5, "effective_kl_weight": 1e-3}
JAX_CFG = JaxTrainConfig(
    generator=JaxGeneratorConfig(use_pallas=True, compute_dtype="float32", **TINY_KW),
    discriminator=JaxDiscriminatorConfig(max_resolution=16, compute_dtype="float32"),
    steps_per_epoch=20, lr=LR,
)


def _router_noise(state, seed):
    """numpy eps for both phases, in the shapes of the port's routers."""
    shapes = draw_noise(state.generator, B)
    rng = np.random.default_rng(seed)
    return {ph: {r: tuple(rng.standard_normal(e.shape).astype(np.float32) for e in eps)
                 for r, eps in shapes[ph].items()} for ph in ("eps_d", "eps_g")}


def _raveled(tx):
    """`tx` over the raveled parameter vector."""

    def init(params):
        return tx.init(ravel_pytree(params)[0])

    def update(updates, state, params=None):
        flat, unravel = ravel_pytree(updates)
        new, state = tx.update(flat, state, ravel_pytree(params)[0])
        return unravel(new), state

    return optax.GradientTransformation(init, update)


def _raveled_optimizers(cfg, steps_per_epoch):
    return tuple(_raveled(tx) for tx in jax_make_optimizers(cfg, steps_per_epoch))


# The port's step runs under its default flags and under the JAX package's
# opt-in kernel configuration (the LayerNorm kernels and the legacy
# three-kernel MoE backward; on the CPU their plain twins). JAX on the CPU
# takes its XLA routes under either flag, so its one step is the reference
# for both.
FLAGS = {"default": {}, "opt_in": {"MOEGAN_FUSED_LN": "1", "MOEGAN_PALLAS_MOE_BWD": "3"}}


@pytest.fixture(scope="module")
def jax_one_step():
    """The inputs of the step and the JAX step's result, computed once."""
    cfg = TrainConfig.from_dict(JAX_CFG.to_dict())
    state = create_train_state(cfg, device="cpu", seed=3)
    before = {"g": {k: v.clone() for k, v in state.generator.state_dict().items()},
              "d": {k: v.clone() for k, v in state.discriminator.state_dict().items()}}
    batch = {"image": np.tanh(randn(40, B, 16, 16, 3)), "text": randn(41, B, 512)}
    rng = jax.random.PRNGKey(7)
    k_z, _, _, k_shuffle = jax.random.split(rng, 4)
    eps = _router_noise(state, 42)
    noise = {"z": t(jax.random.normal(k_z, (B, 512), jnp.float32)),
             "perm": torch.from_numpy(np.array(jax.random.permutation(k_shuffle, B))).long(),
             **{ph: {r: tuple(t(e) for e in v) for r, v in eps[ph].items()} for ph in eps}}

    with mock.patch.object(jax_step_module, "make_optimizers", _raveled_optimizers):
        jstep, (g_tx, d_tx) = jax_make_train_step(JAX_CFG, 20, with_clip=False,
                                                  jit_compile=False)
    g_params = unflatten(torch_to_jax(before["g"]))
    d_params = unflatten(torch_to_jax(before["d"]))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), g_params=g_params, d_params=d_params,
                           g_opt_state=g_tx.init(g_params), d_opt_state=d_tx.init(d_params))
    intercept, calls = router_noise_interceptor([eps["eps_d"], eps["eps_g"]])
    with fnn.intercept_methods(intercept):  # the interceptor acts while jit traces
        jsched = {k: jnp.float32(v) for k, v in SCHED.items()}
        jstate, jm = jax.jit(jstep)(jstate, batch, rng, jsched)
    assert sorted(calls.values()) == [2, 2, 2]  # each router: the D phase, then the G phase
    return dict(cfg=cfg, before=before, batch=batch, noise=noise, jstate=jstate, jm=jm)


@pytest.fixture(scope="module", params=sorted(FLAGS))
def one_step(request, jax_one_step):
    """The port's step from the same weights, batch and noise, under one flag set."""
    j = jax_one_step
    env = {k: v for k, v in os.environ.items()
           if k not in ("MOEGAN_FUSED_LN", "MOEGAN_PALLAS_MOE_BWD")}
    with mock.patch.dict(os.environ, {**env, **FLAGS[request.param]}, clear=True):
        state = create_train_state(j["cfg"], device="cpu", seed=3)
        for k, v in state.generator.state_dict().items():
            assert torch.equal(v, j["before"]["g"][k])
        step = make_train_step(j["cfg"])
        state, metrics = step(state, {k: t(v) for k, v in j["batch"].items()}, SCHED,
                              noise=j["noise"])
    return dict(state=state, metrics=metrics, before=j["before"], jstate=j["jstate"],
                jm=j["jm"])


@pytest.mark.parametrize("name", ["d_loss", "r1_loss", "d_total", "g_total", "g_loss",
                                  "kl_loss", "balance_loss"])
def test_step_metrics_match_jax(one_step, name):
    # float32 on both sides, summed in other orders through two generator
    # forwards, four discriminator passes and a double backward.
    np.testing.assert_allclose(one_step["metrics"][name].numpy(), np.asarray(one_step["jm"][name]),
                               rtol=1e-4, atol=1e-7)


def test_step_routing_statistics_match_jax(one_step):
    for name in ("expert_util", "expert_top1"):
        np.testing.assert_allclose(one_step["metrics"][name].numpy(),
                                   np.asarray(one_step["jm"][name]), rtol=1e-5, atol=1e-6)


def _jax_flat(tree) -> dict:
    """{"a/b/c": ndarray} of a JAX param tree."""
    return {"/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nets(one_step, net):
    """(port module, its params before the step, JAX params after, JAX Adam state)."""
    state, jstate = one_step["state"], one_step["jstate"]
    if net == "g":
        return state.generator, state.g_opt, jstate.g_params, jstate.g_opt_state
    return state.discriminator, state.d_opt, jstate.d_params, jstate.d_opt_state


@pytest.mark.parametrize("net", ["g", "d"])
def test_step_updates_match_jax(one_step, net):
    """p_new - p_old per element, in units of the first update's learning rate.

    At step 1 Adam's direction is g / (|g| + 1e-8): about sign(g), but where
    |g| is near 1e-8 float32 summation order moves it (by up to 7e-3 lr at
    this seed). The tolerance is 1e-2 lr; at most 0.1 % of any tensor may
    lie outside it.
    """
    lr0 = 0.1 * LR  # the warm-up's first learning rate
    module, _, jparams, _ = _nets(one_step, net)
    after = torch_to_jax(module.state_dict())
    before = torch_to_jax(one_step["before"][net])
    want_after = _jax_flat(jparams)
    assert set(want_after) == set(after)
    share = {}
    for key, a in after.items():
        got = (a - before[key]) / lr0
        want = (want_after[key] - before[key]) / lr0
        share[key] = float((np.abs(got - want) > 1e-2).mean())
    print(f"{net}: largest share of a tensor outside 1e-2 lr: {max(share.values())}")
    assert max(share.values()) <= 1e-3, {k: v for k, v in share.items() if v > 1e-3}


@pytest.mark.parametrize("net", ["g", "d"])
def test_step_gradients_match_jax(one_step, net):
    """Adam's first moment after one step is (1 - b1) times the clipped
    gradient: compare it for every parameter.

    float32 sums in other orders through the whole step: the tolerance is
    1e-3 of the tensor's largest |gradient| plus 1e-6 of the network's
    (gradients that are zero in exact arithmetic, such as the self-attention
    key bias's, are rounding noise many orders below the rest). The two fake
    images differ by float32 noise, which can move a pre-activation of D
    across LeakyReLU's kink and change that term's slope from 1 to 0.2: at
    most 1 % of a tensor's elements may lie outside the tolerance, and the
    whole gradient must agree to 1e-3 in relative L2 norm (one such flip
    gives about 1e-4 at this seed).
    """
    module, opt, jparams, jopt = _nets(one_step, net)
    sizes = [p.numel() for p in module.parameters()]
    mu = {n: m.view_as(p) for m, (n, p) in zip(opt.mu.split(sizes), module.named_parameters())}
    got = torch_to_jax(mu)
    (want_flat,) = [s.mu for s in jax.tree_util.tree_leaves(
        jopt, is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu")) if hasattr(s, "mu")]
    want = _jax_flat(ravel_pytree(jparams)[1](want_flat))
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    share = {k: float((np.abs(got[k] - w) > 1e-3 * np.abs(w).max() + 1e-6 * top).mean())
             for k, w in want.items()}
    diff = np.sqrt(sum(np.sum((got[k] - w) ** 2) for k, w in want.items()))
    rel = diff / np.sqrt(sum(np.sum(w ** 2) for w in want.values()))
    print(f"{net}: largest share outside {max(share.values())}, relative L2 error {rel}")
    assert max(share.values()) <= 1e-2, {k: v for k, v in share.items() if v > 1e-2}
    assert rel <= 1e-3


def _tiny_state(seed=0):
    cfg = TrainConfig.from_dict(JAX_CFG.to_dict())
    return cfg, create_train_state(cfg, device="cpu", seed=seed)


def test_nan_batch_is_skipped():
    cfg, state = _tiny_state()
    step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    # NaN text poisons both phases (a NaN image would poison only D's)
    batch = {"image": t(np.tanh(randn(1, B, 16, 16, 3))),
             "text": torch.full((B, 512), float("nan"))}
    before = [p.clone() for p in list(state.generator.parameters())
              + list(state.discriminator.parameters())]
    opts = [(o.count.clone(), o.mu.clone(), o.nu.clone()) for o in (state.g_opt, state.d_opt)]
    state, metrics = step(state, batch, SCHED, generator=gen)
    assert not torch.isfinite(metrics["d_total"])
    after = list(state.generator.parameters()) + list(state.discriminator.parameters())
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    for o, (count, mu, nu) in zip((state.g_opt, state.d_opt), opts):
        assert torch.equal(o.count, count) and torch.equal(o.mu, mu) and torch.equal(o.nu, nu)
        assert o.notfinite_count.item() == 1
    # a finite batch afterwards updates everything and resets the counter
    batch = {"image": t(np.tanh(randn(2, B, 16, 16, 3))), "text": t(randn(3, B, 512))}
    state, metrics = step(state, batch, SCHED, generator=gen)
    assert torch.isfinite(metrics["g_total"]) and state.step == 2
    assert state.g_opt.count.item() == 1 and state.g_opt.notfinite_count.item() == 0
    assert not torch.equal(next(state.generator.parameters()), before[0])


def test_nonfinite_updates_pass_after_the_limit():
    p = [torch.ones(3)]
    opt = init_adamw(p)
    bad = [torch.tensor([1.0, float("inf"), 0.5])]
    kw = dict(lr_fn=lambda count: torch.tensor(0.1), clip=1.0, b1=0.5, b2=0.999,
              weight_decay=0.0, max_consecutive_errors=2)
    for i in range(2):
        clipped_adamw_update(p, bad, opt, **kw)
        assert torch.equal(p[0], torch.ones(3)) and opt.count.item() == 0
        assert opt.notfinite_count.item() == i + 1
    clipped_adamw_update(p, bad, opt, **kw)  # the third in a row passes through
    assert not torch.isfinite(p[0]).all() and opt.count.item() == 1
    assert opt.notfinite_count.item() == 3


def test_clip_matches_optax_and_schedule_matches_optax():
    from moegan_tpu.train.schedules import warmup_cosine as jax_warmup_cosine
    from moegan_tpu_torch.train.schedules import warmup_cosine

    sched = jax_warmup_cosine(2e-4, 5, 10, 2, 0.05)
    counts = np.arange(0, 60)
    np.testing.assert_allclose(warmup_cosine(torch.from_numpy(counts), 2e-4, 5, 10, 2, 0.05),
                               np.asarray(sched(counts)), rtol=1e-6)
    # one update from a fresh state, over two tensors whose global norm is 5 > clip
    grads = [randn(50, 3, 4) * 2, randn(51, 5)]
    params = [randn(52, 3, 4), randn(53, 5)]
    tx = optax.chain(optax.clip_by_global_norm(0.8),
                     optax.adamw(sched, b1=0.5, b2=0.999, weight_decay=0.01))
    updates, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(params), params)
    ps = [t(p) for p in params]
    clipped_adamw_update(ps, [t(g) for g in grads], init_adamw(ps),
                         lambda c: warmup_cosine(c, 2e-4, 5, 10, 2, 0.05), 0.8, 0.5, 0.999, 0.01)
    for got, p, u in zip(ps, params, updates):
        np.testing.assert_allclose(got.numpy(), p + np.asarray(u), rtol=0, atol=1e-9)


def test_entry_points_refuse_what_is_not_ported(monkeypatch):
    """Every option the JAX step trains is accepted (tests/test_torch_train_options.py
    holds each against JAX); what is refused is a card that is not there."""
    from moegan_tpu_torch.train import step as step_module
    from moegan_tpu_torch.train.step import make_eval_step

    cfg = TrainConfig.from_dict(JAX_CFG.to_dict())
    assert not hasattr(step_module, "check_supported")
    state = create_train_state(cfg, device="cpu", seed=1)
    batch = {"image": t(np.tanh(randn(4, B, 16, 16, 3))), "text": t(randn(5, B, 512))}
    for opt in (dict(shared_fake=True), dict(gradient_accumulation_steps=2),
                dict(loss=cfg.loss.replace(gan_loss="hinge")),
                dict(loss=cfg.loss.replace(balance_all_blocks=True, balance_kind="switch"))):
        make_train_step(cfg.replace(**opt))
        val = make_eval_step(cfg.replace(**opt))(state, batch, SCHED,
                                                  generator=torch.Generator().manual_seed(0))
        assert all(bool(torch.isfinite(v)) for v in val.values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(cfg)
