"""The training options of the port's step against the JAX package's: the hinge
loss with the switch balance over every block, `shared_fake`, and gradient
accumulation (`optax.MultiSteps` inside the non-finite skip), float32 at the
tiny configuration of `tests/test_torch_train_step.py`.

The JAX steps run with `jit_compile=False` and their optimizers over the
raveled parameter vector (as in test_torch_train_step.py), all of them in
one `jax.jit`: the hinge step, the shared-fake step and the two mini-steps
of the accumulating step, traced in that order, so that the router-noise
interceptor hands each router call its eps in turn. Under `shared_fake`
the JAX step makes one router call per router, under the G phase's noise.
The routers' combined_mu is scaled (`decisive_router`) so that the switch
balance's hard top-1 counts do not depend on float32 summation order.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.flatten_util import ravel_pytree

from moegan_tpu.losses import gan as jax_gan
from moegan_tpu.train import step as jax_step_module
from moegan_tpu.train.state import TrainState as JaxTrainState
from moegan_tpu.train.state import make_optimizers as jax_make_optimizers
from moegan_tpu.train.step import make_train_step as jax_make_train_step
from moegan_tpu_torch.config import MeshConfig, TrainConfig
from moegan_tpu_torch.convert import torch_to_jax
from moegan_tpu_torch.losses import gan
from moegan_tpu_torch.train.schedules import warmup_cosine
from moegan_tpu_torch.train.state import clipped_adamw_update, create_train_state, init_adamw
from moegan_tpu_torch.train.step import draw_noise, make_train_step
from tests import torch_dist_helpers as dh
from tests.test_torch_train_step import B, JAX_CFG, LR, SCHED, _jax_flat, _raveled_optimizers
from tests.torch_helpers import ROUTER_SCALE, decisive_router, randn, router_noise_interceptor, t
from tests.torch_helpers import unflatten

# balance_weight 1: the switch term's gradient weighs in the G gradient.
HINGE = JAX_CFG.replace(loss=JAX_CFG.loss.replace(gan_loss="hinge", balance_kind="switch",
                                                  balance_all_blocks=True, balance_weight=1.0))
SHARED = JAX_CFG.replace(shared_fake=True)
ACCUM = JAX_CFG.replace(gradient_accumulation_steps=2)
CASES = {"hinge_switch": (HINGE, 1), "shared_fake": (SHARED, 1), "accumulate": (ACCUM, 2)}
LOSSES = ("d_loss", "r1_loss", "d_total", "g_total", "g_loss", "kl_loss", "balance_loss")


def _router_noise(state, seed):
    shapes = draw_noise(state.generator, B)
    rng = np.random.default_rng(seed)
    return {ph: {r: tuple(rng.standard_normal(e.shape).astype(np.float32) for e in eps)
                 for r, eps in shapes[ph].items()} for ph in ("eps_d", "eps_g")}


def _step_inputs(state, seed):
    """(batch, rng, eps, port noise) of one step."""
    batch = {"image": np.tanh(randn(seed, B, 16, 16, 3)), "text": randn(seed + 1, B, 512)}
    rng = jax.random.PRNGKey(seed + 2)
    k_z, _, _, k_shuffle = jax.random.split(rng, 4)
    eps = _router_noise(state, seed + 3)
    noise = {"z": t(jax.random.normal(k_z, (B, 512), jnp.float32)),
             "perm": torch.from_numpy(np.array(jax.random.permutation(k_shuffle, B))).long(),
             **{ph: {r: tuple(t(e) for e in v) for r, v in eps[ph].items()} for ph in eps}}
    return batch, rng, eps, noise


def _snapshot(state):
    """Parameters and optimizer state of the port's state, copied."""
    out = {"g": {k: v.clone() for k, v in state.generator.state_dict().items()},
           "d": {k: v.clone() for k, v in state.discriminator.state_dict().items()}}
    for net, opt in (("g", state.g_opt), ("d", state.d_opt)):
        out[f"{net}_opt"] = {k: (None if v is None else v.clone())
                             for k, v in vars(opt).items()}
    return out


@pytest.fixture(scope="module")
def runs():
    """Each case's port steps and JAX steps from the same weights, batches and noise."""
    cases, jstates, jinputs, order = {}, {}, {}, []
    for ci, (name, (jcfg, n)) in enumerate(CASES.items()):
        cfg = TrainConfig.from_dict(jcfg.to_dict())
        state = create_train_state(cfg, device="cpu", seed=3)
        decisive_router(state.generator)
        before = _snapshot(state)
        steps = [_step_inputs(state, 100 * ci + 10 * i) for i in range(n)]
        with mock.patch.object(jax_step_module, "make_optimizers", _raveled_optimizers):
            jstep, (g_tx, d_tx) = jax_make_train_step(jcfg, 20, with_clip=False,
                                                      jit_compile=False)
        g_params = unflatten(torch_to_jax(before["g"]))
        d_params = unflatten(torch_to_jax(before["d"]))
        jstates[name] = JaxTrainState(step=jnp.zeros((), jnp.int32), g_params=g_params,
                                      d_params=d_params, g_opt_state=g_tx.init(g_params),
                                      d_opt_state=d_tx.init(d_params))
        jinputs[name] = [(batch, rng) for batch, rng, _, _ in steps]
        for _, _, eps, _ in steps:  # the router calls of the step, in order
            order += [eps["eps_g"]] if jcfg.shared_fake else [eps["eps_d"], eps["eps_g"]]
        port = []
        step = make_train_step(cfg)
        for batch, _, _, noise in steps:
            state, metrics = step(state, {k: t(v) for k, v in batch.items()}, SCHED, noise=noise)
            port.append((_snapshot(state), metrics))
        cases[name] = dict(jstep=jstep, before=before, port=port)

    intercept, calls = router_noise_interceptor(order)
    jsched = {k: jnp.float32(v) for k, v in SCHED.items()}

    def run_all(jstates, jinputs):
        out = {}
        for name in CASES:
            s, res = jstates[name], []
            for batch, rng in jinputs[name]:
                s, m = cases[name]["jstep"](s, batch, rng, jsched)
                res.append((s, m))
            out[name] = res
        return out

    with fnn.intercept_methods(intercept):  # the interceptor acts while jit traces
        jres = jax.jit(run_all)(jstates, jinputs)
    # each router: hinge D and G, shared G, two mini-steps' D and G
    assert sorted(calls.values()) == [7, 7, 7]
    for name in CASES:
        cases[name]["jax"] = jres[name]
    return cases


def _opt_field(opt_state, field):
    """The flat array `field` (mu, nu, acc_grads) of a raveled JAX optimizer state."""
    (node,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, field)) if hasattr(s, field)]
    return np.asarray(getattr(node, field))


def _per_name(flat: torch.Tensor, like: dict) -> dict:
    """{JAX path: ndarray} of a flat port buffer laid out as the state dict `like`."""
    sizes = [v.numel() for v in like.values()]
    return torch_to_jax({k: v.view_as(p) for v, (k, p) in zip(flat.split(sizes), like.items())})


def _assert_metrics(metrics, jm):
    for k in LOSSES:
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(jm[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    for k in ("expert_util", "expert_top1"):
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(jm[k]), rtol=1e-5, atol=1e-6)


def _jax_moment(jstate, net, field="mu"):
    """{JAX path: ndarray} of a moment (or the accumulator) of the JAX state's `net`."""
    jparams, jopt = getattr(jstate, f"{net}_params"), getattr(jstate, f"{net}_opt_state")
    return _jax_flat(ravel_pytree(jparams)[1](_opt_field(jopt, field)))


def _assert_updates(before, after, jstate, net):
    """p_new - p_old in units of the first update's learning rate: within 1e-2 lr
    for all but 0.1 % of any tensor (test_torch_train_step.py's limit). Adam's
    first direction is about mu / (|mu| + 1e-8): where JAX's |mu| is below 1e-6
    of the network's largest, float32 rounding of the gradient moves it by
    more than that, and those elements are left out."""
    lr0 = 0.1 * LR
    b, a = torch_to_jax(before), torch_to_jax(after)
    want, mu = _jax_flat(getattr(jstate, f"{net}_params")), _jax_moment(jstate, net)
    assert set(a) == set(want)
    top = max(np.abs(m).max() for m in mu.values())
    share = {k: float(((np.abs((a[k] - b[k]) / lr0 - (want[k] - b[k]) / lr0) > 1e-2)
                       & (np.abs(mu[k]) >= 1e-6 * top)).mean()) for k in want}
    assert max(share.values()) <= 1e-3, {k: v for k, v in share.items() if v > 1e-3}


def _rel_l2(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    num = sum(np.sum((got[k] - w) ** 2) for k, w in want.items())
    return float(np.sqrt(num / sum(np.sum(w ** 2) for w in want.values())))


def _assert_moments(snap, jstate, field="mu", port_field="mu"):
    """Adam's moments (or the accumulator) within 1e-3 in relative L2, per network."""
    for net in ("g", "d"):
        rel = _rel_l2(_per_name(snap[f"{net}_opt"][port_field], snap[net]),
                      _jax_moment(jstate, net, field))
        assert rel <= 1e-3, (net, field, rel)


@pytest.mark.parametrize("name", ["hinge_switch", "shared_fake"])
def test_one_option_step_matches_jax(runs, name):
    run = runs[name]
    (snap, metrics), = run["port"]
    (jstate, jm), = run["jax"]
    if name == "hinge_switch":  # the hinge terms and a switch balance above its floor of 1
        assert float(metrics["balance_loss"]) > 1.0
    _assert_metrics(metrics, jm)
    for net in ("g", "d"):
        _assert_updates(run["before"][net], snap[net], jstate, net)
    for field in ("mu", "nu"):
        _assert_moments(snap, jstate, field, field)
    assert int(snap["g_opt"]["count"]) == int(snap["d_opt"]["count"]) == 1


def test_accumulation_matches_multisteps(runs):
    """gradient_accumulation_steps=2: the first mini-step accumulates and leaves
    the parameters bit for bit; the second applies AdamW to the mean."""
    run = runs["accumulate"]
    (snap1, m1), (snap2, m2) = run["port"]
    (js1, jm1), (js2, jm2) = run["jax"]
    _assert_metrics(m1, jm1)
    _assert_metrics(m2, jm2)
    for net in ("g", "d"):
        for k, v in run["before"][net].items():
            assert torch.equal(snap1[net][k], v), k
        opt = snap1[f"{net}_opt"]
        assert (int(opt["count"]), int(opt["mini_step"])) == (0, 1)
        assert not opt["mu"].any()
    _assert_moments(snap1, js1, "acc_grads", "acc")  # the first mini-step's gradient
    for net in ("g", "d"):
        _assert_updates(run["before"][net], snap2[net], js2, net)
        opt = snap2[f"{net}_opt"]
        assert (int(opt["count"]), int(opt["mini_step"])) == (1, 0)
        assert not opt["acc"].any()
    for field in ("mu", "nu"):
        _assert_moments(snap2, js2, field, field)


def test_optimizer_accumulates_like_optax_across_a_nonfinite_call():
    """The port's optimizer against the JAX chain, skip_if_nonfinite(MultiSteps(
    chain(clip, adamw), 2)), over finite, non-finite, finite, finite gradients:
    the non-finite call leaves the accumulator and mini-step as they were."""
    cfg = JAX_CFG.replace(gradient_accumulation_steps=2, lr_warmup_epochs=1)
    g_tx, _ = jax_make_optimizers(cfg, 2)
    params = [randn(60, 3, 4), randn(61, 5)]
    jparams = [jnp.asarray(p) for p in params]
    jstate = g_tx.init(jparams)
    ps = [t(p) for p in params]
    opt = init_adamw(ps, every_k=2)
    lr_fn = lambda c: warmup_cosine(c, cfg.lr, cfg.num_epochs, 2, 1, cfg.lr_min_fraction)
    grads = [[randn(62, 3, 4) * 3, randn(63, 5)], [np.full((3, 4), np.inf, np.float32),
                                                   randn(64, 5)],
             [randn(65, 3, 4), randn(66, 5) * 2], [randn(67, 3, 4), randn(68, 5)]]
    want = [(0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 1, 0)]  # count, mini_step, notfinite_count
    for i, g in enumerate(grads):
        updates, jstate = g_tx.update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = [p + u for p, u in zip(jparams, updates)]
        clipped_adamw_update(ps, [t(x) for x in g], opt, lr_fn, cfg.grad_clip_g, cfg.beta1,
                             cfg.beta2, cfg.weight_decay, every_k=2)
        multi = jstate.inner_state
        adam = jstate.inner_state.inner_opt_state[1][0]
        got = (int(opt.count), int(opt.mini_step), int(opt.notfinite_count))
        assert got == want[i] == (int(adam.count), int(multi.mini_step),
                                  int(jstate.notfinite_count)), (i, got)
        for a, b in zip(ps, jparams):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9)
        acc = np.concatenate([np.asarray(x).reshape(-1) for x in multi.acc_grads])
        np.testing.assert_allclose(opt.acc.numpy(), acc, rtol=1e-6, atol=0)
        for m, name in ((opt.mu, "mu"), (opt.nu, "nu")):
            ref = np.concatenate([np.asarray(x).reshape(-1) for x in getattr(adam, name)])
            np.testing.assert_allclose(m.numpy(), ref, rtol=1e-5, atol=1e-12)
    assert all(bool(torch.isfinite(p).all()) for p in ps)


def test_gan_and_balance_losses_match_jax():
    real, fake, mism = randn(70, 8), randn(71, 8), randn(72, 8)
    for kind in ("hinge", "nonsaturating", "anything_else"):
        np.testing.assert_allclose(
            gan.discriminator_loss(t(real), t(fake), t(mism), kind).numpy(),
            np.asarray(jax_gan.discriminator_loss(real, fake, mism, kind)), rtol=1e-6)
        np.testing.assert_allclose(gan.generator_loss(t(fake), kind).numpy(),
                                   np.asarray(jax_gan.generator_loss(fake, kind)), rtol=1e-6)
    routing = [np.asarray(jax.nn.softmax(randn(73 + i, 2, n, 4) * 3)) for i, n in
               enumerate((16, 64, 256))]
    for all_blocks in (False, True):
        for kind in ("cv", "switch"):
            got = gan.moe_balance_loss([t(r) for r in routing], 0.5, all_blocks, kind)
            want = jax_gan.moe_balance_loss(routing, 0.5, all_blocks, kind)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert float(gan.moe_balance_loss([], 0.5, True, "switch")) == 0.0
    # the switch balance's gradient: E * f_i / N per element, f without gradient
    p = t(routing[1]).requires_grad_(True)
    (grad,) = torch.autograd.grad(gan.switch_balance(p), p)
    want = jax.grad(lambda x: jax_gan._switch_balance(x))(routing[1])
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)


def test_two_ranks_switch_and_accumulation_match_single_device():
    """data 2 x expert 2 on four ranks over gloo: the switch balance over every
    block (its counts and probabilities summed over the data group) and
    accumulation over two mini-steps, against the port's single-process step."""
    cfg = TrainConfig.from_dict(JAX_CFG.to_dict())
    cfg = cfg.replace(gradient_accumulation_steps=2, batch_size=B,
                      mesh=MeshConfig(expert_parallelism=2),
                      loss=cfg.loss.replace(balance_kind="switch", balance_all_blocks=True,
                                            balance_weight=1.0))
    state = create_train_state(cfg, device="cpu", seed=5)
    decisive_router(state.generator)
    init = dh.full_state(state)
    batches = [{"image": t(np.tanh(randn(80 + i, B, 16, 16, 3))), "text": t(randn(90 + i, B, 512))}
               for i in range(2)]
    noises = [draw_noise(state.generator, B, torch.Generator().manual_seed(95 + i))
              for i in range(2)]
    step = make_train_step(cfg)
    single = []
    for batch, noise in zip(batches, noises):
        state, m = step(state, batch, SCHED, noise=noise)
        single.append(({k: v.numpy() for k, v in m.items()}, dh.full_state(state)))
    moments = dh.first_moments(state)
    ranks = dh.spawn("train_steps", 4, cfg_dict=cfg.to_dict(), seed=5, batches=batches,
                     noises=noises, schedule=SCHED, moments_after=2, router_scale=ROUTER_SCALE)
    for r, got in enumerate(ranks):
        assert got["mesh"] == ((2, 2), r // 2, r % 2)
        assert got["counts"] == [[1, 0, 0], [1, 0, 0]]
        for i, (want_m, _) in enumerate(single):
            for k, v in want_m.items():
                np.testing.assert_allclose(got["metrics"][i][k], v, rtol=1e-4, atol=1e-6,
                                           err_msg=f"rank {r} step {i + 1} {k}")
        assert float(got["metrics"][0]["balance_loss"]) > 1.0
        # no update after the first mini-step: the whole parameters as created
        for net in ("g", "d"):
            for k, v in init[net].items():
                np.testing.assert_array_equal(got["params_each"][0][net][k], v, err_msg=k)
            for k, v in moments[net].items():  # the mean gradient of the two mini-steps
                np.testing.assert_allclose(got["moments"][net][k], v, rtol=1e-4, atol=1e-6,
                                           err_msg=f"rank {r} {net} {k}")
            for k, v in single[-1][1][net].items():
                off = np.abs(got["params"][net][k] - v) > 1e-2 * cfg.lr
                assert off.mean() <= 1e-3, (r, net, k, off.mean())
