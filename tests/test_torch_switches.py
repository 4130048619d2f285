"""The generator switches `use_pallas` and `remat_blocks` against the JAX package.

With `use_pallas=False` the port's generator takes no kernel (plain
attention at every T, the dense expert mixture, the plain LayerNorm) and
matches JAX's `use_pallas=False` generator, eval and training, on the same
weights and router noise (one jit for both). `remat_blocks` recomputes each
block in the backward and must not move a gradient. Under an expert mesh
(two gloo ranks) the dense mixture matches JAX's, and a remat step with it
matches the single-process step. float32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import moegan_tpu_torch.core.attention as tattention
import moegan_tpu_torch.core.moe as tmoe
from moegan_tpu.config import GeneratorConfig as JaxGeneratorConfig
from moegan_tpu.core.moe import SparseMoE as JaxSparseMoE
from moegan_tpu.core.router import reparameterize
from moegan_tpu.models.generator import AuroraGenerator as JaxGenerator
from moegan_tpu_torch.config import (
    DiscriminatorConfig,
    GeneratorConfig,
    MeshConfig,
    TrainConfig,
)
from moegan_tpu_torch.convert import torch_to_jax
from moegan_tpu_torch.core.blocks import GenerativeBlock
from moegan_tpu_torch.core.moe import SparseMoE
from moegan_tpu_torch.models.generator import AuroraGenerator
from moegan_tpu_torch.ops import layernorm as tln
from moegan_tpu_torch.train.state import create_train_state
from moegan_tpu_torch.train.step import draw_noise, make_train_step
from tests import torch_dist_helpers as dh
from tests.torch_helpers import (
    TINY_KW,
    decisive_router,
    jax_variables,
    randn,
    router_noise_interceptor,
    t,
)


def test_jax_config_with_both_switches_round_trips():
    jcfg = JaxGeneratorConfig(use_pallas=False, remat_blocks=True, **TINY_KW)
    cfg = GeneratorConfig.from_dict(jcfg.to_dict())
    assert cfg.use_pallas is False and cfg.remat_blocks is True
    assert cfg.channels == jcfg.channels
    assert JaxGeneratorConfig.from_dict(cfg.to_dict()) == jcfg
    default = GeneratorConfig()
    assert default.use_pallas is True and default.remat_blocks is False


def _no_kernels(monkeypatch):
    """Make every kernel wrapper the generator could reach raise."""
    def boom(*args, **kwargs):
        raise AssertionError("use_pallas=False reached a kernel wrapper")

    for mod, names in ((tattention, ("flash_attention",)),
                       (tmoe, ("fused_moe_ffn", "moe_ffn_combine"))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    monkeypatch.setattr(tattention.FlashAttentionFunction, "apply", boom)
    monkeypatch.setattr(tmoe.FusedMoEFunction, "apply", boom)
    monkeypatch.setattr(tmoe.MoECombineFunction, "apply", boom)
    monkeypatch.setattr(tln.FusedLayerNormFunction, "apply", boom)


@pytest.fixture(scope="module")
def dense_pair():
    """The use_pallas=False generator in both packages: an eval call (hard
    routing, a psi vector) and a training forward with the gradients of a
    scalar of its outputs, on the same weights and router noise."""
    cfg = GeneratorConfig(compute_dtype="float32", use_pallas=False, **TINY_KW)
    g = decisive_router(AuroraGenerator(cfg, gen=torch.Generator().manual_seed(7)))
    jg = JaxGenerator(JaxGeneratorConfig(use_pallas=False, compute_dtype="float32", **TINY_KW))
    z, txt = randn(60, 3, 512), randn(61, 3, 512)
    psi = np.asarray([0.5, 0.8, 1.0], np.float32)
    rng = np.random.default_rng(62)
    eps = {r: tuple(rng.standard_normal(mu.shape).astype(np.float32)
                    for mu in getattr(g, f"gen_block_{r}").attn_block.moe.router.mean_weights())
           for r in cfg.resolutions()}
    c_img = randn(63, 3, 16, 16, 3)
    c_route = [randn(64 + i, 3, r * r, 4) for i, r in enumerate(cfg.resolutions())]

    def scalar(out, cast):
        return ((out.image * cast(c_img)).sum() + 0.1 * out.kl
                + sum((p * cast(c)).sum() for p, c in zip(out.routing, c_route)))

    def run(params):
        evaluated = jg.apply({"params": params}, z, txt, truncation_psi=jnp.asarray(psi),
                             training=False)

        def loss(p):
            out = jg.apply({"params": p}, z, txt, training=True, annealing_factor=2.5)
            return scalar(out, jnp.asarray), out

        (value, trained), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return evaluated, trained, value, grads

    intercept, calls = router_noise_interceptor([eps])
    with fnn.intercept_methods(intercept):
        want = jax.jit(run)(jax_variables(g)["params"])
    assert sorted(calls.values()) == [1, 1, 1]

    mp = pytest.MonkeyPatch()
    _no_kernels(mp)
    try:
        with torch.no_grad():
            evaluated = g(t(z), t(txt), t(psi))
        trained = g(t(z), t(txt), training=True, annealing_factor=2.5,
                    router_eps={r: tuple(t(e) for e in v) for r, v in eps.items()})
        value = scalar(trained, t)
        names = [n for n, _ in g.named_parameters()]
        grads = torch.autograd.grad(value, list(g.parameters()), allow_unused=True,
                                    materialize_grads=True)
    finally:
        mp.undo()
    got = dict(evaluated=evaluated, trained=trained, value=value,
               grads=torch_to_jax(dict(zip(names, grads))))
    return got, want


def _within(got, want, frac):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * np.abs(want).max())


def test_dense_generator_eval_matches_jax(dense_pair):
    got, (want, _, _, _) = dense_pair
    # float32 through 3 blocks in other summation orders: 1e-4 of max |image|
    _within(got["evaluated"].image, want.image, 1e-4)
    _within(got["evaluated"].intermediates[8], want.intermediates[8], 1e-4)
    for a, b in zip(got["evaluated"].routing, want.routing):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))  # argmax one-hots


def test_dense_generator_training_matches_jax(dense_pair):
    got, (_, want, value, _) = dense_pair
    _within(got["trained"].image, want.image, 1e-4)
    np.testing.assert_allclose(got["trained"].kl.detach().numpy(), np.asarray(want.kl),
                               rtol=1e-6)
    for a, b in zip(got["trained"].routing, want.routing):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["value"].detach().numpy(), np.asarray(value), rtol=1e-4)


def test_dense_generator_gradients_match_jax(dense_pair):
    got, (_, _, _, grads) = dense_pair
    want = {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert set(got["grads"]) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        # as tests/test_torch_train_modules.py: float32 sums in other orders;
        # the gradients that are zero in exact arithmetic are rounding noise
        np.testing.assert_allclose(got["grads"][k], w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max() + 1e-6 * top, err_msg=k)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernels", "plain"])
def test_remat_gradients_equal_no_remat(use_pallas, monkeypatch):
    cfg = GeneratorConfig(compute_dtype="float32", use_pallas=use_pallas, **TINY_KW)
    calls = []
    block_forward = GenerativeBlock.forward

    def counted(self, *args, **kwargs):
        calls.append(1)
        return block_forward(self, *args, **kwargs)

    monkeypatch.setattr(GenerativeBlock, "forward", counted)
    z, txt = t(randn(70, 2, 512)), t(randn(71, 2, 512))
    c_img = t(randn(72, 2, 16, 16, 3))
    grads, images, block_calls = [], [], []
    for remat in (False, True):
        g = AuroraGenerator(cfg.replace(remat_blocks=remat), gen=torch.Generator().manual_seed(8))
        calls.clear()
        eps = {r: tuple(torch.from_numpy(np.random.default_rng(73 + r).standard_normal(
            tuple(mu.shape)).astype(np.float32)) for mu in getattr(
                g, f"gen_block_{r}").attn_block.moe.router.mean_weights())
            for r in cfg.resolutions()}
        out = g(z, txt, training=True, annealing_factor=2.0, router_eps=eps)
        loss = (out.image * c_img).sum() + 0.1 * out.kl + sum(p.square().sum() for p in out.routing)
        grads.append(torch.autograd.grad(loss, list(g.parameters()), allow_unused=True,
                                         materialize_grads=True))
        images.append(out.image.detach())
        block_calls.append(len(calls))
    assert block_calls == [3, 6]  # remat runs each block's forward again in the backward
    torch.testing.assert_close(images[1], images[0], rtol=0, atol=0)
    top = max(float(a.abs().max()) for a in grads[0])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6 * top)


MOE_ARGS = (16, 20, 4, 8)  # dim, text_dim, experts, router hidden
ANNEAL = 2.5
KL_WEIGHT = 0.01


def test_dense_mixture_under_expert_mesh_matches_jax():
    """Two gloo ranks (data 1 x expert 2), each mixing its two experts, against
    JAX's unsharded `router` + `_mixture`: eval and training outputs and the
    gradients of a scalar of them."""
    m = decisive_router(SparseMoE(*MOE_ARGS, compute_dtype=torch.float32,
                                  gen=torch.Generator().manual_seed(12), use_pallas=False))
    x, w = randn(80, 2, 37, 16), randn(81, 2, 20)
    eps = tuple(randn(82 + i, *p.shape) for i, p in enumerate(m.router.mean_weights()))
    dout, dprobs = randn(86, 2, 37, 16), randn(87, 2, 37, 4)
    jm = JaxSparseMoE(*MOE_ARGS, compute_dtype=jnp.float32, use_pallas=False)

    def intercept(next_fun, args, kwargs, context):
        sampling = args[0] if args else kwargs.get("sampling", False)
        if context.method_name != "sample_weights" or not sampling:
            return next_fun(*args, **kwargs)
        r = context.module
        pairs = ((r.feature_mu, r.feature_rho), (r.text_mu, r.text_rho),
                 (r.combined_mu, r.combined_rho))
        return tuple(reparameterize(mu, rho, jnp.asarray(e)) for (mu, rho), e in zip(pairs, eps))

    params = jax_variables(m)["params"]
    e_out, _, e_probs = jm.apply({"params": params}, x, w, training=False)

    def loss(p, x, w):
        out, kl, probs = jm.apply({"params": p}, x, w, training=True, annealing_factor=ANNEAL)
        return jnp.sum(out * dout) + jnp.sum(probs * dprobs) + KL_WEIGHT * kl, (out, probs)

    with fnn.intercept_methods(intercept):
        (_, (t_out, t_probs)), (dparams, dx, dw) = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(params, x, w)
    ranks = dh.spawn("sharded_moe", 2, module_args=MOE_ARGS,
                     state_dict={k: v.numpy() for k, v in m.state_dict().items()}, x=x, w=w,
                     eps=eps, annealing=ANNEAL, dout=dout, dprobs=dprobs, kl_weight=KL_WEIGHT,
                     use_pallas=False)
    want = {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(dparams)[0]}
    for g in ranks:
        np.testing.assert_array_equal(g["eval_probs"], np.asarray(e_probs))
        _within(g["eval_out"], e_out, 1e-5)
        np.testing.assert_allclose(g["train_probs"], np.asarray(t_probs), rtol=1e-5, atol=1e-7)
        _within(g["train_out"], t_out, 1e-5)
        grads = torch_to_jax({k: torch.from_numpy(v) for k, v in g["grads"].items()})
        assert set(grads) == set(want)
        for k, v in want.items():
            _within(grads[k], v, 1e-4)
        _within(g["dx"], dx, 1e-4)
        _within(g["dw"], dw, 1e-4)


def test_remat_dense_step_under_expert_mesh_matches_single_process():
    """A training step with both switches on two ranks (data 1 x expert 2): the
    backward recomputes each block, its expert_enter / expert_combine
    collectives included, on both ranks in the same order; the gradients
    (Adam's first moments) match the single-process step without remat."""
    B = 4
    sched = {"temperature_factor": 2.5, "effective_kl_weight": 1e-3}
    cfg = TrainConfig(
        generator=GeneratorConfig(compute_dtype="float32", use_pallas=False, **TINY_KW),
        discriminator=DiscriminatorConfig(max_resolution=16, compute_dtype="float32"),
        steps_per_epoch=20, lr=1e-3, batch_size=B, seed=5)
    state = create_train_state(cfg, device="cpu", seed=5)
    batch = {"image": t(np.tanh(randn(90, B, 16, 16, 3))), "text": t(randn(91, B, 512))}
    noise = draw_noise(state.generator, B, torch.Generator().manual_seed(92))
    state, metrics = make_train_step(cfg)(state, batch, sched, noise=noise)
    want = dh.first_moments(state)
    remat = cfg.replace(generator=cfg.generator.replace(remat_blocks=True),
                        mesh=MeshConfig(expert_parallelism=2))
    ranks = dh.spawn("train_steps", 2, cfg_dict=remat.to_dict(), seed=5, batches=[batch],
                     noises=[noise], schedule=sched)
    for r, got in enumerate(ranks):
        for net in ("g", "d"):
            assert set(got["moments"][net]) == set(want[net])
            for k, v in want[net].items():
                np.testing.assert_allclose(got["moments"][net][k], v, rtol=1e-4, atol=1e-6,
                                           err_msg=f"rank {r} {net} {k}")
        for k, v in metrics.items():
            np.testing.assert_allclose(got["metrics"][0][k], v.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {r} {k}")


def test_fused_layernorm_without_pallas_ignores_the_flag(monkeypatch):
    calls = []
    plain = tln.FusedLayerNormFunction.apply

    def spy(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(tln.FusedLayerNormFunction, "apply", spy)
    monkeypatch.setenv("MOEGAN_FUSED_LN", "1")
    x = t(randn(95, 3, 10, 24))
    fused, plain_ln = tln.FusedLayerNorm(24), tln.FusedLayerNorm(24, use_pallas=False)
    a, b = fused(x), plain_ln(x)
    assert calls == [x.shape]  # the flag takes the kernel's function; use_pallas=False does not
    torch.testing.assert_close(b, tln.layer_norm(x, plain_ln.weight, plain_ln.bias, 1e-5),
                               rtol=0, atol=0)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
