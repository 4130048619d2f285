"""The training slice's modules against the JAX package's, on the CPU, float32.

The router's sampling and KL, the discriminator and its R1 term, the
losses, and the generator's training forward and gradients. Weights come
from the port's seeded initialisers and are carried across with
`convert.py`; the router noise reaches the JAX routers through
`flax.linen.intercept_methods` (tests/torch_helpers.py). The generator is
the one JAX program of this file that is jitted; the rest runs eagerly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from moegan_tpu.config import DiscriminatorConfig as JaxDiscriminatorConfig
from moegan_tpu.config import GeneratorConfig as JaxGeneratorConfig
from moegan_tpu.core import router as jrouter
from moegan_tpu.losses import gan as jgan
from moegan_tpu.models.discriminator import AuroraDiscriminator as JaxDiscriminator
from moegan_tpu.models.generator import AuroraGenerator as JaxGenerator
from moegan_tpu_torch.config import DiscriminatorConfig, GeneratorConfig
from moegan_tpu_torch.convert import jax_to_torch, torch_to_jax
from moegan_tpu_torch.core import router as trouter
from moegan_tpu_torch.losses import gan as tgan
from moegan_tpu_torch.models.discriminator import AuroraDiscriminator
from moegan_tpu_torch.models.generator import AuroraGenerator
from tests.torch_helpers import TINY_KW, jax_variables, randn, router_noise_interceptor, t


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol,
                               err_msg=msg)


def test_router_sampling_and_kl_match_jax():
    r = trouter.BayesianRouter(12, 20, 4, 8, gen=torch.Generator().manual_seed(1))
    with torch.no_grad():  # spread mu and rho over the clamps' ranges
        for p, (lo, hi) in ((r.feature_mu, (-12, 12)), (r.feature_rho, (-9, 5)),
                            (r.text_rho, (-6, 2))):
            p.copy_(torch.linspace(lo, hi, p.numel()).reshape(p.shape))
    eps = tuple(randn(10 + i, *p.shape, scale=1.5) for i, p in enumerate(r.mean_weights()))
    got = r.sample_weights(True, eps=[t(e) for e in eps])
    mods = ((r.feature_mu, r.feature_rho), (r.text_mu, r.text_rho),
            (r.combined_mu, r.combined_rho))
    for g, (mu, rho), e in zip(got, mods, eps):
        _close(g, jrouter.reparameterize(mu.detach().numpy(), rho.detach().numpy(), e))
    want_kl = jrouter.BayesianRouter(12, 20, 4, 8).apply(
        jax_variables(r), method=jrouter.BayesianRouter.kl_divergence)
    _close(r.kl_divergence(), want_kl, rtol=1e-5)
    # drawn from a generator, the noise has the weights' shapes
    drawn = r.sample_weights(True, generator=torch.Generator().manual_seed(0))
    assert [d.shape for d in drawn] == [p.shape for p in r.mean_weights()]


@pytest.fixture(scope="module")
def discriminator():
    d = AuroraDiscriminator(DiscriminatorConfig(max_resolution=16, compute_dtype="float32"),
                            gen=torch.Generator().manual_seed(2))
    return d, JaxDiscriminator(JaxDiscriminatorConfig(max_resolution=16, compute_dtype="float32"))


def test_discriminator_params_round_trip(discriminator):
    d, jd = discriminator
    shapes = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                                            jnp.zeros((1, 512))))["params"]
    want = {"/".join(p.key for p in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    flat = torch_to_jax(d.state_dict())
    assert {k: v.shape for k, v in flat.items()} == want
    back = jax_to_torch(flat)
    assert all(torch.equal(back[k], v) for k, v in d.state_dict().items())
    # g starts at ||v||, so the normalised weight is v itself
    conv = d.conv_0
    norm = torch.sqrt(conv.v.square().sum(dim=(1, 2, 3)))
    torch.testing.assert_close(conv.g, norm, rtol=0, atol=0)


def test_discriminator_and_r1_match_jax(discriminator):
    d, jd = discriminator
    variables = jax_variables(d)
    img, txt = np.tanh(randn(20, 3, 16, 16, 3)), randn(21, 3, 512)
    gamma = 10.0

    def r1_of(params):
        grad = jax.grad(lambda x: jnp.sum(jd.apply({"params": params}, x, txt)))(img)
        return gamma / 2 * jnp.mean(jnp.sum(jnp.square(grad), axis=(1, 2, 3)))

    want_logits = jd.apply(variables, img, txt)
    want_r1, want_grads = jax.value_and_grad(r1_of)(variables["params"])

    x = t(img).requires_grad_(True)
    logits = d(x, t(txt))
    (gx,) = torch.autograd.grad(logits.sum(), x, create_graph=True)
    r1 = gamma / 2 * gx.square().sum(dim=(1, 2, 3)).mean()
    names = [n for n, _ in d.named_parameters()]
    # the biases of the last layers do not move the input gradient
    grads = torch.autograd.grad(r1, list(d.parameters()), allow_unused=True,
                                materialize_grads=True)
    _close(logits, want_logits, rtol=1e-5, atol=1e-6)
    _close(r1, want_r1, rtol=1e-4)
    got = torch_to_jax(dict(zip(names, grads)))
    want = {"/".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(want_grads)[0]}
    for k, w in want.items():
        # a double backward through LeakyReLU in float32
        _close(got[k], w, rtol=1e-3, atol=1e-4 * np.abs(np.asarray(w)).max(), msg=k)


def test_losses_and_schedules_match_jax():
    real, fake, mism = randn(30, 8), randn(31, 8), randn(32, 8)
    _close(tgan.generator_loss(t(fake)), jgan.generator_loss(fake))
    _close(tgan.discriminator_loss(t(real), t(fake), t(mism)),
           jgan.discriminator_loss(real, fake, mism))
    logits = randn(33, 2, 40, 4, scale=2.0)
    probs = np.asarray(jax.nn.softmax(logits, -1))
    routing = [randn(34, 2, 10, 4), probs]
    _close(tgan.moe_balance_loss([t(p) for p in routing], 0.01),
           jgan.moe_balance_loss(routing, 0.01))
    _close(tgan.cv_balance(t(probs)), jgan._cv_balance(probs))
    _close(tgan.cv_balance(torch.full((5, 4), 0.25)), jgan._cv_balance(np.full((5, 4), 0.25)))
    _close(tgan.expert_utilization_per_block([t(probs)]),
           jgan.expert_utilization_per_block([probs]))
    _close(tgan.expert_top1_per_block([t(probs)]), jgan.expert_top1_per_block([probs]))
    for epoch in (0, 1, 3.5, 7, 40):
        _close(tgan.kl_annealing_factor(epoch, 5), jgan.kl_annealing_factor(epoch, 5), rtol=1e-6)
        _close(tgan.temperature_factor(epoch), jgan.temperature_factor(epoch), rtol=1e-6)


@pytest.fixture(scope="module")
def generator_pair():
    """The tiny generator's training forward and the gradients of a scalar of
    its outputs, in both packages, on the same weights and router noise."""
    g = AuroraGenerator(GeneratorConfig(compute_dtype="float32", **TINY_KW),
                        gen=torch.Generator().manual_seed(4))
    jg = JaxGenerator(JaxGeneratorConfig(use_pallas=True, compute_dtype="float32", **TINY_KW))
    z, txt = randn(40, 2, 512), randn(41, 2, 512)
    rng = np.random.default_rng(42)
    eps = {r: tuple(rng.standard_normal(mu.shape).astype(np.float32)
                    for mu in getattr(g, f"gen_block_{r}").attn_block.moe.router.mean_weights())
           for r in g.config.resolutions()}
    c_img = randn(43, 2, 16, 16, 3)
    c_route = [randn(44 + i, 2, r * r, 4) for i, r in enumerate(g.config.resolutions())]

    def scalar(image, kl, routing, cast=jnp.asarray):
        return ((image * cast(c_img)).sum() + 0.1 * kl
                + sum((p * cast(c)).sum() for p, c in zip(routing, c_route)))

    def jax_loss(params):
        out = jg.apply({"params": params}, z, txt, training=True, annealing_factor=2.5)
        return scalar(out.image, out.kl, out.routing), out

    intercept, calls = router_noise_interceptor([eps])
    with fnn.intercept_methods(intercept):  # acts while jit traces
        (want_loss, want_out), want_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            jax_variables(g)["params"])
    assert sorted(calls.values()) == [1, 1, 1]

    out = g(t(z), t(txt), training=True, annealing_factor=2.5,
            router_eps={r: tuple(t(e) for e in v) for r, v in eps.items()})
    loss = scalar(out.image, out.kl, out.routing, cast=t)
    names = [n for n, _ in g.named_parameters()]
    grads = torch.autograd.grad(loss, list(g.parameters()), allow_unused=True,
                                materialize_grads=True)
    want = {"/".join(p.key for p in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(want_grads)[0]}
    return dict(out=out, loss=loss, want_out=want_out, want_loss=want_loss,
                got=torch_to_jax(dict(zip(names, grads))), want=want)


def test_generator_training_forward_matches_jax(generator_pair):
    out, want = generator_pair["out"], generator_pair["want_out"]
    # Images reach |x| ~ 30 before clipping; float32 summation order.
    _close(out.image, want.image, rtol=1e-5, atol=2e-4)
    _close(out.kl, want.kl, rtol=1e-6)
    assert len(out.routing) == len(want.routing) == 3
    for a, b in zip(out.routing, want.routing):
        _close(a, b, rtol=1e-5, atol=1e-6)  # soft routing: probabilities, not one-hots
    # ~1.5k image terms of up to ~30 that cancel to a loss of ~7
    _close(generator_pair["loss"], generator_pair["want_loss"], rtol=1e-4)


def test_generator_gradients_match_jax(generator_pair):
    got, want = generator_pair["got"], generator_pair["want"]
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        # float32 sums in other orders; gradients that are zero in exact
        # arithmetic (the self-attention key bias) are rounding noise far
        # below 1e-6 of the largest gradient.
        _close(got[k], w, rtol=1e-3, atol=1e-4 * np.abs(w).max() + 1e-6 * top, msg=k)
