"""The prototype Bayesian router against moegan_tpu/prototype/, on the CPU in float32.

The JAX layers draw their weight noise with `jax.random.normal`; the tests
hand both packages the same draws by giving the JAX module a `jax` whose
`random.normal` returns the test's arrays in call order (`_jax_draws`), so
no JAX file changes. Weights are built by the port from a seed and carried
across with `convert.torch_to_jax`. Everything runs eagerly (no jit).
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moegan_tpu.prototype import bayesian as jbayesian
from moegan_tpu.prototype import convert as jconvert
from moegan_tpu.prototype import gating as jgating
from moegan_tpu.prototype import training as jtraining
from moegan_tpu_torch.convert import jax_to_torch, torch_to_jax
from moegan_tpu_torch.data.datasets import EnhancedMSCOCODataset, synthetic_dataset
from moegan_tpu_torch.prototype import bayesian, gating, moe_wrapper, testing, training
from moegan_tpu_torch.prototype.convert import convert_gating_state_dict, load_reference_router
from tests.torch_helpers import randn, t, unflatten

KEY = jax.random.PRNGKey(0)


def _jax_draws(monkeypatch, eps):
    """Make moegan_tpu.prototype.bayesian's jax.random.normal return the arrays of
    `eps` ([(eps_w, eps_b)] per layer, as `draw_noise` gives them) in order."""
    flat = iter([np.asarray(e) for pair in eps for e in pair])

    def normal(key, shape):
        a = next(flat)
        assert a.shape == tuple(shape)
        return jnp.asarray(a)

    shim = types.SimpleNamespace(random=types.SimpleNamespace(split=jax.random.split,
                                                               normal=normal))
    monkeypatch.setattr(jbayesian, "jax", shim)


def _variables(module):
    return {"params": unflatten(torch_to_jax(module.state_dict()))}


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rtol=1e-5, atol=0.0, msg=""):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def test_bayesian_linear_matches_jax(monkeypatch):
    layer = bayesian.BayesianLinear(12, 7, torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.w_rho.copy_(torch.linspace(-5, 1, 84).reshape(12, 7))  # spread the sigmas
    x = randn(1, 3, 12)
    eps = layer.draw_noise(torch.Generator().manual_seed(1))
    _jax_draws(monkeypatch, [eps])
    want_y, want_kl = jbayesian.BayesianLinear(7).apply(_variables(layer), x, True,
                                                        rngs={"router": KEY})
    y, kl = layer(t(x), True, eps)
    _close(y, want_y, rtol=1e-5, atol=1e-6)
    _close(kl, want_kl, rtol=1e-5)
    ye, kle = layer(t(x), False)
    want_ye, want_kle = jbayesian.BayesianLinear(7).apply(_variables(layer), x, False)
    _close(ye, want_ye, rtol=1e-6, atol=1e-7)
    assert float(kle) == float(want_kle) == 0.0
    w = randn(2, 40, scale=0.3)
    _close(bayesian.scale_mixture_log_prob(t(w)), jbayesian.scale_mixture_log_prob(w), rtol=1e-6)


@pytest.mark.parametrize("use_text", [False, True], ids=["plain", "text"])
def test_gating_network_matches_jax(monkeypatch, use_text):
    net = gating.BayesianMoEGatingNetwork(16, 8, 5, use_text=use_text, text_dim=10,
                                          gen=torch.Generator().manual_seed(2))
    x, txt = randn(3, 4, 16), randn(4, 4, 10)
    eps = net.draw_noise(torch.Generator().manual_seed(5))
    _jax_draws(monkeypatch, eps)
    jnet = jgating.BayesianMoEGatingNetwork(8, 5, use_text=use_text)
    want = jnet.apply(_variables(net), x, txt, sample=True, rngs={"router": KEY})
    got = net(t(x), t(txt), sample=True, eps=eps)
    for g, w, name in zip(got, want, ("probs", "kl", "logits")):
        _close(g, w, rtol=1e-5, atol=1e-6, msg=name)
    want_mean = jnet.apply(_variables(net), x, txt, sample=False)
    for g, w in zip(net(t(x), t(txt), sample=False), want_mean):
        _close(g, w, rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def small_net():
    return gating.BayesianMoEGatingNetwork(16, 8, 4, gen=torch.Generator().manual_seed(3))


def test_hmc_potential_and_gradient_match_jax(monkeypatch, small_net):
    x = randn(6, 1, 16)
    temperature = 1.3
    with torch.no_grad():
        ref = torch.softmax(small_net(t(x), sample=False)[2] / temperature, -1)
    eps = small_net.draw_noise(torch.Generator().manual_seed(7))
    _jax_draws(monkeypatch, eps)
    jnet = jgating.BayesianMoEGatingNetwork(8, 4)
    variables = _variables(small_net)
    jref = jnp.asarray(ref.numpy())

    def potential(x_in):  # the JAX chain's potential (gating.py:84-88)
        _, _, logits = jnet.apply(variables, x_in, sample=True, rngs={"router": KEY})
        logp = jax.nn.log_softmax(logits / temperature, axis=-1)
        return jnp.sum(jref * (jnp.log(jref + 1e-30) - logp))

    want_u, want_g = jax.value_and_grad(potential)(jnp.asarray(x))
    xg = t(x).requires_grad_(True)
    u = gating.hmc_potential(small_net, xg, ref, eps, temperature)
    (g,) = torch.autograd.grad(u, xg)
    _close(u, want_u, rtol=1e-5, atol=1e-7)
    _close(g, want_g, rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(want_g)).max()))


def test_chain_invariants(small_net, monkeypatch):
    x = t(randn(8, 1, 16))
    with torch.no_grad():
        ref = torch.softmax(small_net(x, sample=False)[2] / 1.3, -1)
    # a step of size 0 proposes x itself: dH = 0, accepted, x kept
    x_next, probs, accept, dh = gating.hmc_step(small_net, x, ref,
                                                torch.Generator().manual_seed(0), step_size=0.0)
    assert bool(accept) and float(dh) == 0.0 and torch.equal(x_next, x)
    assert probs.shape == (1, 4)
    # dH <= 0 always accepts; dH > 0 accepts when u < exp(-min(dH, 50))
    u = torch.tensor(0.999999)
    for d in (-3.0, -1e-6, 0.0):
        assert bool(gating.metropolis_accept(torch.tensor(d), u))
    assert not bool(gating.metropolis_accept(torch.tensor(1.0), torch.tensor(0.5)))
    assert bool(gating.metropolis_accept(torch.tensor(1.0), torch.tensor(0.3)))
    # dH is clamped at 50: exp(-50) = 1.9e-22, where exp(-1e4) would be 0
    assert bool(gating.metropolis_accept(torch.tensor(1e4), torch.tensor(1e-23)))
    assert not bool(gating.metropolis_accept(torch.tensor(1e4), torch.tensor(1e-21)))
    mean, unc, rate = gating.hamiltonian_monte_carlo(
        small_net, x, torch.Generator().manual_seed(1), num_samples=6, burn_in=3, num_steps=3)
    assert mean.shape == unc.shape == (1, 4) and 0.0 <= float(rate) <= 1.0
    np.testing.assert_allclose(float(mean.sum()), 1.0, rtol=1e-5)
    assert bool((unc >= 0).all())
    # predict_expert's threshold reads row 0 only (gating.py:136-141)
    rows = torch.tensor([[0.1, 0.8, 0.05, 0.05], [0.9, 0.05, 0.03, 0.02]])
    monkeypatch.setattr(gating, "hamiltonian_monte_carlo", lambda *a, **k: (rows, rows, 1.0))
    assert gating.predict_expert(small_net, x, None)[0] == [1]
    rows[0] = torch.tensor([0.3, 0.2, 0.4, 0.1])
    assert gating.predict_expert(small_net, x, None)[0] == [2]


def test_kmeans_equals_jax_numpy_route(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)  # JAX then takes its numpy route
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 12)) * 3
    emb = (centers[rng.integers(0, 4, 120)] + rng.normal(size=(120, 12))).astype(np.float32)
    got_labels, got_centers = training.cluster_text_embeddings(emb, n_clusters=4, seed=1)
    want_labels, want_centers = jtraining.cluster_text_embeddings(emb, n_clusters=4, seed=1)
    np.testing.assert_array_equal(got_labels, want_labels)
    np.testing.assert_array_equal(got_centers, want_centers)


def test_cluster_loss_and_gradient_match_jax(monkeypatch, small_net):
    x, y = randn(9, 10, 16), np.random.default_rng(10).integers(0, 4, 10)
    eps = small_net.draw_noise(torch.Generator().manual_seed(11))
    _jax_draws(monkeypatch, eps)
    jnet = jgating.BayesianMoEGatingNetwork(8, 4)

    def loss_fn(params):  # the JAX trainer's loss (training.py:175-180)
        probs, kl, logits = jnet.apply(params, x, sample=True, rngs={"router": KEY})
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return ce + 1e-5 * kl + 0.001 * jtraining.balance_loss_uniform(probs)

    want, grads = jax.value_and_grad(loss_fn)(_variables(small_net))
    loss, _ = training.cluster_loss(small_net, t(x), torch.from_numpy(y), eps)
    names = [n for n, _ in small_net.named_parameters()]
    got = torch_to_jax(dict(zip(names, torch.autograd.grad(loss, list(small_net.parameters())))))
    _close(loss, want, rtol=1e-5)
    want = {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(grads["params"])[0]}
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k], v, rtol=0, atol=1e-5 * np.abs(v).max() + 1e-12, msg=k)


def test_reference_router_conversion(tmp_path):
    gen = torch.Generator().manual_seed(12)
    sd = {}
    widths = {"layer1": (24, 16), "layer2": (16, 16), "layer2a": (16, 16), "layer2b": (16, 16),
              "layer2c": (16, 16), "layer3": (16, 9)}
    for name, (i, o) in widths.items():
        for kind, shape in (("weight", (o, i)), ("bias", (o,))):
            sd[f"gating_network.bayesian_{name}.{kind}_mu"] = torch.randn(shape, generator=gen)
            sd[f"gating_network.bayesian_{name}.{kind}_rho"] = torch.randn(shape, generator=gen)
    sd["gating_network.text_projection.weight"] = torch.randn((16, 24), generator=gen)
    sd["gating_network.text_projection.bias"] = torch.randn((16,), generator=gen)
    got = convert_gating_state_dict(sd)
    net = gating.BayesianMoEGatingNetwork(24, 16, 9, use_text=True, text_dim=24)
    net.load_state_dict(got)  # every name and shape of the port's network
    want = jconvert.convert_gating_state_dict(sd)["params"]
    flat = torch_to_jax(got)
    assert set(flat) == {"/".join(p.key for p in path) for path, _ in
                         jax.tree_util.tree_flatten_with_path(want)[0]}
    for path, v in jax.tree_util.tree_flatten_with_path(want)[0]:
        np.testing.assert_array_equal(flat["/".join(p.key for p in path)], v)
    back = jax_to_torch(want)  # and from the JAX layout into the port's names
    assert set(back) == set(got) and all(torch.equal(back[k], v) for k, v in got.items())
    missing = tmp_path / "bayesian_moe_model.pth"
    with pytest.raises(FileNotFoundError, match=str(missing)):
        load_reference_router(str(missing))
    torch.save(sd, missing)
    (tmp_path / "cluster_descriptions.txt").write_text("landscapes\n\nportraits\n")
    loaded, meta = load_reference_router(str(missing))
    assert meta == {"input_dim": 24, "hidden_dim": 16, "num_experts": 9, "use_text": True,
                    "clusters": ["landscapes", "portraits"]}
    assert all(torch.equal(loaded[k], v) for k, v in got.items())


def test_cluster_training_and_dataset(monkeypatch):
    monkeypatch.setattr(torch.optim, "AdamW", _recording_adamw(torch.optim.AdamW))
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 32)) * 5
    labels = rng.integers(0, 4, 400)
    emb = (centers[labels] + rng.normal(size=(400, 32)) * 0.3).astype(np.float32)
    found, _ = training.cluster_text_embeddings(emb, n_clusters=4, seed=1)
    net, hist = training.train_moe_with_clusters(emb, found, hidden_dim=32, epochs=6,
                                                 batch_size=64, seed=0, device="cpu")
    assert _recording_adamw.weight_decay == [1e-4]  # optax.adamw's default
    # well above chance (0.25) after 6 epochs; the JAX trainer on these data
    # ends at 0.51-0.53 over seeds 0-2, the port at 0.57-0.70
    assert hist["val_accuracy"][-1] > 0.4 and hist["train_loss"][-1] < hist["train_loss"][0]
    base = synthetic_dataset(40, 16, seed=3, text_dim=32)
    ds = EnhancedMSCOCODataset.from_dataset(base, n_clusters=3, seed=1)
    img, e, lab = ds[0]
    assert img.shape == (16, 16, 3) and e.shape == (32,) and 0 <= int(lab) < 3
    assert len(ds) == 40 and len(ds.cluster_descriptions) == ds.num_clusters <= 3
    _, hist = training.train_moe_with_clusters(ds, epochs=2, hidden_dim=16, batch_size=16,
                                               device="cpu")
    assert len(hist["val_accuracy"]) == 2
    with pytest.raises(ValueError):
        EnhancedMSCOCODataset(base, np.zeros(3, np.int32))


def _recording_adamw(cls):
    def make(params, lr, weight_decay):
        _recording_adamw.weight_decay.append(weight_decay)
        return cls(params, lr, weight_decay=weight_decay)

    _recording_adamw.weight_decay = []
    return make


def test_mixture_of_experts_and_harness(monkeypatch, capsys):
    moe = moe_wrapper.MixtureOfExperts(32, 16, 4, seed=0, num_samples=3, burn_in=2, device="cpu")
    emb = randn(13, 1, 32)
    probs, selected, mean, unc = moe(emb)
    assert probs.shape == mean.shape == unc.shape == (1, 4) and selected
    text = moe.describe_selection(emb)
    assert text.startswith("Expert selection:") and "Selected experts:" in text
    assert moe_wrapper.EXPERT_DESCRIPTIONS[selected[0]] in text

    class Towers:  # a CLIP pack's encode_text, without the ViT-B/32 towers
        def encode_text(self, texts):
            seed = sum(map(ord, texts))
            return torch.randn((1, 512), generator=torch.Generator().manual_seed(seed))

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    small = moe_wrapper.MixtureOfExperts(512, 16, 4, num_samples=2, burn_in=1, device="cpu")
    results = testing.run_harness(small, testing.CANNED_PROMPTS[:2], clip_params=Towers())
    assert [r["prompt"] for r in results] == testing.CANNED_PROMPTS[:2]
    assert "skipping chart" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="device='cpu'"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        moe_wrapper.MixtureOfExperts(32, 16, 4)
