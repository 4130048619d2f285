"""The DCGAN baseline against moegan_tpu/models/dcgan.py, on the CPU in float32.

Weights are built by the port from a seed and carried across with
`convert.dcgan_to_jax`; z of the training step is JAX's own draw, reproduced
here with `jax.random`. The forwards run eagerly; the JAX step is the one
jitted program of this file. A narrow model (base_features 8) keeps it fast;
`train_with_limited_resources` runs at the default width.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moegan_tpu.models import dcgan as jdcgan
from moegan_tpu_torch.convert import dcgan_from_jax, dcgan_to_jax, unflatten_params
from moegan_tpu_torch.data.datasets import synthetic_dataset
from moegan_tpu_torch.models import dcgan
from tests.torch_helpers import randn, t

F_NARROW = 8


def _pair(seed=0):
    gen = torch.Generator().manual_seed(seed)
    g = dcgan.DCGANGenerator(F_NARROW, 512, gen)
    d = dcgan.DCGANDiscriminator(F_NARROW, 512, gen)
    jv = dcgan_to_jax(g.state_dict(), d.state_dict())
    return g, d, {k: unflatten_params(v) for k, v in jv.items()}


def _close(got, want, frac=1e-4, msg=""):
    """Within `frac` of the largest |value| (float32, other summation orders)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * np.abs(want).max() + 1e-12,
                               err_msg=msg)


def _flat(tree):
    return {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shapes(tree):
    return {"/".join(p.key for p in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_generator_train_and_eval_forwards_match_jax():
    g, _, jv = _pair()
    jg = jdcgan.DCGANGenerator(F_NARROW, 512)
    z, txt = randn(1, 5, dcgan.Z_DIM), randn(2, 5, 512)
    variables = {"params": jv["g_params"], "batch_stats": jv["g_batch_stats"]}
    want, mut = jg.apply(variables, z, txt, training=True, mutable=["batch_stats"])
    got = g(t(z), t(txt), training=True)
    assert got.shape == (5, 64, 64, 3)
    _close(got, want)
    stats = dcgan_to_jax(g.state_dict(), {})["g_batch_stats"]
    want_stats = _flat(mut["batch_stats"])
    assert set(stats) == set(want_stats) and len(stats) == 8
    for k, v in want_stats.items():
        _close(stats[k], v, msg=k)  # running mean and biased variance, momentum 0.99
    # eval: the running statistics just updated, in both
    want_eval = jg.apply({"params": jv["g_params"], "batch_stats": mut["batch_stats"]},
                         z, txt, training=False)
    with torch.no_grad():
        _close(g(t(z), t(txt), training=False), want_eval)


def test_discriminator_matches_jax():
    _, d, jv = _pair(1)
    jd = jdcgan.DCGANDiscriminator(F_NARROW, 512)
    img, txt = np.tanh(randn(3, 4, 64, 64, 3)), randn(4, 4, 512)
    want = jd.apply({"params": jv["d_params"]}, img, txt)
    got = d(t(img), t(txt))
    assert got.shape == (4,) and bool(((got > 0) & (got < 1)).all())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_converter_round_trips():
    g, d, jv = _pair(2)
    gs, ds = dcgan_from_jax(jv["g_params"], jv["g_batch_stats"], jv["d_params"])
    for a, b in ((gs, g.state_dict()), (ds, d.state_dict())):
        assert set(a) == set(b)
        for k, v in b.items():
            assert torch.equal(a[k], v), k
    shapes = jax.eval_shape(lambda: jdcgan.DCGANGenerator(F_NARROW, 512).init(
        jax.random.PRNGKey(0), jnp.zeros((1, dcgan.Z_DIM)), jnp.zeros((1, 512)),
        training=False))
    assert _shapes(shapes["params"]) == _shapes(jv["g_params"])


def test_one_step_matches_jax():
    """One step on the same weights, batch and z: losses, the gradients (Adam's
    first moments), G's running statistics and the new parameters of G and D.
    Adam's first update is lr * g / (|g| + 1e-8): a gradient near 1e-8, which
    float32 rounding can give either sign, moves its weight by up to lr either
    way, so where a gradient is below 1e-4 of its tensor's largest the new
    weight is held to 2 lr."""
    g, d, jv = _pair(3)
    jg, jd = jdcgan.DCGANGenerator(F_NARROW, 512), jdcgan.DCGANDiscriminator(F_NARROW, 512)
    tx = optax.adam(2e-4, b1=0.5)
    jstate = jdcgan.DCGANState(jv["g_params"], jv["g_batch_stats"], jv["d_params"],
                               tx.init(jv["g_params"]), tx.init(jv["d_params"]),
                               jnp.zeros((), jnp.int32))
    batch = {"image": np.tanh(randn(5, 6, 64, 64, 3)), "text": randn(6, 6, 512)}
    rng = jax.random.PRNGKey(9)
    z = np.asarray(jax.random.normal(jax.random.split(rng)[0], (6, dcgan.Z_DIM)))
    jnew, jm = jdcgan.make_dcgan_train_step(jg, jd, tx)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)

    state = dcgan.DCGANState(torch.optim.Adam(g.parameters(), 2e-4, betas=(0.5, 0.999)),
                             torch.optim.Adam(d.parameters(), 2e-4, betas=(0.5, 0.999)))
    state, m = dcgan.make_dcgan_train_step(g, d)(state, batch, z=t(z))
    assert state.step == 1
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    got = dcgan_to_jax(g.state_dict(), d.state_dict())
    moments = dcgan_to_jax(*({n: opt.state[p]["exp_avg"] for n, p in net.named_parameters()}
                             for net, opt in ((g, state.g_opt), (d, state.d_opt))))
    for net, opt in (("g", jnew.g_opt), ("d", jnew.d_opt)):
        want_mu, want_p = _flat(opt[0].mu), _flat(getattr(jnew, f"{net}_params"))
        assert set(moments[f"{net}_params"]) == set(want_mu)
        for k, mu in want_mu.items():
            _close(moments[f"{net}_params"][k], mu, msg=f"{net} moment {k}")
            settled = np.abs(mu) > 1e-4 * np.abs(mu).max()
            p_got, p_want = got[f"{net}_params"][k], want_p[k]
            _close(p_got[settled], p_want[settled], msg=f"{net} param {k}")
            assert np.abs(p_got - p_want).max() <= 2 * 2e-4, k
    want = _flat(jnew.g_batch_stats)
    assert set(got["g_batch_stats"]) == set(want)
    for k, v in want.items():
        _close(got["g_batch_stats"][k], v, msg=k)


def test_training_run_writes_flax_msgpack(tmp_path):
    ds = synthetic_dataset(24, 64, seed=0)
    (g, _), state, history = dcgan.train_with_limited_resources(
        ds, epochs=2, batch_size=8, subset=16, checkpoint_dir=str(tmp_path), device="cpu")
    assert state.step == 4 and len(history["d_loss"]) == len(history["g_loss"]) == 2
    assert all(np.isfinite(v) for v in history["d_loss"] + history["g_loss"])
    # the file flax reads: {"generator": params} in the JAX layout, the last epoch's weights
    restored = flax.serialization.msgpack_restore(
        (tmp_path / "dcgan_epoch_2.msgpack").read_bytes())
    assert set(restored) == {"generator"}
    shapes = jax.eval_shape(lambda: jdcgan.DCGANGenerator().init(
        jax.random.PRNGKey(0), jnp.zeros((1, dcgan.Z_DIM)), jnp.zeros((1, 512)),
        training=False))["params"]
    assert _shapes(restored["generator"]) == _shapes(shapes)
    want = dcgan_to_jax(g.state_dict(), {})["g_params"]
    for k, v in _flat(restored["generator"]).items():
        np.testing.assert_array_equal(v, want[k])
    assert (tmp_path / "dcgan_epoch_1.msgpack").exists()
    imgs = dcgan.generate_image_from_text(g, ds.text_embeddings[0], num_samples=2)
    assert imgs.shape == (2, 64, 64, 3) and float(imgs.abs().max()) <= 1.0


def test_entry_point_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dcgan.create_dcgan_state()
