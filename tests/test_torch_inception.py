"""The port's InceptionV3 and FID statistics against the JAX package's, on the CPU.

The network runs in float32 on both sides (one jit of `inception_jax.features`,
batch 2, compiled per variant and input size); the Gaussian fit and the
Fréchet distance on 64-d features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moegan_tpu.infer import fid as jax_fid
from moegan_tpu.models import inception_jax as ij
from moegan_tpu_torch.infer import fid
from moegan_tpu_torch.models import inception as ti
from tests.torch_helpers import randn

_jax_features = jax.jit(
    lambda p, x, variant: ij.features(p, x, variant=variant, compute_dtype=jnp.float32),
    static_argnums=2)


@pytest.fixture(scope="module")
def params():
    """(the JAX package's nested init, the port's flat init), both from seed 0."""
    return ij.init_inception_params(0), ti.init_inception_params(0)


@pytest.fixture(scope="module")
def model(params):
    return ti.inception_model(params[1], device="cpu", compute_dtype="float32")


def test_init_and_specs_match_jax(params):
    """The table is the JAX package's, and the random init draws its numbers bit for bit."""
    assert ti.CONV_SPECS == ij.CONV_SPECS and len(ti.CONV_SPECS) == 94
    theirs, ours = params
    assert set(ours) == {f"{s[0]}/{k}" for s in ij.CONV_SPECS for k in "wb"}
    for name, *_ in ij.CONV_SPECS:
        np.testing.assert_array_equal(ours[f"{name}/w"], np.asarray(theirs[name]["w"]))
        np.testing.assert_array_equal(ours[f"{name}/b"], np.asarray(theirs[name]["b"]))


def test_fold_batchnorm_matches_jax():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(8, 4, 3, 3)).astype(np.float32)
    gamma, var = rng.uniform(0.5, 1.5, 8), rng.uniform(0.1, 2.0, 8)
    beta, mean = rng.normal(size=8), rng.normal(size=8)
    for got, want in zip(ti.fold_batchnorm(w, gamma, beta, mean, var),
                         ij.fold_batchnorm(w, gamma, beta, mean, var)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_npz_crosses_between_packages(tmp_path, params, monkeypatch):
    """A file of the JAX package's `save_inception_params` loads in the port (by
    path and by INCEPTION_WEIGHTS_PATH) and the port's loads in the JAX package;
    a file missing a layer is refused."""
    theirs, ours = params
    rng = np.random.default_rng(4)
    scaled = {name: {"w": p["w"] * 0.5, "b": jnp.asarray(rng.normal(size=p["b"].shape),
                                                         jnp.float32)}
              for name, p in theirs.items()}
    ij.save_inception_params(scaled, str(tmp_path / "jax.npz"))
    monkeypatch.setenv(ti.INCEPTION_WEIGHTS_ENV, str(tmp_path / "jax.npz"))
    for loaded in (ti.load_inception_params(str(tmp_path / "jax.npz")), ti.load_inception_params()):
        for name, p in scaled.items():
            np.testing.assert_array_equal(loaded[f"{name}/w"], np.asarray(p["w"]))
            np.testing.assert_array_equal(loaded[f"{name}/b"], np.asarray(p["b"]))
    sd = ti.inception_state_dict(loaded)
    w = np.asarray(scaled["Mixed_7c.branch_pool"]["w"])
    np.testing.assert_array_equal(sd["Mixed_7c.branch_pool.weight"].numpy(),
                                  w.transpose(3, 2, 0, 1))
    ti.save_inception_params(ours, str(tmp_path / "port.npz"))
    back = ij.load_inception_params(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(back["Conv2d_1a_3x3"]["w"]), ours["Conv2d_1a_3x3/w"])
    monkeypatch.delenv(ti.INCEPTION_WEIGHTS_ENV)
    np.savez(tmp_path / "short.npz", **{k: v for k, v in ours.items() if "Mixed_7c" not in k})
    with pytest.raises(ValueError, match="missing layers"):
        ti.load_inception_params(str(tmp_path / "short.npz"))


@pytest.mark.parametrize("variant", ["torchvision", "pytorch_fid"])
@pytest.mark.parametrize("res", [32, 320])
def test_features_match_jax(params, model, variant, res):
    """float32 features of two [-1, 1] images: upsampled from 32 px, and
    downsampled (antialiased) from 320 px. Measured: <= 5e-7 of max |feature|."""
    x = np.tanh(randn(res, 2, res, res, 3))
    want = np.asarray(_jax_features(params[0], jnp.asarray(x), variant))
    with torch.inference_mode():
        got = model.features(torch.from_numpy(x), variant).numpy()
    assert got.shape == (2, ti.FEATURE_DIM) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_pools_match_jax():
    x = randn(5, 2, 9, 7, 6)  # NHWC for JAX, NCHW for the port
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for include in (True, False):
        want = np.asarray(ij._avg_pool_3x3_s1_p1(jnp.asarray(x), count_include_pad=include))
        got = ti.avg_pool_3x3_s1_p1(xt, include).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for window, stride, pad in ((3, 2, 0), (3, 1, 1)):
        want = np.asarray(ij._max_pool(jnp.asarray(x), window, stride, pad))
        got = ti.max_pool(xt, window, stride, pad).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)
    img = np.random.default_rng(6).uniform(size=(1, 4, 4, 3)).astype(np.float32)
    got = ti.transform_input(torch.from_numpy(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ij._transform_input(jnp.asarray(img))),
                               rtol=1e-6, atol=1e-6)


def test_gaussian_stats_and_frechet_match_jax():
    """64-d features, from N = 64 samples and from N = 4 (a singular covariance,
    scipy's sqrtm then the eigendecomposition path), to 1e-6 relative."""
    rng = np.random.default_rng(7)
    for n in (64, 4):
        a = rng.normal(size=(n, 64))
        b = rng.normal(0.3, 1.2, size=(n, 64))
        sa, sb = fid.gaussian_stats(a), fid.gaussian_stats(b)
        for got, want in zip(sa + sb, jax_fid.gaussian_stats(a) + jax_fid.gaussian_stats(b)):
            np.testing.assert_array_equal(got, want)
        got = fid.frechet_distance(*sa, *sb)
        want = jax_fid.frechet_distance(*sa, *sb)
        assert np.isfinite(got) and abs(got - want) <= 1e-6 * abs(want)
    # closed form: equal covariances, FID = |mu1 - mu2|^2
    mu = rng.normal(size=8)
    assert abs(fid.frechet_distance(mu, np.eye(8), mu + 1.0, np.eye(8)) - 8.0) < 1e-9


def test_fid_evaluator_fallback_batches_and_stats_files(tmp_path, monkeypatch):
    """The μ=0, Σ=I fallback; the batched extractor against the JAX package's
    padded one over a ragged last chunk; a stats file written by either package
    read by the other, and the same FID from both."""

    def per_image(x):  # any function of each image alone
        return x.reshape(x.shape[0], -1)[:, :16] * 2.0 + x.mean((1, 2, 3))[:, None]

    images = np.tanh(randn(8, 5, 6, 6, 3))
    got = fid.batched_extractor(per_image, 2, "cpu")(images)
    want = jax_fid._batched_extractor(jax.jit(per_image), 2)(images)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    got_t = fid.batched_extractor(per_image, 2, "cpu")(torch.from_numpy(images))
    np.testing.assert_array_equal(got_t, got)

    stub = fid.batched_extractor(per_image, 2, "cpu")
    monkeypatch.chdir(tmp_path)  # reference_stats.npz is read from the working directory
    ev = fid.FIDEvaluator(stub, reference_stats_path="reference_stats.npz")  # no such file
    assert ev.ref_mu.shape == (2048,) and not ev.ref_mu.any()
    np.testing.assert_array_equal(ev.ref_sigma, np.eye(2048))
    ours = fid.FIDEvaluator(stub, feature_dim=16)
    ours.set_reference_images(images[:4])
    ours.save_reference_stats(str(tmp_path / "reference_stats.npz"))
    theirs = jax_fid.FIDEvaluator(stub, reference_stats_path="reference_stats.npz", feature_dim=16)
    np.testing.assert_array_equal(theirs.ref_sigma, ours.ref_sigma)
    theirs.set_reference_images(images[1:])
    theirs.save_reference_stats(str(tmp_path / "jax_stats.npz"))
    back = fid.FIDEvaluator(stub, reference_stats_path=str(tmp_path / "jax_stats.npz"))
    np.testing.assert_array_equal(back.ref_mu, theirs.ref_mu)
    assert abs(back(images[:3]) - theirs(images[:3])) <= 1e-6 * abs(theirs(images[:3]))
    assert fid.FIDEvaluator(stub)(images) == ours(images)  # reads ./reference_stats.npz
