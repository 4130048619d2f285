"""The port's generation and evaluation surface against the JAX package's, on the CPU.

`evaluate_fid_clipscore` on a tiny generator (weights carried with `convert`,
z patched to `jax.random`'s, stub feature extractors), the handler's
`fid_score` and unbatched route, `sample_aurora_gan`, the two CLIs (the
JAX CLIs' full-width channels at 16x16) and the package's root exports.
"""

import base64
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import moegan_tpu
import moegan_tpu.infer.evaluate as jax_evaluate
from moegan_tpu.cli.generate_images import save_grid as jax_save_grid
from moegan_tpu.config import GeneratorConfig as JaxGeneratorConfig
from moegan_tpu.data.datasets import synthetic_dataset as jax_synthetic_dataset
from moegan_tpu.infer.fid import FIDEvaluator as JaxFIDEvaluator
import moegan_tpu_torch
import moegan_tpu_torch.infer.evaluate as evaluate
from moegan_tpu_torch.cli import evaluate as cli_evaluate
from moegan_tpu_torch.cli import generate_images
from moegan_tpu_torch.config import GeneratorConfig
from moegan_tpu_torch.convert import torch_to_jax
from moegan_tpu_torch.data.datasets import synthetic_dataset
from moegan_tpu_torch.infer import serving
from moegan_tpu_torch.infer.fid import FIDEvaluator
from moegan_tpu_torch.infer.png import decode_png
from moegan_tpu_torch.infer.sample import Sampler, sample_aurora_gan
from moegan_tpu_torch.models.generator import AuroraGenerator
from moegan_tpu_torch.models.toy_clip import as_tower_pack, init_toy_params
from moegan_tpu_torch.utils.checkpoint import infer_generator_config, save_generator_params
from tests.torch_helpers import TINY_KW, decisive_router, jax_variables, randn

EMB = randn(500, 512)
# The JAX CLIs build GeneratorConfig(max_resolution=r) with these channels.
CLI_CHANNELS = {4: 512, 8: 256, 16: 128}


def _stub(lo, hi):
    """A feature extractor of pixel columns lo:hi, for numpy images or tensors."""
    def make(*args, **kwargs):
        return lambda imgs: np.asarray(imgs, np.float32).reshape(len(imgs), -1)[:, lo:hi]
    return make


@pytest.fixture(scope="module")
def tiny():
    """(the port's float32 tiny generator, its JAX params and config)."""
    g = decisive_router(AuroraGenerator(GeneratorConfig(compute_dtype="float32", **TINY_KW),
                                        gen=torch.Generator().manual_seed(5)))
    jcfg = JaxGeneratorConfig(use_pallas=True, compute_dtype="float32", **TINY_KW)
    return g, jax_variables(g)["params"], jcfg


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, tiny):
    """The tiny generator as `.npz`, without a generator_config.json."""
    d = tmp_path_factory.mktemp("tiny")
    save_generator_params(str(d / "gen.npz"), tiny[0].state_dict())
    return d


@pytest.fixture(scope="module")
def cli_model(tmp_path_factory):
    """A full-width generator at max_resolution 16, as the CLIs configure it."""
    path = tmp_path_factory.mktemp("cli") / "aurora_model_final.npz"
    cfg = GeneratorConfig(max_resolution=16, channels=CLI_CHANNELS)
    save_generator_params(str(path), AuroraGenerator(
        cfg, gen=torch.Generator().manual_seed(6)).state_dict())
    return path


def test_evaluate_matches_jax(tiny, monkeypatch):
    """fid (32-d stub features), clip_score (512-d stub) and expert_utilization of
    16 samples in batches of 8, z handed in as jax.random's: within 1e-4 relative."""
    g, params, jcfg = tiny

    def jax_z(seed, index, batch_size, latent):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), index)
        return torch.from_numpy(np.array(jax.random.normal(key, (batch_size, latent),
                                                           jnp.float32)))

    for mod in (jax_evaluate, evaluate):
        monkeypatch.setattr(mod, "inception_feature_extractor", _stub(100, 132))
        monkeypatch.setattr(mod, "clip_feature_extractor", _stub(0, 512))
    monkeypatch.setattr(evaluate, "batch_noise", jax_z)
    kw = dict(num_samples=16, batch_size=8, truncation_psi=0.8, seed=3)
    want = jax_evaluate.evaluate_fid_clipscore(
        params, jax_synthetic_dataset(16, 16, seed=0), {}, cfg=jcfg, **kw)
    ds = synthetic_dataset(16, 16, seed=0)
    np.testing.assert_array_equal(ds.images, jax_synthetic_dataset(16, 16, seed=0).images)
    got = evaluate.evaluate_fid_clipscore(g.state_dict(), ds, None, cfg=g.config, device="cpu",
                                          **kw)
    assert set(got) == set(want) and got["num_samples"] == want["num_samples"] == 16
    assert got["fid_feature_source"] == "inception" and np.isfinite(got["fid"])
    for key in ("fid", "clip_score"):
        assert abs(got[key] - want[key]) <= 1e-4 * abs(want[key]), (key, got[key], want[key])
    np.testing.assert_allclose(got["expert_utilization"], want["expert_utilization"],
                               rtol=1e-4, atol=1e-6)
    assert abs(sum(got["expert_utilization"]) - 1.0) < 1e-5


def test_evaluate_sample_count_and_refusals(tiny, monkeypatch):
    """n rounds down to whole batches; a dataset smaller than a batch, an unknown
    feature source and the default device without a card are refused; the
    CLIP source (no text-width features here) gives no CLIPScore."""
    g = tiny[0]
    monkeypatch.setattr(evaluate, "clip_feature_extractor", _stub(0, 24))
    ds = synthetic_dataset(13, 16, seed=1)
    res = evaluate.evaluate_fid_clipscore(g.state_dict(), ds, None, cfg=g.config,
                                          num_samples=100, batch_size=4, feature_source="clip",
                                          device="cpu")
    assert res["num_samples"] == 12 and res["clip_score"] is None
    assert res["fid_feature_source"] == "clip" and np.isfinite(res["fid"])
    with pytest.raises(ValueError, match="smaller than batch"):
        evaluate.evaluate_fid_clipscore(g.state_dict(), ds, None, cfg=g.config, batch_size=16,
                                        device="cpu")
    with pytest.raises(ValueError, match="feature_source"):
        evaluate.evaluate_fid_clipscore(g.state_dict(), ds, None, cfg=g.config, batch_size=4,
                                        feature_source="pixels", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate.evaluate_fid_clipscore(g.state_dict(), ds, None, cfg=g.config, batch_size=4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FIDEvaluator()


def test_handler_fid_score_matches_jax(model_dir, tiny, tmp_path, monkeypatch):
    """`calculate_fid` on the unbatched handler: fid_score of the served images
    against a stats file, as the JAX package's FIDEvaluator gives it."""
    cfg = tiny[0].config
    monkeypatch.chdir(tmp_path)  # no reference_stats.npz here: the 2048-d fallback
    handler = serving.InferenceHandler.from_model_dir(
        str(model_dir), cfg=cfg, clip_params=as_tower_pack(init_toy_params()), batching=False,
        device="cpu")
    assert handler.batcher is None and handler.sampler.cfg == cfg
    assert isinstance(handler.fid, FIDEvaluator) and handler.fid.ref_mu.shape == (2048,)
    stub = _stub(200, 240)()
    ref = FIDEvaluator(stub)
    ref.set_reference_images(np.tanh(randn(9, 6, 16, 16, 3)))
    ref.save_reference_stats(str(tmp_path / "stats.npz"))
    handler.fid = FIDEvaluator(stub, reference_stats_path=str(tmp_path / "stats.npz"))
    resp = handler.transform_fn({"text": EMB.tolist(), "num_samples": 3, "seed": 2,
                                 "truncation_psi": 0.9, "calculate_fid": True})
    images = handler.sampler(EMB, 4, 0.9, seed=2)[:3].numpy()
    want = JaxFIDEvaluator(stub, reference_stats_path=str(tmp_path / "stats.npz"))(images)
    assert np.isfinite(resp["fid_score"])
    assert abs(resp["fid_score"] - want) <= 1e-6 * abs(want)
    assert "fid_score" not in handler.transform_fn({"text": EMB.tolist(), "seed": 2})
    handler.close()


def test_unbatched_handler_matches_sampler(model_dir, tiny):
    """batching=False runs the sampler at MAX_NUM_SAMPLES and slices; the
    architecture comes from the param shapes when neither cfg nor a config file
    is given."""
    handler = serving.InferenceHandler.from_model_dir(
        str(model_dir), clip_params=as_tower_pack(init_toy_params()), batching=False,
        device="cpu")
    assert handler.sampler.cfg == GeneratorConfig(**TINY_KW)  # bf16: the default dtype
    resp = handler.transform_fn({"text": EMB.tolist(), "num_samples": 2, "seed": 11,
                                 "truncation_psi": 0.6})
    got = np.stack([decode_png(base64.b64decode(s)) for s in resp["images"]])
    want = Sampler(GeneratorConfig(**TINY_KW), tiny[0].state_dict(), device="cpu")(
        EMB, 4, 0.6, seed=11)[:2]
    want = np.clip((want.float().numpy() + 1.0) * 127.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    assert set(resp["expert_utilization"]) == {"block_0", "block_1", "block_2"}
    handler.close()


def test_sample_aurora_gan_infers_the_config(tiny):
    flat = torch_to_jax(tiny[0].state_dict())
    got = sample_aurora_gan(flat, EMB, 2, 0.7, seed=4, device="cpu")
    want = Sampler(infer_generator_config(flat), tiny[0].state_dict(), device="cpu")(
        EMB, 2, 0.7, seed=4)
    assert got.shape == (2, 16, 16, 3) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got32 = sample_aurora_gan(flat, EMB, 2, 0.7, cfg=tiny[0].config, seed=4, device="cpu")
    assert got32.dtype == torch.float32 and not torch.equal(got32, got)


def test_save_grid_matches_jax_pixels(tmp_path):
    """Three images tile a 2x2 grid with one empty cell, pixel for pixel as the
    JAX CLI's PIL file."""
    images = np.tanh(randn(12, 3, 8, 8, 3) * 2)
    generate_images.save_grid(images, str(tmp_path / "port.png"))
    jax_save_grid(images, str(tmp_path / "jax.png"))
    with open(tmp_path / "port.png", "rb") as f:
        got = decode_png(f.read())
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    assert got.shape == (16, 16, 3)
    np.testing.assert_array_equal(got, want)
    assert not got[8:, 8:].any()


def test_generate_images_cli_on_cpu(cli_model, tmp_path, capsys):
    out = generate_images.main([
        "--model_path", str(cli_model), "--prompt", "a  red bird ", "--max_resolution", "16",
        "--output_dir", str(tmp_path), "--show_experts", "--device", "cpu"])
    assert out == str(tmp_path / "a_red_bird.png")
    with open(out, "rb") as f:
        grid = decode_png(f.read())
    assert grid.shape == (32, 32, 3)
    text = capsys.readouterr().out
    stats = json.loads(text[text.index("{"):])
    assert set(stats) == {"block_0", "block_1", "block_2"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate_images.main(["--model_path", str(cli_model), "--prompt", "x",
                                  "--max_resolution", "16", "--output_dir", str(tmp_path)])


def test_evaluate_cli_on_cpu(cli_model, tmp_path, capsys):
    """InceptionV3 FID (one 2048-d Fréchet distance) and CLIPScore of 8 samples
    with the random-init towers, and the reference statistics file, which the
    JAX package's FIDEvaluator reads."""
    stats = tmp_path / "reference_stats.npz"
    res = cli_evaluate.main([
        "--model_path", str(cli_model), "--synthetic", "--max_resolution", "16",
        "--batch_size", "8", "--num_samples", "8", "--save_reference_stats", str(stats),
        "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[METRIC] fid: ") and lines[1].startswith("[METRIC] clip_score: ")
    assert json.loads(lines[-1]) == json.loads(json.dumps(res))
    assert res["fid_feature_source"] == "inception" and res["num_samples"] == 8
    assert np.isfinite(res["fid"]) and np.isfinite(res["clip_score"])
    assert abs(sum(res["expert_utilization"]) - 1.0) < 1e-5
    theirs = JaxFIDEvaluator(lambda x: x, reference_stats_path=str(stats))
    assert theirs.ref_mu.shape == (2048,) and theirs.ref_sigma.shape == (2048, 2048)
    assert np.isfinite(theirs.ref_sigma).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_evaluate.main(["--model_path", str(cli_model), "--synthetic"])


def test_root_exports_match_jax():
    assert set(moegan_tpu.__all__) | {"resolve_device"} == set(moegan_tpu_torch.__all__)
    assert moegan_tpu_torch.__version__ == moegan_tpu.__version__
    from moegan_tpu_torch import config
    from moegan_tpu_torch.models import discriminator, generator

    assert moegan_tpu_torch.AuroraGenerator is generator.AuroraGenerator
    assert moegan_tpu_torch.AuroraDiscriminator is discriminator.AuroraDiscriminator
    for name in ("GeneratorConfig", "DiscriminatorConfig", "LossConfig", "TrainConfig",
                 "MeshConfig"):
        assert getattr(moegan_tpu_torch, name) is getattr(config, name)
    assert moegan_tpu_torch.resolve_device("cpu") == torch.device("cpu")
