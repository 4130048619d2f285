"""The port's training CLI (`cli/train_model.py`) and COCO loader
(`data/datasets.py::ProcessedMSCOCODataset`) against the JAX package's.

`main` runs on the CPU at the tiny configuration for one epoch. What it
writes is held to what the JAX CLI writes, without running the JAX training:
`aurora_model_final.msgpack` read by the JAX package's loader has the JAX
generator's parameter tree (names, shapes, dtypes) for the JAX CLI's config,
`generator_config.json` is the JAX CLI's generator config, and
`metrics.jsonl` holds the JAX logger's records. The CLIP loss is driven
there with a toy tower pack in place of the ViT-B/32 towers, whose CPU cost
would dominate the file (tests/test_torch_clip.py holds those towers).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moegan_tpu.cli import train_model as jax_cli
from moegan_tpu.data.datasets import ProcessedMSCOCODataset as JaxDataset
from moegan_tpu.models.generator import AuroraGenerator as JaxGenerator
from moegan_tpu.utils.checkpoint import load_generator_params as jax_load_params
from moegan_tpu_torch.cli import train_model
from moegan_tpu_torch.data.datasets import ProcessedMSCOCODataset
from moegan_tpu_torch.models import clip
from moegan_tpu_torch.models.toy_clip import as_tower_pack, init_toy_params


def _common(ours: dict, theirs: dict, path=""):
    """Every field of the port's config dict equals the JAX config's."""
    for k, v in ours.items():
        assert k in theirs, f"{path}{k}"
        if isinstance(v, dict) and isinstance(theirs[k], dict):
            _common(v, theirs[k], f"{path}{k}.")
        else:
            assert v == theirs[k], (f"{path}{k}", v, theirs[k])


@pytest.mark.parametrize("argv", [
    [], ["--tiny"], ["--max_resolution", "16"], ["--max_resolution", "32", "--tiny"],
    ["--clip_weights", '{"64": 0.2, "8": 0.0}', "--epochs", "3", "--batch_size", "8",
     "--expert_parallelism", "2", "--lr", "1e-3", "--seed", "5"],
], ids=["defaults", "tiny", "res16", "res32_tiny", "flags"])
def test_config_from_args_matches_jax(argv):
    ours = train_model.config_from_args(train_model.build_parser().parse_args(argv))
    theirs = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    _common(ours.to_dict(), theirs.to_dict())
    assert ours.loss.clip_weights == theirs.loss.clip_weights


def test_parser_matches_jax_but_for_device():
    ours = vars(train_model.build_parser().parse_args([]))
    theirs = vars(jax_cli.build_parser().parse_args([]))
    assert ours.pop("device") == "cuda"
    assert ours == theirs


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """One tiny epoch of the CLI's default run (CLIP loss on, a toy tower pack)."""
    save_dir = str(tmp_path_factory.mktemp("run"))
    argv = ["--synthetic", "--tiny", "--epochs", "1", "--device", "cpu", "--max_resolution",
            "16", "--save_dir", save_dir, "--log_interval", "1"]
    mp = pytest.MonkeyPatch()
    loaded = []

    def toy_towers(device="cuda", **_):
        loaded.append(device)
        return as_tower_pack(init_toy_params(16))

    mp.setattr(clip, "load_clip_params", toy_towers)
    try:
        state = train_model.main(argv)
    finally:
        mp.undo()
    assert loaded == ["cpu"]
    return save_dir, argv, state


def test_cli_writes_what_the_jax_cli_writes(cli_run):
    save_dir, argv, state = cli_run
    assert state.step == 2  # 64 synthetic samples at batch 32
    assert sorted(os.listdir(save_dir)) == ["aurora_model_final.msgpack", "checkpoint_2.pt",
                                            "generator_config.json", "metrics.jsonl",
                                            "model_math_version.txt"]
    jargs, unknown = jax_cli.build_parser().parse_known_args(argv)
    assert unknown == ["--device", "cpu"]
    jcfg = jax_cli.config_from_args(jargs).generator
    shapes = jax.eval_shape(lambda: JaxGenerator(jcfg).init(
        {"params": jax.random.PRNGKey(0), "router": jax.random.PRNGKey(1)},
        jnp.zeros((1, jcfg.latent_dim)), jnp.zeros((1, jcfg.text_embedding_dim))))["params"]
    want = {"/".join(p.key for p in path): (tuple(s.shape), s.dtype) for path, s in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = jax_load_params(os.path.join(save_dir, "aurora_model_final.msgpack"))
    got = {"/".join(p.key for p in path): (tuple(np.shape(a)), np.asarray(a).dtype) for path, a
           in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert got == want
    with open(os.path.join(save_dir, "generator_config.json")) as f:
        written = json.load(f)
    assert type(jcfg).from_dict(written) == jcfg
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert all(set(r) == {"ts", "name", "value", "step"} for r in records)
    names = {r["name"] for r in records}
    assert {"train_imgs_per_sec", "val_d_loss", "val_g_loss", "val_clip_loss_8",
            "val_clip_loss_16", "val_clip_loss", "expert_util_per_block"} <= names


def test_cli_refuses_before_loading(tmp_path, monkeypatch):
    """`--gradient_accumulation_steps 2` trains (one update every two steps) and
    writes the run's files; without a card the CLI raises before it loads anything."""
    run = tmp_path / "a"
    state = train_model.main(["--synthetic", "--tiny", "--device", "cpu", "--max_resolution",
                              "16", "--epochs", "1", "--no_clip_loss", "--log_interval", "1",
                              "--gradient_accumulation_steps", "2", "--save_dir", str(run)])
    assert state.step == 2 and int(state.g_opt.count) == int(state.d_opt.count) == 1
    assert int(state.g_opt.mini_step) == 0
    assert sorted(os.listdir(run)) == ["aurora_model_final.msgpack", "checkpoint_2.pt",
                                       "generator_config.json", "metrics.jsonl",
                                       "model_math_version.txt"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_model.main(["--synthetic", "--save_dir", str(tmp_path / "b")])
    assert not (tmp_path / "b").exists()


@pytest.mark.parametrize("augmented", [False, True], ids=["plain", "augmented"])
def test_processed_mscoco_round_trips_like_jax(tmp_path, augmented):
    rng = np.random.default_rng(3)
    images = rng.uniform(-1, 1, (10, 8, 8, 3)).astype(np.float32)
    embeds = rng.standard_normal((10, 512)).astype(np.float32)
    captions = np.asarray([f"a picture {i}" for i in range(10)], object)
    ProcessedMSCOCODataset(images, embeds, captions).save(str(tmp_path), "train",
                                                          augmented=augmented)
    for kw in (dict(), dict(use_percentage=0.35), dict(return_captions=True)):
        ours = ProcessedMSCOCODataset.load(str(tmp_path), "train", augmented=augmented, **kw)
        theirs = JaxDataset.load(str(tmp_path), "train", augmented=augmented, **kw)
        assert len(ours) == len(theirs) == (3 if kw.get("use_percentage") else 10)
        np.testing.assert_array_equal(ours.images, theirs.images)
        np.testing.assert_array_equal(ours.images, images[:len(ours)])
        np.testing.assert_array_equal(ours.text_embeddings, theirs.text_embeddings)
        if kw.get("return_captions"):
            assert list(ours.captions) == list(theirs.captions) == list(captions)
            assert ours[4][2] == theirs[4][2]
        else:
            assert ours.captions is None and theirs.captions is None
    with pytest.raises(FileNotFoundError):
        ProcessedMSCOCODataset.load(str(tmp_path), "validation")
