"""Progressive training (`train/progressive.py`) and the configuration helpers
(`config.py::tpu_flagship_config`, `coerce_hyperparameters`) against the JAX
package's.

`transfer_params` is held to JAX's on the tiny ladder and on the default
one (16 -> 32 -> 64 at the reference channels): taken through
`convert.torch_to_jax`, the tensors the port copies are the flax paths JAX
copies. The default ladder's counts are pinned here, and chip_smoke.py's
phase 12 (c) holds the card's progressive run to the same numbers. The JAX
side needs only the parameter shapes (`jax.eval_shape`): no JAX compile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moegan_tpu import config as jax_config
from moegan_tpu.data.datasets import synthetic_dataset as jax_synthetic
from moegan_tpu.models.generator import AuroraGenerator as JaxGenerator
from moegan_tpu.train import progressive as jax_progressive
from moegan_tpu_torch import config
from moegan_tpu_torch.convert import torch_to_jax
from moegan_tpu_torch.data.datasets import synthetic_dataset
from moegan_tpu_torch.models.generator import AuroraGenerator
from moegan_tpu_torch.train import progressive
from tests import torch_dist_helpers as dh
from tests.torch_dist_helpers import ListLogger

TINY_CH = {4: 32, 8: 24, 16: 16, 32: 16}
# Generator tensors carried into each stage of the 16 -> 32 -> 64 ladder.
PINNED_TRANSFERS = {"tiny": {32: 192}, "default": {32: 192, 64: 245}}


def _common(ours: dict, theirs: dict, path=""):
    """Every field of the port's config dict equals the JAX config's."""
    for k, v in ours.items():
        assert k in theirs, f"{path}{k}"
        if isinstance(v, dict) and isinstance(theirs[k], dict):
            _common(v, theirs[k], f"{path}{k}.")
        else:
            assert v == theirs[k], (f"{path}{k}", v, theirs[k])


def _cfgs(**gen):
    """The same TrainConfig in both packages."""
    jcfg = jax_config.TrainConfig(generator=jax_config.GeneratorConfig(**gen))
    return config.TrainConfig.from_dict(jcfg.to_dict()), jcfg


@pytest.mark.parametrize("resolution", [16, 32, 64])
def test_stage_config_matches_jax(resolution):
    for gen in ({}, dict(max_resolution=32, channels=TINY_CH),
                dict(max_resolution=16, channels={4: 32, 8: 24, 16: 16})):
        ours, theirs = _cfgs(**gen)
        got = progressive.stage_config(ours, resolution, 3)
        want = jax_progressive.stage_config(theirs, resolution, 3)
        _common(got.to_dict(), want.to_dict())
        assert got.generator.channels == dict(want.generator.channels)
        assert got.loss.clip_weights == dict(want.loss.clip_weights)
    assert progressive.FULL_CHANNELS == jax_progressive.FULL_CHANNELS


def test_flagship_config_and_coercion_match_jax():
    for batch in (64, 8):
        ours, theirs = config.tpu_flagship_config(batch), jax_config.tpu_flagship_config(batch)
        _common(ours.to_dict(), theirs.to_dict())
        assert min(ours.generator.channels.values()) == 64
    raw = {"epochs": "3.0", "batch_size": "16", "gradient_accumulation_steps": "2",
           "lr": "2e-4", "clip_weight_64": "0.1", "truncation_psi": "0.7", "resume": "True",
           "shared_fake": "false", "data_dir": "/data", "seed": "7", "max_resolution": "32",
           "note": 5}
    got = config.coerce_hyperparameters(raw)
    want = jax_config.coerce_hyperparameters(raw)
    assert got == want and [type(v) for v in got.values()] == [type(v) for v in want.values()]


@pytest.mark.parametrize("src", [32, 64])
def test_resize_dataset_matches_jax(src):
    """jax.image.resize's bilinear antialiases when it downsamples."""
    ours, theirs = synthetic_dataset(6, src, seed=3), jax_synthetic(6, src, seed=3)
    np.testing.assert_array_equal(ours.images, theirs.images)
    got = progressive.resize_dataset(ours, 16)
    want = jax_progressive.resize_dataset(theirs, 16)
    assert got.images.shape == (6, 16, 16, 3) and got.images.dtype == np.float32
    np.testing.assert_allclose(got.images, np.asarray(want.images), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.text_embeddings, ours.text_embeddings)
    assert progressive.resize_dataset(got, 16) is got


def _generators(base: config.TrainConfig, jbase, resolution):
    """The stage's port generator state dict and the JAX generator's parameter shapes."""
    cfg = progressive.stage_config(base, resolution, 1)
    jcfg = jax_progressive.stage_config(jbase, resolution, 1)
    sd = AuroraGenerator(cfg.generator, gen=torch.Generator().manual_seed(resolution)).state_dict()
    jg = JaxGenerator(jcfg.generator)
    shapes = jax.eval_shape(lambda: jg.init(
        {"params": jax.random.PRNGKey(0), "router": jax.random.PRNGKey(1)},
        jnp.zeros((1, jcfg.generator.latent_dim)),
        jnp.zeros((1, jcfg.generator.text_embedding_dim))))["params"]
    return sd, shapes


def _jax_paths(tree) -> dict:
    return {"/".join(p.key for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("ladder", ["tiny", "default"])
def test_transfer_params_copies_what_jax_copies(ladder):
    gen = dict(max_resolution=32, channels=TINY_CH, router_hidden=8) if ladder == "tiny" else {}
    base, jbase = _cfgs(**gen)
    stages = sorted(PINNED_TRANSFERS[ladder])
    prev, jprev = _generators(base, jbase, 16)
    for r in stages:
        new, jnew = _generators(base, jbase, r)
        grafted, copied = progressive.transfer_params(prev, new)
        jgrafted, jcopied = jax_progressive.transfer_params(jprev, jnew)
        assert copied == jcopied == PINNED_TRANSFERS[ladder][r], (r, copied, jcopied)
        assert list(grafted) == list(new)  # the new stage's names, in its order
        ours = {k for k in grafted if grafted[k] is prev.get(k)}
        old = {id(v) for v in _jax_paths(jprev).values()}
        theirs = {k for k, v in _jax_paths(jgrafted).items() if id(v) in old}
        mapped = set(torch_to_jax({k: grafted[k] for k in ours}))
        assert len(ours) == copied and mapped == theirs
        assert not any(k.startswith(f"gen_block_{r}.") or k.startswith(f"to_rgb_{r}.")
                       for k in ours)  # the new block and its tap start fresh
        prev, jprev = grafted, jgrafted


def test_train_progressive_runs_two_stages(tmp_path):
    """The port's ladder end to end on the CPU: 16 then 32, one epoch each."""
    base = config.TrainConfig(
        batch_size=4, log_interval=1, lr=1e-3,
        generator=config.GeneratorConfig(max_resolution=32, channels=TINY_CH, router_hidden=8,
                                         compute_dtype="float32"),
        discriminator=config.DiscriminatorConfig(max_resolution=32, compute_dtype="float32"))
    log = ListLogger()
    state, stages = progressive.train_progressive(
        synthetic_dataset(8, 32, seed=1), synthetic_dataset(4, 32, seed=2), cfg=base,
        stages=((16, 1), (32, 1)), save_dir=str(tmp_path), logger=log, device="cpu")
    assert [r for r, _ in stages] == [16, 32] and stages[-1][1] is state
    assert state.generator.config.max_resolution == 32
    assert state.discriminator.config.max_resolution == 32
    assert "=== progressive stage 16x16 (1 epochs) ===" in log.lines
    assert log.lines.count(
        f"transferred {PINNED_TRANSFERS['tiny'][32]} generator tensors from the previous stage") == 1
    for r, s in stages:
        assert s.step == 2 and int(s.g_opt.count) == 2
        assert sorted(p.name for p in (tmp_path / f"stage_{r}").iterdir()) == [
            "checkpoint_2.pt", "model_math_version.txt"]
        assert all(bool(torch.isfinite(p).all()) for p in s.generator.parameters())
    assert {m[0] for m in log.metrics} >= {"val_d_loss", "val_g_loss", "train_imgs_per_sec"}


def test_progressive_under_expert_parallelism_matches_one_process():
    """data 1 x expert 2 over gloo: each rank grafts its own expert slices (the
    same names, shapes and count) into the next stage. The 32 stage runs no
    epoch, so its state is the graft: the stage-16 tensors bit for bit on each
    rank, the fresh ones as one process initialises them."""
    cfg = config.TrainConfig(
        batch_size=4, log_interval=1, lr=1e-3, mesh=config.MeshConfig(expert_parallelism=2),
        generator=config.GeneratorConfig(max_resolution=32, channels=TINY_CH, router_hidden=8,
                                         compute_dtype="float32"),
        discriminator=config.DiscriminatorConfig(max_resolution=32, compute_dtype="float32"))
    stages = ((16, 1), (32, 0))
    ranks = dh.spawn("progressive_ranks", 2, cfg_dict=cfg.to_dict(), stages=stages)
    stage_states, log = dh.progressive_run(cfg.to_dict(), stages, False)
    single = [dh.full_state(s) for _, s in stage_states]
    line = f"transferred {PINNED_TRANSFERS['tiny'][32]} generator tensors from the previous stage"
    assert log.lines.count(line) == 1
    for r, got in enumerate(ranks):
        assert got["lines"].count(line) == 1 and got["steps"] == [2, 0]
        assert got["shapes"]["gen_block_32.attn_block.moe.w1"] == (2, 16, 64)  # 2 of 4 experts
        first, graft = got["stages"]
        carried = [k for k in graft["g"] if k in first["g"]
                   and first["g"][k].shape == graft["g"][k].shape]
        assert len(carried) == PINNED_TRANSFERS["tiny"][32]
        for k, v in graft["g"].items():
            want = first["g"][k] if k in carried else single[1]["g"][k]
            np.testing.assert_array_equal(v, want, err_msg=f"rank {r} {k}")
        # Stage 16's two Adam steps against one process's, as
        # test_torch_parallel.py's loop test holds them.
        for net in ("g", "d"):
            for k, v in single[0][net].items():
                off = np.abs(first[net][k] - v) > 1e-2 * cfg.lr
                assert off.mean() <= 1e-3, (r, net, k, off.mean())
