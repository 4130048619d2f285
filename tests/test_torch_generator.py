"""The slice end to end: the port's generator against `AuroraGenerator.apply(training=False)`.

A tiny config with use_pallas=True (the JAX default: on the CPU JAX then
runs `moe_ffn_reference` and chunked attention, the kernels' math) and a
per-sample truncation psi vector. The JAX model (jitted once per dtype)
runs on the port's seeded weights, carried across with `convert.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moegan_tpu.config import GeneratorConfig as JaxGeneratorConfig
from moegan_tpu.models.generator import AuroraGenerator as JaxGenerator
from moegan_tpu_torch.config import GeneratorConfig
from moegan_tpu_torch.infer.sample import Sampler
from moegan_tpu_torch.models.generator import AuroraGenerator
from moegan_tpu_torch.models.toy_clip import as_tower_pack, init_toy_params
from tests.torch_helpers import TINY_KW, decisive_router, jax_variables, randn, t


def _pair(dtype: str, seed: int = 0):
    g = decisive_router(AuroraGenerator(
        GeneratorConfig(compute_dtype=dtype, **TINY_KW), gen=torch.Generator().manual_seed(seed)))
    jg = JaxGenerator(JaxGeneratorConfig(use_pallas=True, compute_dtype=dtype, **TINY_KW))
    return g.eval(), jg, jax_variables(g)


def _jax_apply(jg, variables, z, txt, psi):
    f = jax.jit(lambda v, z, t, p: jg.apply(v, z, t, truncation_psi=p, training=False))
    return f(variables, z, txt, jnp.asarray(psi))


def _inputs(n=3):
    return randn(100, n, 512), randn(101, n, 512), np.linspace(0.5, 1.0, n).astype(np.float32)


def test_generator_fp32_matches_jax():
    g, jg, variables = _pair("float32")
    z, txt, psi = _inputs()
    want = _jax_apply(jg, variables, z, txt, psi)
    with torch.inference_mode():
        got = g(t(z), t(txt), t(psi))
    # Images reach |x| ~ 30 before clipping; float32 summation order.
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image), rtol=1e-5, atol=2e-4)
    assert set(got.intermediates) == set(want.intermediates) == {8, 16}
    np.testing.assert_allclose(got.intermediates[8].numpy(), np.asarray(want.intermediates[8]),
                               rtol=1e-5, atol=2e-4)
    for a, b in zip(got.routing, want.routing):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_generator_bf16_matches_jax_loosely():
    # bf16 activations on both sides, rounded at the same places but summed
    # in other orders, through 3 blocks: most pixels of the clipped images
    # (the served range [-1, 1]) agree to a few bf16 ulps of O(1) values; a
    # token whose top-1 expert flips under bf16 noise moves its pixels by
    # O(1), so the check bounds the mean and the share of such pixels.
    g, jg, variables = _pair("bfloat16", seed=1)
    z, txt, psi = _inputs(2)
    want = _jax_apply(jg, variables, z, txt, psi)
    with torch.inference_mode():
        got = g(t(z), t(txt), t(psi))
    a = np.clip(got.image.numpy(), -1, 1)
    b = np.clip(np.asarray(want.image, np.float32), -1, 1)
    assert np.isfinite(a).all() and a.shape == b.shape == (2, 16, 16, 3)
    diff = np.abs(a - b)
    assert diff.mean() < 2e-2
    assert (diff > 0.1).mean() < 0.02


def test_scalar_psi_and_broadcast_text_match_vector_form():
    g, _, _ = _pair("float32")
    z, txt, _ = _inputs(2)
    with torch.inference_mode():
        a = g(t(z), t(txt[:1]), 0.7).image
        b = g(t(z), t(np.repeat(txt[:1], 2, 0)), torch.full((2,), 0.7)).image
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GeneratorConfig(compute_dtype="float32", **TINY_KW)
    sd = AuroraGenerator(cfg).state_dict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Sampler(cfg, sd)
    assert Sampler(cfg, sd, device="cpu").device.type == "cpu"


def test_sampler_call_shapes_and_range():
    cfg = GeneratorConfig(compute_dtype="float32", **TINY_KW)
    s = Sampler(cfg, AuroraGenerator(cfg).state_dict(), device="cpu")
    imgs, stats = s(randn(5, 512), num_samples=3, truncation_psi=0.7, seed=1, return_stats=True)
    assert imgs.shape == (3, 16, 16, 3) and imgs.abs().max() <= 1.0
    assert set(stats) == {"block_0", "block_1", "block_2"}
    assert abs(sum(stats["block_2"]["top1_fraction"]) - 1.0) < 1e-6
    # a string prompt goes through the tower pack's text tower (here the toy pack)
    s.clip_params = as_tower_pack(init_toy_params())
    emb = s.encode_text("a red bird")
    assert emb.shape == (1, 512)
    torch.testing.assert_close(s("a red bird", num_samples=3, seed=1),
                               s(emb.numpy(), num_samples=3, seed=1), rtol=0, atol=0)


def test_one_expert_generator_matches_jax():
    """BASELINE config 1, the dense one-expert generator: every routing
    probability is 1 (eval and training), and the image matches JAX's."""
    cfg = GeneratorConfig(compute_dtype="float32", num_experts=1, **TINY_KW)
    g = AuroraGenerator(cfg, gen=torch.Generator().manual_seed(4)).eval()
    jg = JaxGenerator(JaxGeneratorConfig(use_pallas=True, compute_dtype="float32",
                                         num_experts=1, **TINY_KW))
    z, txt, psi = _inputs()
    want = _jax_apply(jg, jax_variables(g), z, txt, psi)
    with torch.inference_mode():
        got = g(t(z), t(txt), t(psi))
        eps = {r: tuple(torch.randn(mu.shape, generator=torch.Generator().manual_seed(r))
                        for mu in getattr(g, f"gen_block_{r}").attn_block.moe.router
                        .mean_weights()) for r in cfg.resolutions()}
        trained = g(t(z), t(txt), training=True, annealing_factor=2.0, router_eps=eps)
    for probs in (*got.routing, *want.routing, *trained.routing):
        assert probs.shape[-1] == 1 and bool((np.asarray(probs) == 1.0).all())
    # float32 in other summation orders; images reach |x| ~ 30 before clipping
    img, ref = got.image.numpy(), np.asarray(want.image)
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    assert np.isfinite(trained.image.numpy()).all()
