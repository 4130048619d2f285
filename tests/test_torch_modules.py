"""The port's modules against the JAX package's, on the CPU.

Each test builds the port module from a seed, carries its weights into the
JAX layout with `moegan_tpu_torch.convert`, feeds both the same numpy
inputs and compares. float32 compute on both sides, so the tolerances are
those of float32 summation order unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from moegan_tpu.config import GeneratorConfig as JaxGeneratorConfig
from moegan_tpu.core import attention as jattn
from moegan_tpu.core.blocks import GenerativeBlock as JaxGenerativeBlock
from moegan_tpu.core.modconv import ModulatedConv as JaxModulatedConv
from moegan_tpu.core.moe import SparseMoE as JaxSparseMoE
from moegan_tpu.core.mtm import ModulatedTransformationModule as JaxMTM
from moegan_tpu.core.router import BayesianRouter as JaxRouter
from moegan_tpu.core.upsample import upsample2x_bilinear as jax_upsample
from moegan_tpu.models.generator import AuroraGenerator as JaxGenerator
from moegan_tpu.ops.fused_layernorm import FusedLayerNorm
from moegan_tpu.train.state import count_params
from moegan_tpu_torch.config import GeneratorConfig
from moegan_tpu_torch.convert import jax_to_torch, torch_to_jax
from moegan_tpu_torch.core.attention import MultiHeadAttention
from moegan_tpu_torch.core.blocks import GenerativeBlock
from moegan_tpu_torch.core.modconv import ModulatedConv
from moegan_tpu_torch.core.moe import SparseMoE
from moegan_tpu_torch.core.mtm import ModulatedTransformationModule
from moegan_tpu_torch.core.router import BayesianRouter
from moegan_tpu_torch.core.upsample import upsample2x_bilinear
from moegan_tpu_torch.models.generator import AuroraGenerator
from moegan_tpu_torch.core import blocks as torch_blocks
from moegan_tpu_torch.core import upsample as torch_upsample
from moegan_tpu_torch.ops import upsample as tup
from moegan_tpu_torch.ops.layernorm import LayerNorm
from tests.torch_helpers import TINY_KW, decisive_router, jax_variables, randn, t

F32 = jnp.float32


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy() if torch.is_tensor(got) else got,
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


@pytest.mark.parametrize("k", [1, 3])
def test_modconv_matches_jax(k):
    m = ModulatedConv(12, 10, k, latent_dim=20, compute_dtype=torch.float32, gen=_gen(k))
    x, w = randn(1, 2, 6, 6, 12), randn(2, 2, 20)
    want = JaxModulatedConv(10, k, compute_dtype=F32).apply(jax_variables(m), x, w)
    _close(m(t(x), t(w)), want)


def test_mtm_with_offsets_matches_jax():
    m = ModulatedTransformationModule(8, 12, 3, use_offset=True, latent_dim=20,
                                      compute_dtype=torch.float32, gen=_gen(3))
    with torch.no_grad():  # offsets large enough to move the grid by pixels
        m.offset_conv2.weight.mul_(40.0)
    x, w = randn(4, 2, 8, 8, 8), randn(5, 2, 20)
    want = JaxMTM(12, 3, True, F32).apply(jax_variables(m), x, w)
    _close(m(t(x), t(w)), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_matches_jax(dtype):
    x = t(randn(6, 2, 5, 7, 3)).to(dtype)
    want = jax_upsample(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else F32))
    got = upsample2x_bilinear(x)
    assert got.dtype == dtype
    # bf16: both compute in fp32 and round once, so equal to the rounding.
    _close(got, want.astype(F32), rtol=0, atol=1e-6 if dtype == torch.float32 else 1e-2)


def _kernel_route_raises(monkeypatch, dispatcher_too: bool):
    """Make every entry into the upsample kernels raise (and with
    `dispatcher_too` the blocks' dispatcher, which routes to them on a card)."""
    def refuse(*_args, **_kw):
        raise AssertionError("the upsample kernel route was taken")

    monkeypatch.setattr(tup.Upsample2xFunction, "apply", refuse)
    monkeypatch.setattr(tup, "upsample2x_fwd", refuse)
    monkeypatch.setattr(tup, "upsample2x_bwd", refuse)
    if dispatcher_too:
        monkeypatch.setattr(torch_blocks, "upsample2x_bilinear", refuse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_dispatches_cpu_tensor_to_plain(monkeypatch, dtype):
    _kernel_route_raises(monkeypatch, dispatcher_too=False)
    x = t(randn(61, 2, 5, 7, 20)).to(dtype).requires_grad_(True)
    got = torch_upsample.upsample2x_bilinear(x)
    want = tup.upsample2x_reference(x)
    assert got.dtype == dtype and got.shape == (2, 10, 14, 20)
    assert torch.equal(got, want)
    dy = t(randn(62, 2, 10, 14, 20)).to(dtype)
    (dx,) = torch.autograd.grad(got, x, dy)
    assert torch.equal(dx, tup.upsample2x_bwd_reference(dy))


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 4, 2), (3, 4, 4, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_plain_bwd_matches_jax_vjp(shape, dtype):
    B, H, W, C = shape
    dy = t(randn(64, B, 2 * H, 2 * W, C)).to(dtype)
    # JAX in float32 on the same (bf16-representable) cotangent: its bf16
    # vjp rounds between the two axes' contractions, the plain version sums
    # both axes in float32 and rounds once.
    _, vjp = jax.vjp(jax_upsample, jnp.asarray(randn(63, *shape)))
    (want,) = vjp(jnp.asarray(dy.float().numpy()))
    got = tup.upsample2x_bwd_reference(dy)
    assert got.dtype == dtype and got.shape == shape
    # At most 16 products of 0.25/0.75 weights, exact on bf16 values, summed
    # in float32 in two orders: float32 roundings, and at bf16 the one
    # rounding of the result (half an ulp: at most 2^-8 relative).
    rtol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    _close(got, want, rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_generative_block_use_pallas_false_never_touches_kernel(monkeypatch, use_pallas):
    _kernel_route_raises(monkeypatch, dispatcher_too=True)
    m = GenerativeBlock(12, 8, text_dim=20, latent_dim=20, upsample=True, heads=1,
                        num_experts=2, router_hidden=8, compute_dtype=torch.float32,
                        gen=_gen(9), use_pallas=use_pallas)
    x = t(randn(65, 2, 4, 4, 12)).requires_grad_(True)
    w, ts = t(randn(66, 2, 20)), t(randn(67, 2, 1, 20))
    if use_pallas:  # the control: the same block with the kernels meets the patch
        with pytest.raises(AssertionError, match="kernel route"):
            m(x, w, ts)
        return
    out, _, _ = m(x, w, ts)
    out.sum().backward()
    assert out.shape == (2, 8, 8, 8) and x.grad is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_matches_jax(dtype):
    ln = LayerNorm(24)
    with torch.no_grad():
        ln.weight.copy_(t(randn(7, 24)))
        ln.bias.copy_(t(randn(8, 24)))
    x = t(randn(9, 3, 5, 24, scale=3.0)).to(dtype)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else F32)
    want = FusedLayerNorm().apply(jax_variables(ln), jx)
    got = ln(x)
    assert got.dtype == dtype
    _close(got, want.astype(F32), atol=1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("T,heads", [(16, 2), (256, 1)])
def test_self_attention_matches_jax(T, heads):
    # T=256 takes the flash branch on both sides (chunked attention in JAX
    # on the CPU, the kernel's plain version here); T=16 the plain branch.
    m = MultiHeadAttention(32, heads, torch.float32, gen=_gen(T))
    x = randn(10, 2, T, 32)
    want = jattn.MultiHeadAttention(32, heads, F32, use_pallas=True).apply(
        jax_variables(m), x, x, x)
    _close(m.self_attention(t(x)), want)


def test_cross_attention_single_token_matches_jax():
    m = MultiHeadAttention(16, 2, torch.float32, gen=_gen(5))
    q, kv = randn(11, 3, 20, 16), randn(12, 3, 1, 16)
    want = jattn.MultiHeadAttention(16, 2, F32).apply(jax_variables(m), q, kv, kv)
    _close(m.cross_single(t(q), t(kv)), want)


def test_router_eval_matches_jax():
    r = decisive_router(BayesianRouter(12, 20, 4, 8, gen=_gen(6)))
    f, w = randn(13, 2, 30, 12), randn(14, 2, 20)
    want_p, want_l = JaxRouter(12, 20, 4, 8).apply(jax_variables(r), f, w, sampling=False, hard=True)
    got_p, got_l = r(t(f), t(w), hard=True)
    _close(got_l, want_l, atol=1e-6)
    np.testing.assert_array_equal(got_p.detach().numpy(), np.asarray(want_p))


def test_sparse_moe_matches_jax():
    m = decisive_router(SparseMoE(16, 20, 4, 8, torch.float32, gen=_gen(7)))
    x, w = randn(15, 2, 37, 16), randn(16, 2, 20)
    want_out, _, want_p = JaxSparseMoE(16, 20, 4, 8, F32, use_pallas=True).apply(
        jax_variables(m), x, w, training=False)
    got_out, kl, got_p = m(t(x), t(w))
    assert kl.item() == 0.0
    np.testing.assert_array_equal(got_p.detach().numpy(), np.asarray(want_p))
    _close(got_out, want_out)


def test_generative_block_matches_jax():
    m = decisive_router(GenerativeBlock(
        24, 16, text_dim=20, latent_dim=20, upsample=True, use_offset=True, heads=1,
        num_experts=4, router_hidden=8, compute_dtype=torch.float32, gen=_gen(8)))
    x, w, ts = randn(17, 2, 8, 8, 24), randn(18, 2, 20), randn(19, 2, 1, 20)
    jb = JaxGenerativeBlock(16, 20, upsample=True, use_offset=True, heads=1, num_experts=4,
                            router_hidden=8, compute_dtype=F32, use_pallas=True)
    want_x, _, want_p = jb.apply(jax_variables(m), x, w, ts, False)
    got_x, kl, got_p = m(t(x), t(w), t(ts))
    assert kl.item() == 0.0
    np.testing.assert_array_equal(got_p.detach().numpy(), np.asarray(want_p))
    _close(got_x, want_x, atol=2e-5)


def test_converter_names_and_counts_match_jax_tree():
    cfg = GeneratorConfig(**TINY_KW)
    g = AuroraGenerator(cfg, gen=_gen(0))
    shapes = jax.eval_shape(
        lambda: JaxGenerator(JaxGeneratorConfig(**TINY_KW)).init(
            {"params": jax.random.PRNGKey(0), "router": jax.random.PRNGKey(0)},
            jnp.zeros((1, 512)), jnp.zeros((1, 512)))["params"])
    want = {"/".join(k): tuple(v.shape) for k, v in flatten_dict(shapes).items()}
    got = torch_to_jax(g.state_dict())
    assert {k: v.shape for k, v in got.items()} == want
    assert sum(p.numel() for p in g.parameters()) == count_params(shapes)
    back = jax_to_torch(got)
    assert set(back) == set(g.state_dict())
    for k, v in g.state_dict().items():
        assert torch.equal(back[k], v), k
