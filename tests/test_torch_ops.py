"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper takes its plain PyTorch version; the JAX
kernels run in Pallas interpret mode, as tests/test_attention_ops.py and
tests/test_fused_moe.py run them. The CUDA kernels are held against the plain
versions on the card in tests/test_torch_cuda.py.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moegan_tpu.ops import flash_attention as jfa
from moegan_tpu.ops import fused_moe as jfm
from moegan_tpu_torch.ops import flash_attention as tfa
from moegan_tpu_torch.ops import fused_moe as tfm
from tests.torch_helpers import MOE_ORDER, moe_inputs, randn, t


def _interpret(module):
    """Force the module's pallas_call into interpret mode."""
    real = module.pl.pallas_call

    def fake(*a, **kw):
        kw["interpret"] = True
        return real(*a, **kw)

    return mock.patch.object(module.pl, "pallas_call", fake)


def _jax_flash(q, k, v):
    """(o, lse [B, H, T]) from the TPU kernel: the no-lse call and the lse call."""
    B, T, H, _ = q.shape
    with _interpret(jfa), mock.patch.object(jfa, "_supported", lambda *a: True):
        o = jfa.flash_attention(q, k, v, 128, 64)  # 4 KV tiles of 64
        o2, lse = jfa._flash_forward(q, k, v, block_q=128, block_k=64,
                                     with_lse=True, use_exp2=True)
    np.testing.assert_array_equal(np.asarray(o), np.asarray(o2))
    return np.asarray(o.astype(jnp.float32)), np.asarray(lse).reshape(B, H, T)


@pytest.mark.parametrize("D", [16, 32])
def test_flash_plain_matches_pallas_kernel_fp32(D):
    # float32: the two differ only in summation order (online vs full
    # softmax), so 1e-5 on outputs of magnitude ~1.
    q, k, v = (randn(D + i, 2, 256, 2, D) for i in range(3))
    want_o, want_lse = _jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    before = tfa.flash_attention.launches
    got_o, got_lse = tfa.flash_attention(t(q), t(k), t(v), with_lse=True)
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)
    assert tfa.flash_attention.launches == before  # the CPU takes the plain version


@pytest.mark.parametrize("D", [16, 32])
def test_flash_plain_matches_pallas_kernel_bf16(D):
    # bf16: both pre-scale q in bf16 and round p to bf16, but p is taken
    # against the running max (kernel) or the row max (plain), so p's
    # rounding differs; outputs are |o| < ~1, where one bf16 ulp is 2^-8..2^-7.
    q, k, v = (torch.from_numpy(randn(7 * D + i, 2, 256, 2, D)).to(torch.bfloat16) for i in range(3))
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v))
    want_o, want_lse = _jax_flash(jq, jk, jv)
    got_o, got_lse = tfa.flash_attention(q, k, v, with_lse=True)
    np.testing.assert_allclose(got_o.float().numpy(), want_o, atol=2e-2)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=2e-2)


@pytest.mark.parametrize("B", [4, 16, 64])
def test_flash_plan_fits_every_shape(B):
    # The self-attention shapes of the 64x64 generator (res 16 / 32 / 64)
    # served at batch 4 and 16 and trained at batch 64, at every head dim the
    # wrapper accepts, on the H100's 132 SMs: q tiles of whole 16-row warp
    # strips of a 4-warp block, 128-row tiles only at D <= 32 and only while
    # their grid still covers the card. Each kernel checks its own shared
    # memory against a block's limit when it is compiled.
    for T, H in ((256, 8), (1024, 2), (4096, 1)):
        for D in (16, 32, 48, 64):
            block_q = tfa.flash_plan(B, H, T, D, 132)
            assert block_q in (64, 128), (B, T, H, D, block_q)
            if block_q == 128:
                assert D <= 32 and -(-T // 128) * B * H >= 132, (B, T, H, D)
    assert tfa.flash_plan(4, 1, 4096, 32, 132) == 64  # the lone served request
    assert tfa.flash_plan(64, 1, 4096, 32, 132) == 128
    assert tfa.flash_plan(64, 1, 4096, 64, 132) == 64
    # 512 tiles of 128 rows fill 132 SMs, not 1000
    assert tfa.flash_plan(16, 1, 4096, 32, 132) == 128
    assert tfa.flash_plan(16, 1, 4096, 32, 1000) == 64


@pytest.mark.parametrize("phase,B,E", [("serve", 4, 4), ("serve", 16, 4), ("train", 64, 4),
                                       ("combine", 64, 2)])
def test_moe_plans_fit_every_shape(phase, B, E):
    # The five MoE blocks of the 64x64 generator (F = 4C) as the port launches
    # them on the H100's 132 SMs: served at batch 4 and 16 (the forward),
    # trained at batch 64 (forward and backward) and combined under expert
    # parallelism 2 (2 local experts, forward and backward). Each kernel
    # checks the plan it is given, and bounds its own shared memory by a
    # static_assert when it is built.
    sms = 132
    for res, C in ((4, 512), (8, 256), (16, 128), (32, 64), (64, 32)):
        T, F = B * res * res, 4 * C
        plans = [tfm.moe_plan(T, C, F, E, sms)]
        if phase != "serve":
            plans.append(tfm.moe_bwd_plan(T, C, F, E, sms))
        for plan in plans:
            tiles, chunks = -(-T // plan.block_t), E * -(-F // 64)
            assert F % 64 == 0 and 1 <= plan.splits <= chunks, (phase, res, plan)
            # at least a block per SM wherever the tiles and chunks allow it
            assert tiles * plan.splits >= min(sms, tiles * chunks), (phase, res, plan)
        if phase != "serve":
            bwd = plans[1]
            assert bwd.t_range % 32 == 0 and bwd.scratch == (C > 64)
            grid = tfm.wgrad_grid(C, F, E)
            assert grid * bwd.t_ranges >= min(sms, grid * -(-T // 32))
            # the T ranges [s * t_range, (s + 1) * t_range) cover T exactly once
            ends = [min(T, (s + 1) * bwd.t_range) for s in range(bwd.t_ranges)]
            assert ends[-1] == T and (bwd.t_ranges - 1) * bwd.t_range < T, (phase, res, bwd)


def test_plans_fit_the_flagship_and_one_expert_shapes():
    # tpu_flagship_config's rungs at batch 64 (C 512/512/256/128/64, its
    # attention at head_dim 32/16/32), and the dense one-expert generator's
    # MoE (E = 1) at the default widths, on the H100's 132 SMs.
    from moegan_tpu_torch.config import GeneratorConfig, tpu_flagship_config

    sms, B = 132, 64
    gcfg = tpu_flagship_config().generator
    attn = {r: (gcfg.heads_for(c), c // gcfg.heads_for(c)) for r, c in gcfg.channels.items()
            if r >= 16}
    assert attn == {16: (8, 32), 32: (8, 16), 64: (2, 32)}
    for r, (H, D) in attn.items():
        assert tfa.flash_plan(B, H, r * r, D, sms) == 128  # D <= 32, the grid fills the card
    shapes = [(r, C, 4) for r, C in gcfg.channels.items()]
    shapes += [(r, C, 1) for r, C in GeneratorConfig().channels.items()]
    for res, C, E in shapes:
        T, F = B * res * res, 4 * C
        fwd, bwd = tfm.moe_plan(T, C, F, E, sms), tfm.moe_bwd_plan(T, C, F, E, sms)
        tiles, chunks = -(-T // fwd.block_t), E * -(-F // 64)
        for plan in (fwd, bwd):
            assert 1 <= plan.splits <= chunks and tiles * plan.splits >= min(sms, tiles * chunks)
        assert bwd.scratch == (C > 64) and bwd.t_range % 32 == 0
        ends = [min(T, (s + 1) * bwd.t_range) for s in range(bwd.t_ranges)]
        assert ends[-1] == T and (bwd.t_ranges - 1) * bwd.t_range < T, (res, C, E, bwd)


@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("kernel", ["v1", "v2"])
def test_moe_plain_matches_pallas_kernel(kernel, hard):
    # float32 on both sides: probs to 1e-6, out to 1e-5 (summation order).
    a = moe_inputs()
    call = jfm._fused_moe_pallas if kernel == "v1" else jfm._fused_moe_pallas_v2
    with _interpret(jfm):
        want_out, want_p = call(*(a[k] for k in MOE_ORDER), hard, 32)
    before = tfm.fused_moe_ffn.launches
    got_out, got_p = tfm.fused_moe_ffn(
        *(t(a[k]) if k != "inv_temp" else a[k] for k in MOE_ORDER), hard=hard)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    if hard:
        np.testing.assert_array_equal(got_p.numpy()[5], [0.5, 0.5, 0.0, 0.0])
    assert tfm.fused_moe_ffn.launches == before


def test_moe_plain_bf16_matches_pallas_v2_hard():
    # bf16 tokens and weights (the serving dtypes). Under hard routing p is
    # 0, 1/2 or 1, so the kernels' extra roundings are exact; what differs
    # is the fp32 summation order of bf16 products: outputs ~0.3 in bf16, 1 ulp.
    a = moe_inputs(seed=11)
    bf = {"x", "fw", "w1", "w2"}
    ja = {k: (jnp.asarray(v).astype(jnp.bfloat16) if k in bf else v) for k, v in a.items()}
    ta = {k: (t(v).to(torch.bfloat16) if k in bf else (t(v) if k != "inv_temp" else v))
          for k, v in a.items()}
    with _interpret(jfm):
        want_out, want_p = jfm._fused_moe_pallas_v2(*(ja[k] for k in MOE_ORDER), True, 32)
    got_out, got_p = tfm.fused_moe_ffn(*(ta[k] for k in MOE_ORDER), hard=True)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_allclose(got_out.float().numpy(), np.asarray(want_out.astype(jnp.float32)),
                               atol=8e-3)


def test_wrappers_reject_unknown_devices():
    x = torch.zeros(2, 16, device="meta")
    with pytest.raises(ValueError):
        tfm.fused_moe_ffn(x, x, x, x, 1.0, x, x, x, x)
    q = torch.zeros(1, 4, 1, 16, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)
