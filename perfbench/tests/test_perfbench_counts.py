"""The model FLOP counts of `perfbench.counts.model` against torch's
FlopCounterMode run over the reference at the tiny configuration."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.counts import kernels
from perfbench.counts import model as counts
from perfbench.harness import weights as W
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train
from perfbench.tests.tiny import TINY, port_config, split, tiny_weights

B = 4


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.fixture(scope="module")
def params():
    from moegan_tpu_torch.train.state import create_train_state

    w = tiny_weights(1, create_train_state(port_config(), device="cpu"))
    return split(w, "G"), split(w, "D")


def test_forward_counts(params):
    G, D = params
    tc = TINY["train_config"]
    g, d = tc["generator"], tc["discriminator"]
    z, t = torch.randn(B, 32), torch.randn(B, 32)
    eps = W.NoiseStream(TINY, B, 0, "cpu").next()["eps_g"]
    with torch.no_grad():
        # the reference's eval mixture runs every expert densely
        assert _flops(lambda: ref_model.generator(G, g, z, t, psi=torch.full((B,), 0.7))) == (
            counts.generator_forward(g, B) + counts.truncation(g))
        assert _flops(lambda: ref_model.generator(G, g, z, t, training=True, annealing=3.0,
                                                  router_eps=eps)) == counts.generator_forward(g, B)
        img = torch.randn(B, 16, 16, 3)
        assert _flops(lambda: ref_model.discriminator(D, d, img, t)) == (
            counts.discriminator_forward(d, B))
    assert counts.generator_forward(g, B, 1) < counts.generator_forward(g, B)


def test_training_step_count(params):
    G, D = ({k: v.clone().requires_grad_(True) for k, v in p.items()} for p in params)
    tc = TINY["train_config"]
    batch = {"image": torch.rand(B, 16, 16, 3) * 2 - 1, "text": torch.randn(B, 32)}
    noise = W.NoiseStream(TINY, B, 0, "cpu").next()
    g_opt = ref_train.AdamW(G, tc["grad_clip_g"], tc, 8)
    d_opt = ref_train.AdamW(D, tc["grad_clip_d"], tc, 8)
    got = _flops(lambda: ref_train.train_step(
        G, D, g_opt, d_opt, tc, batch, noise,
        {"temperature_factor": 3.0, "effective_kl_weight": 1e-8}, remat=False))
    # 4 G + 14 D forwards; the count leaves out input gradients the step
    # never needs (the first layers'), a few per mille here
    assert got == pytest.approx(counts.train_step(TINY, B), rel=0.01)


def test_kernel_bounds():
    flops, nbytes = kernels.flash_fwd(64, 1, 4096, 32)
    assert flops == 4.0 * 64 * 4096 * 4096 * 32
    assert kernels.bound_s(flops, nbytes) == flops / kernels.PEAK_BF16_FLOPS
    f_soft, _ = kernels.moe_fwd(1024, 32, 128, 4, 128)
    f_hard, _ = kernels.moe_fwd(1024, 32, 128, 4, 128, selections=1024, used=4)
    assert f_soft - f_hard == 3 * 1024 * 4.0 * 32 * 128
    shapes = counts.flash_shapes(TINY["train_config"]["generator"], 2)
    assert [s[3] for s in shapes] == [256]
