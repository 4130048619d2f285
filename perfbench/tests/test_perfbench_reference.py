"""The frozen reference against the program's CPU path, at a tiny configuration.

With the program's compute dtype set to float32 both sides compute the
same real-number function, so they agree to float32 rounding: the eval
generator (mean router weights, hard routing, per-sample truncation) and
two whole training steps (losses, and every parameter after the second
update). The reference itself imports nothing of the program; this test
file is the only place where both meet.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.harness import weights as W
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train
from perfbench.tests.tiny import STEPS_PER_EPOCH, TINY, port_config, split, tiny_weights


def test_eval_generator_matches_port():
    from moegan_tpu_torch.train.state import create_train_state

    state = create_train_state(port_config(), device="cpu")
    P = split(tiny_weights(11, state), "G")
    W.load_into(state.generator, P)
    g = torch.Generator().manual_seed(5)
    z, text = torch.randn(4, 32, generator=g), torch.randn(4, 32, generator=g)
    psi = torch.full((4,), 0.7)
    with torch.no_grad():
        out = state.generator(z, text, truncation_psi=psi)
        ref = ref_model.generator(P, TINY["train_config"]["generator"], z, text, psi=psi)
    scale = ref[0].abs().max()
    assert (out.image - ref[0]).abs().max() <= 1e-4 * scale
    for p, q in zip(out.routing, ref[3]):
        assert torch.equal(p, q)


def test_training_steps_match_port():
    from moegan_tpu_torch.train.state import create_train_state
    from moegan_tpu_torch.train.step import make_train_step

    cfg = port_config()
    state = create_train_state(cfg, device="cpu")
    weights = tiny_weights(12, state)
    G, D = split(weights, "G"), split(weights, "D")
    W.load_into(state.generator, G)
    W.load_into(state.discriminator, D)
    for t in (*G.values(), *D.values()):
        t.requires_grad_(True)
    step = make_train_step(cfg, steps_per_epoch=STEPS_PER_EPOCH)
    tc = TINY["train_config"]
    g_opt = ref_train.AdamW(G, tc["grad_clip_g"], tc, STEPS_PER_EPOCH)
    d_opt = ref_train.AdamW(D, tc["grad_clip_d"], tc, STEPS_PER_EPOCH)
    noise = W.NoiseStream(TINY, 4, 3, "cpu")
    rng = np.random.default_rng(0)
    schedule = {"temperature_factor": 3.0, "effective_kl_weight": 1e-3 * 1e-5}
    for _ in range(2):
        batch = {"image": torch.from_numpy(rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)),
                 "text": torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32))}
        n = noise.next()
        _, metrics = step(state, batch, schedule, noise=n)
        losses = ref_train.train_step(G, D, g_opt, d_opt, tc, batch, n, schedule)
        for k in ("d_total", "g_total"):
            assert float(metrics[k]) == pytest.approx(losses[k], rel=1e-4, abs=1e-5)
    for prefix, module, P in (("G", state.generator, G), ("D", state.discriminator, D)):
        for name, p in module.named_parameters():
            err = (p - P[name]).abs().max()
            assert err <= 1e-4 * max(P[name].abs().max(), 1e-3), f"{prefix}.{name}: {err}"
