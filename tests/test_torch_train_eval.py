"""The port's validation step against the JAX package's (`train/step.py::
make_eval_step`, with_clip=False) at a tiny configuration, float32 on both
sides: the same weights (carried across with `convert.py`), batch, z and
text shuffle (from the JAX step's own `jax.random.split(rng)`).

The generator routes hard at eval; the routers' combined_mu is scaled so
that no token's top two experts lie within rounding (`ROUTER_SCALE`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from moegan_tpu.config import DiscriminatorConfig as JaxDiscriminatorConfig
from moegan_tpu.config import GeneratorConfig as JaxGeneratorConfig
from moegan_tpu.config import TrainConfig as JaxTrainConfig
from moegan_tpu.train.state import TrainState as JaxTrainState
from moegan_tpu.train.step import make_eval_step as jax_make_eval_step
from moegan_tpu_torch.config import TrainConfig
from moegan_tpu_torch.convert import torch_to_jax
from moegan_tpu_torch.train.state import create_train_state
from moegan_tpu_torch.train.step import make_eval_step
from tests.torch_helpers import TINY_KW, decisive_router, randn, t, unflatten

B = 4
JAX_CFG = JaxTrainConfig(
    generator=JaxGeneratorConfig(use_pallas=True, compute_dtype="float32", **TINY_KW),
    discriminator=JaxDiscriminatorConfig(max_resolution=16, compute_dtype="float32"),
)


@pytest.fixture(scope="module")
def both():
    cfg = TrainConfig.from_dict(JAX_CFG.to_dict())
    state = create_train_state(cfg, device="cpu", seed=5)
    decisive_router(state.generator)
    batch = {"image": np.tanh(randn(60, B, 16, 16, 3)), "text": randn(61, B, 512)}
    sched = {"temperature_factor": 2.5, "effective_kl_weight": 1e-3}
    rng = jax.random.PRNGKey(9)
    k_z, k_shuffle = jax.random.split(rng)
    noise = {"z": t(jax.random.normal(k_z, (B, 512), jnp.float32)),
             "perm": torch.from_numpy(np.array(jax.random.permutation(k_shuffle, B))).long()}
    got = make_eval_step(cfg)(state, {k: t(v) for k, v in batch.items()}, sched, noise=noise)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           g_params=unflatten(torch_to_jax(state.generator.state_dict())),
                           d_params=unflatten(torch_to_jax(state.discriminator.state_dict())),
                           g_opt_state=None, d_opt_state=None)
    want = jax_make_eval_step(JAX_CFG, with_clip=False)(
        jstate, batch, rng, {k: jnp.float32(v) for k, v in sched.items()})
    return got, want


@pytest.mark.parametrize("name", ["val_d_loss", "val_g_loss"])
def test_eval_step_matches_jax(both, name):
    got, want = both
    assert set(got) == set(want)
    # float32 through a hard-routed generator and three D passes, summed in
    # other orders
    np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-5, atol=1e-7)
