"""The port's distributed path on the CPU over gloo: the (data x expert) mesh,
the expert-sharded SparseMoE against the JAX package's (`core/moe.py::
_fused_sharded` on a two-device expert mesh), the distributed training step
against the port's single-process step, and the training loop.

The ranks are processes spawned with a target in `tests/torch_dist_helpers.py`
(torch and the port only). float32 on both sides throughout.
"""

import numpy as np
import pytest
import torch
from flax import linen as fnn

import jax
import jax.numpy as jnp
from moegan_tpu.core.moe import SparseMoE as JaxSparseMoE
from moegan_tpu.core.router import reparameterize
from moegan_tpu_torch.config import DiscriminatorConfig, GeneratorConfig, MeshConfig, TrainConfig
from moegan_tpu_torch.convert import torch_to_jax
from moegan_tpu_torch.core.moe import SparseMoE
from moegan_tpu_torch.parallel.api import expert_parallelism
from moegan_tpu_torch.parallel.mesh import auto_expert_parallelism, mesh_groups
from moegan_tpu_torch.parallel.sharding import param_sharding_rules
from moegan_tpu_torch.train.state import create_train_state
from moegan_tpu_torch.train.step import draw_noise, make_train_step
from tests import torch_dist_helpers as dh
from tests.torch_helpers import TINY_KW, decisive_router, jax_variables, randn, t

# --- the mesh ------------------------------------------------------------------------------


def test_mesh_layouts():
    # rank r at (r // ep, r % ep), as np.asarray(devices).reshape(n // ep, ep)
    assert mesh_groups(4, 2) == ([[0, 2], [1, 3]], [[0, 1], [2, 3]])
    assert mesh_groups(2, 2) == ([[0], [1]], [[0, 1]])
    assert mesh_groups(2, 1) == ([[0, 1]], [[0], [1]])
    assert mesh_groups(8, 4) == ([[0, 4], [1, 5], [2, 6], [3, 7]],
                                 [[0, 1, 2, 3], [4, 5, 6, 7]])
    with pytest.raises(ValueError):
        mesh_groups(6, 4)
    assert [auto_expert_parallelism(n, 4) for n in (1, 2, 3, 4, 6, 8)] == [1, 2, 1, 4, 2, 4]
    cfg = TrainConfig()
    assert expert_parallelism(cfg, 8) == 1  # the default: pure data parallelism
    assert expert_parallelism(cfg.replace(mesh=MeshConfig(expert_parallelism=0)), 8) == 4
    with pytest.raises(ValueError):
        expert_parallelism(cfg.replace(mesh=MeshConfig(expert_parallelism=3)), 6)
    assert param_sharding_rules("gen_block_4.attn_block.moe.w1") == "expert"
    assert param_sharding_rules("gen_block_4.attn_block.moe.router.feature_mu") is None
    assert param_sharding_rules("mapping_0.weight") is None


# --- the expert-sharded SparseMoE against JAX ----------------------------------------------

MOE_ARGS = (16, 20, 4, 8)  # dim, text_dim, experts, router hidden
ANNEAL = 2.5
KL_WEIGHT = 0.01


def _jax_sharded(variables, x, w, eps, dout, dprobs):
    """JAX SparseMoE(use_pallas=True) under a (data 1 x expert 2) mesh of two CPU
    devices: the eval forward, and the training forward with its gradients, in
    one jit. The router noise is the test's, through `intercept_methods`."""
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("data", "expert"))
    m = JaxSparseMoE(*MOE_ARGS, compute_dtype=jnp.float32, use_pallas=True)

    def intercept(next_fun, args, kwargs, context):
        sampling = args[0] if args else kwargs.get("sampling", False)
        if context.method_name != "sample_weights" or not sampling:
            return next_fun(*args, **kwargs)
        r = context.module
        pairs = ((r.feature_mu, r.feature_rho), (r.text_mu, r.text_rho),
                 (r.combined_mu, r.combined_rho))
        return tuple(reparameterize(mu, rho, jnp.asarray(e)) for (mu, rho), e in zip(pairs, eps))

    def run(params, x, w):
        evaluated = m.apply({"params": params}, x, w, training=False)

        def loss(params, x, w):
            out, kl, probs = m.apply({"params": params}, x, w, training=True,
                                     annealing_factor=ANNEAL)
            return jnp.sum(out * dout) + jnp.sum(probs * dprobs) + KL_WEIGHT * kl, (out, kl, probs)

        (_, trained), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            params, x, w)
        return evaluated, trained, grads

    with fnn.intercept_methods(intercept), jax.sharding.set_mesh(mesh):
        assert m.bind(variables)._expert_mesh() is not None  # the sharded path is taken
        return jax.jit(run)(variables["params"], x, w)


@pytest.fixture(scope="module")
def sharded_moe():
    gen = torch.Generator().manual_seed(11)
    m = decisive_router(SparseMoE(*MOE_ARGS, compute_dtype=torch.float32, gen=gen))
    x, w = randn(20, 2, 37, 16), randn(21, 2, 20)
    eps = tuple(randn(22 + i, *p.shape) for i, p in enumerate(m.router.mean_weights()))
    dout, dprobs = randn(26, 2, 37, 16), randn(27, 2, 37, 4)
    want = _jax_sharded(jax_variables(m), x, w, eps, dout, dprobs)
    state = {k: v.numpy() for k, v in m.state_dict().items()}
    got = dh.spawn("sharded_moe", 2, module_args=MOE_ARGS, state_dict=state, x=x, w=w, eps=eps,
                   annealing=ANNEAL, dout=dout, dprobs=dprobs, kl_weight=KL_WEIGHT)
    return got, want


def test_sharded_moe_eval_matches_jax(sharded_moe):
    got, ((out, kl, probs), _, _) = sharded_moe
    for g in got:  # both ranks hold the combined output and the full probs
        np.testing.assert_array_equal(g["eval_probs"], np.asarray(probs))  # one-hot, argmax
        np.testing.assert_allclose(g["eval_out"], np.asarray(out), rtol=1e-5, atol=1e-6)
        assert float(g["eval_kl"]) == float(kl) == 0.0


def test_sharded_moe_training_matches_jax(sharded_moe):
    got, (_, (out, kl, probs), _) = sharded_moe
    for g in got:
        # float32 routing and FFN, summed in other orders (the two ranks'
        # partials against the two devices' psum)
        np.testing.assert_allclose(g["train_probs"], np.asarray(probs), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(g["train_out"], np.asarray(out), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["train_kl"], np.asarray(kl), rtol=1e-6)


def test_sharded_moe_gradients_match_jax(sharded_moe):
    got, (_, _, (dparams, dx, dw)) = sharded_moe
    want = {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(dparams)[0]}
    for g in got:  # the replicated gradients agree on both ranks (the ExpertEnter sums)
        grads = torch_to_jax({k: torch.from_numpy(v) for k, v in g["grads"].items()})
        assert set(grads) == set(want)
        # float32 through the router, the FFN and the KL, in other summation
        # orders: 1e-4 of each tensor's largest |gradient|
        for k, v in want.items():
            np.testing.assert_allclose(grads[k], v, rtol=0, atol=1e-4 * np.abs(v).max(),
                                       err_msg=k)
        np.testing.assert_allclose(g["dx"], np.asarray(dx), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(dx)).max())
        np.testing.assert_allclose(g["dw"], np.asarray(dw), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(dw)).max())


# --- the distributed step against the single-process step ----------------------------------

B = 4
SCHED = {"temperature_factor": 2.5, "effective_kl_weight": 1e-3}
CFG = TrainConfig(generator=GeneratorConfig(compute_dtype="float32", **TINY_KW),
                  discriminator=DiscriminatorConfig(max_resolution=16, compute_dtype="float32"),
                  steps_per_epoch=20, lr=1e-3, batch_size=B)
SEED = 3


@pytest.fixture(scope="module")
def single_steps():
    """Three steps of the port's single-process step on fixed batches and noise."""
    state = create_train_state(CFG, device="cpu", seed=SEED)
    batches = [{"image": t(np.tanh(randn(30 + i, B, 16, 16, 3))), "text": t(randn(40 + i, B, 512))}
               for i in range(3)]
    noises = [draw_noise(state.generator, B, torch.Generator().manual_seed(50 + i))
              for i in range(3)]
    step = make_train_step(CFG)
    metrics, moments = [], None
    for batch, noise in zip(batches, noises):
        state, m = step(state, batch, SCHED, noise=noise)
        metrics.append({k: v.numpy() for k, v in m.items()})
        moments = moments or dh.first_moments(state)
    return dict(batches=batches, noises=noises, metrics=metrics, moments=moments,
                params=dh.full_state(state))


@pytest.mark.parametrize("layout", [(1, 2), (2, 1)], ids=["data1xexpert2", "data2xexpert1"])
def test_distributed_step_matches_single_process(single_steps, layout):
    dp, ep = layout
    cfg = CFG.replace(mesh=MeshConfig(expert_parallelism=ep))
    ranks = dh.spawn("train_steps", dp * ep, cfg_dict=cfg.to_dict(), seed=SEED,
                     batches=single_steps["batches"], noises=single_steps["noises"],
                     schedule=SCHED)
    for r, got in enumerate(ranks):
        assert got["mesh"] == ((dp, ep), r // ep, r % ep)
        # The first step's gradients (Adam's first moment is 0.1 x the clipped
        # gradient): float32, other summation orders.
        for net in ("g", "d"):
            want = single_steps["moments"][net]
            assert set(got["moments"][net]) == set(want)
            for k, v in want.items():
                np.testing.assert_allclose(got["moments"][net][k], v, rtol=1e-4, atol=1e-6,
                                           err_msg=f"rank {r} {net} {k}")
        for i, (m, w) in enumerate(zip(got["metrics"], single_steps["metrics"])):
            assert set(m) == set(w)
            for k, v in w.items():
                np.testing.assert_allclose(m[k], v, rtol=1e-4, atol=1e-6,
                                           err_msg=f"rank {r} step {i + 1} {k}")
    for net in ("g", "d"):  # every rank holds the same whole parameters
        for k, v in ranks[0]["params"][net].items():
            for other in ranks[1:]:
                np.testing.assert_array_equal(other["params"][net][k], v)


# --- the training loop ---------------------------------------------------------------------

LOOP_CFG = CFG.replace(num_epochs=2, log_interval=1, mesh=MeshConfig(expert_parallelism=2))


def test_loop_distributed_matches_single_process():
    """train_aurora_gan on 4 ranks (data 2 x expert 2) against one process: 8
    training samples (2 steps of batch 4 an epoch), 3 validation samples. The
    callback stops after the first epoch. The single process validates at
    batch 3, the distributed loop at 2, the largest multiple of its 2 data ranks."""
    ranks = dh.spawn("train_loop", 4, cfg_dict=LOOP_CFG.to_dict(), n_train=8, n_val=3,
                     stop_after_epoch=0)
    state, log, seen = dh.run_loop(LOOP_CFG.to_dict(), 8, 3, 0, distributed=False)
    single = dh.full_state(state)
    assert state.step == 2 and len(seen) == 1 and "Early stopping" in log.lines[-1]
    assert any("validating with batch_size=3" in line for line in log.lines)
    want_members = [{"data": [0, 2], "expert": [0, 1]}, {"data": [1, 3], "expert": [0, 1]},
                    {"data": [0, 2], "expert": [2, 3]}, {"data": [1, 3], "expert": [2, 3]}]
    for r, got in enumerate(ranks):
        assert got["mesh"]["shape"] == (2, 2)
        assert (got["mesh"]["data_index"], got["mesh"]["expert_index"]) == divmod(r, 2)
        assert got["mesh"]["members"] == want_members[r]
        assert got["steps"] == 2 and [e for e, _ in got["seen"]] == [0]
        assert set(got["seen"][0][1]) == {"val_d_loss", "val_g_loss"}
        assert "Early stopping triggered by metric callback" in got["lines"]
        assert any("validating with batch_size=2" in line for line in got["lines"])
        # Two Adam steps from the same state, batches and noise. At the first
        # steps Adam's direction is about sign(g), which float32 summation
        # order moves where |g| is near its 1e-8 epsilon: within 1e-2 of the
        # learning rate, for all but 0.1 % of any tensor's elements.
        lr = CFG.lr
        for net in ("g", "d"):
            assert set(got["params"][net]) == set(single[net])
            for k, v in single[net].items():
                off = np.abs(got["params"][net][k] - v) > 1e-2 * lr
                assert off.mean() <= 1e-3, (r, net, k, off.mean())


# --- the data pipeline and the metric lines -----------------------------------------------


def test_data_pipeline_and_metric_lines_match_jax(capsys):
    from moegan_tpu.data.datasets import synthetic_dataset as jax_synthetic
    from moegan_tpu.data.loader import BatchLoader as JaxBatchLoader
    from moegan_tpu.utils.metrics import MetricLogger as JaxMetricLogger
    from moegan_tpu_torch.data.datasets import synthetic_dataset
    from moegan_tpu_torch.data.loader import BatchLoader, prefetch_to_device
    from moegan_tpu_torch.parallel.mesh import Mesh
    from moegan_tpu_torch.parallel.sharding import ShardedBatch
    from moegan_tpu_torch.utils.metrics import MetricLogger

    ds, jds = synthetic_dataset(10, 8, seed=4), jax_synthetic(10, 8, seed=4)
    np.testing.assert_array_equal(ds.images, jds.images)
    np.testing.assert_array_equal(ds.text_embeddings, jds.text_embeddings)
    ours, theirs = BatchLoader(ds, 4, seed=7), JaxBatchLoader(jds, 4, seed=7)
    assert ours.steps_per_epoch == theirs.steps_per_epoch == 2
    for epoch in (0, 1):  # the same shuffle each epoch, the last partial batch dropped
        got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["text"], b["text"])
    # this rank's slice of every batch: data coordinate 1 of 2
    mesh = Mesh((2, 1), 1, None, None)
    batches = list(prefetch_to_device(ours.epoch(0), "cpu", mesh=mesh))
    assert len(batches) == 2 and all(isinstance(b, ShardedBatch) for b in batches)
    for a, b in zip(batches, theirs.epoch(0)):
        np.testing.assert_array_equal(a["image"].numpy(), b["image"][2:])

    for logger in (MetricLogger(), JaxMetricLogger()):
        logger.log_metric("val_g_loss", 1.2345678)
    out = capsys.readouterr().out.splitlines()
    assert out == ["[METRIC] val_g_loss: 1.234568"] * 2
