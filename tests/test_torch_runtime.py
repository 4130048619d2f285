"""The port's runtime pieces against the JAX package, on the CPU.

The native gathers (the port's own g++ build of its copy of the batcher)
byte-equal to numpy and to JAX `data/native.py`, and `BatchLoader` through
them; the profiling helpers; the loss exports with `r1_penalty` and
`expert_utilization`; `count_params`; `shard_batch`. No JAX jit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moegan_tpu.losses as jlosses
from moegan_tpu.config import DiscriminatorConfig as JaxDiscriminatorConfig
from moegan_tpu.config import GeneratorConfig as JaxGeneratorConfig
from moegan_tpu.data import native as jnative
from moegan_tpu.data.datasets import synthetic_dataset as jax_synthetic_dataset
from moegan_tpu.data.loader import BatchLoader as JaxBatchLoader
from moegan_tpu.losses import gan as jgan
from moegan_tpu.models.discriminator import AuroraDiscriminator as JaxDiscriminator
from moegan_tpu.models.generator import AuroraGenerator as JaxGenerator
from moegan_tpu.parallel.api import shard_batch as jax_shard_batch
from moegan_tpu.train.state import count_params as jax_count_params
import moegan_tpu_torch.losses as tlosses
from moegan_tpu_torch.config import DiscriminatorConfig, GeneratorConfig
from moegan_tpu_torch.data import native
from moegan_tpu_torch.data.datasets import synthetic_dataset
from moegan_tpu_torch.data.loader import BatchLoader
from moegan_tpu_torch.losses import gan as tgan
from moegan_tpu_torch.models.discriminator import AuroraDiscriminator
from moegan_tpu_torch.models.generator import AuroraGenerator
from moegan_tpu_torch.ops._build import BUILD_DIR
from moegan_tpu_torch.parallel.api import shard_batch
from moegan_tpu_torch.parallel.mesh import Mesh
from moegan_tpu_torch.train.state import count_params
from moegan_tpu_torch.utils import profiling
from tests.torch_helpers import TINY_KW, jax_variables, randn, t

MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def test_gathers_are_byte_equal_to_numpy_and_jax():
    rng = np.random.default_rng(0)
    src = np.clip(rng.normal(size=(40, 12, 10, 3)), -1, 1).astype(np.float32)
    idx = rng.integers(-40, 40, size=17)
    flip = rng.random(17) < 0.5
    want = src[idx]
    rows = native.gather_rows(src, idx)
    assert rows.tobytes() == want.tobytes()
    assert rows.tobytes() == jnative.gather_rows(src, idx % 40).tobytes()
    flipped = want.copy()
    flipped[flip] = flipped[flip][:, :, ::-1]
    got = native.gather_images(src, idx, flip)
    assert got.tobytes() == flipped.tobytes()
    assert got.tobytes() == jnative.gather_images(src, idx % 40, flip.astype(np.uint8)).tobytes()
    assert native.gather_images(src, idx).tobytes() == want.tobytes()
    norm = native.gather_normalize(src, idx, MEAN, STD)
    assert norm.tobytes() == (((want + 1.0) * 0.5 - MEAN) / STD).astype(np.float32).tobytes()
    assert norm.tobytes() == jnative.gather_normalize(src, idx % 40, MEAN, STD).tobytes()
    # the library is the port's own build, not the JAX package's native/libbatcher.so
    assert native.library_path().parent == BUILD_DIR and native.library_path().exists()
    for bad in (np.asarray([40]), np.asarray([-41])):
        with pytest.raises(IndexError):
            native.gather_rows(src, bad)


def test_memory_mapped_source_is_read_in_place(tmp_path):
    a = np.random.default_rng(1).normal(size=(64, 8, 8, 3)).astype(np.float32)
    np.save(tmp_path / "split.npy", a)
    mm = np.load(tmp_path / "split.npy", mmap_mode="r")
    assert np.shares_memory(np.ascontiguousarray(mm, np.float32), mm)  # a view, no copy
    idx = np.asarray([63, 0, 5, 5])
    assert native.gather_rows(mm, idx).tobytes() == a[idx].tobytes()


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "batcher.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native batcher build failed"):
        native.gather_rows(np.zeros((2, 3), np.float32), np.asarray([1]))
    assert not any((tmp_path / "build").glob("*.so"))  # no library, no half-written file


def test_batch_loader_matches_jax_loader(monkeypatch):
    ds, jds = synthetic_dataset(40, 8, seed=2), jax_synthetic_dataset(40, 8, seed=2)
    assert ds.images.tobytes() == jds.images.tobytes()
    loader, jloader = BatchLoader(ds, 8, seed=5), JaxBatchLoader(jds, 8, seed=5)
    assert loader.steps_per_epoch == jloader.steps_per_epoch == 5
    for epoch in (0, 1):
        got, want = list(loader.epoch(epoch)), list(jloader.epoch(epoch))
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            for k in ("image", "text"):
                assert a[k].dtype == np.float32 and a[k].tobytes() == b[k].tobytes()

    def broken(src, idx):
        raise RuntimeError("gather failed")

    monkeypatch.setattr(native, "gather_rows", broken)
    with pytest.raises(RuntimeError, match="gather failed"):  # not an empty epoch
        list(loader.epoch(2))


def test_profiling_helpers(tmp_path, monkeypatch):
    stats = profiling.device_memory_stats()
    assert stats and all(set(s) == {"device", "bytes_in_use", "peak_bytes_in_use",
                                    "bytes_limit"} for s in stats)
    mon = profiling.MemoryMonitor(limit_fraction=0.9)
    assert mon.limit_fraction == 0.9 and mon.peak == 0 and mon.step(3) is None
    assert mon.step(0) == stats and mon.peak == 0  # no card: one CPU entry, no bytes
    # the monitor's arithmetic, on stats a card would report
    fake = [{"device": "cuda:0", "bytes_in_use": 95, "peak_bytes_in_use": 97, "bytes_limit": 100}]
    monkeypatch.setattr(profiling, "device_memory_stats", lambda: fake)
    mon = profiling.MemoryMonitor(interval=2, limit_fraction=0.9, device="cuda")
    assert mon.step(4) == fake and mon.peak == 97
    with profiling.trace(str(tmp_path / "trace")) as logdir:
        torch.ones(8, 8) @ torch.ones(8, 8)
    pid = os.getpid()
    assert sorted(os.listdir(logdir)) == [f"spans_{pid}.json", f"trace_{pid}.json"]
    assert json.load(open(os.path.join(logdir, f"trace_{pid}.json")))["traceEvents"]
    assert set(json.load(open(os.path.join(logdir, f"spans_{pid}.json")))) == {
        "spans", "counters", "dropped"}
    was = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    try:
        profiling.enable_debug_mode(nans=True)
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        x = torch.zeros(3, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (x * torch.sqrt(-torch.ones(3))).sum().backward()  # NaN gradient in the backward
    finally:
        torch.autograd.set_detect_anomaly(*was)


def test_loss_exports_match_jax():
    assert tlosses.__all__ == jlosses.__all__ and len(tlosses.__all__) == 7
    for name in tlosses.__all__:
        assert callable(getattr(tlosses, name))
    probs = [randn(1, 2, 5, 4), np.asarray(jax.nn.softmax(randn(2, 3, 7, 4) * 3.0, -1))]
    np.testing.assert_allclose(tgan.expert_utilization([t(p) for p in probs]).numpy(),
                               np.asarray(jgan.expert_utilization(probs)), rtol=1e-6)
    # r1_penalty through the discriminator, against JAX's nested grad
    d = AuroraDiscriminator(DiscriminatorConfig(max_resolution=16, compute_dtype="float32"),
                            gen=torch.Generator().manual_seed(3))
    jd = JaxDiscriminator(JaxDiscriminatorConfig(max_resolution=16, compute_dtype="float32"))
    variables = jax_variables(d)
    img, txt = np.tanh(randn(4, 3, 16, 16, 3)), randn(5, 3, 512)
    want = jlosses.r1_penalty(lambda x: jd.apply(variables, x, txt), jnp.asarray(img), 10.0)
    got = tlosses.r1_penalty(lambda x: d(x, t(txt)), t(img), 10.0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4)
    grads = torch.autograd.grad(got, list(d.parameters()), allow_unused=True)
    assert any(g is not None and bool(g.abs().sum() > 0) for g in grads)  # reaches D's weights


def test_count_params_matches_jax():
    g = AuroraGenerator(GeneratorConfig(compute_dtype="float32", **TINY_KW))
    d = AuroraDiscriminator(DiscriminatorConfig(max_resolution=16, compute_dtype="float32"))
    jg = JaxGenerator(JaxGeneratorConfig(compute_dtype="float32", **TINY_KW))
    jd = JaxDiscriminator(JaxDiscriminatorConfig(max_resolution=16, compute_dtype="float32"))
    key = jax.random.PRNGKey(0)
    g_shapes = jax.eval_shape(lambda: jg.init(key, jnp.zeros((1, 512)), jnp.zeros((1, 512)),
                                              training=False))["params"]
    d_shapes = jax.eval_shape(lambda: jd.init(key, jnp.zeros((1, 16, 16, 3)),
                                              jnp.zeros((1, 512))))["params"]
    assert count_params(g) == jax_count_params(g_shapes)
    assert count_params(d) == jax_count_params(d_shapes)


def test_shard_batch_matches_jax_data_shards():
    batch = {"image": randn(6, 4, 2, 2, 3), "text": randn(7, 4, 5)}
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "expert"))
    placed = jax_shard_batch(batch, mesh)
    for rank in (0, 1):
        local = shard_batch(batch, Mesh(shape=(2, 1), rank=rank, data_group=None,
                                        expert_group=None))
        assert shard_batch(local, None) is local  # an already-sharded batch passes through
        for k, v in placed.items():
            shard = [s for s in v.addressable_shards if s.index[0].start == 2 * rank]
            np.testing.assert_array_equal(local[k].numpy(), np.asarray(shard[0].data))
