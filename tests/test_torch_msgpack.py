"""The port's msgpack codec (`moegan_tpu_torch/utils/msgpack.py`) against flax's
`msgpack_serialize` / `msgpack_restore`, and generator files written by one
package and read or served by the other."""

import base64

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from moegan_tpu.config import GeneratorConfig as JaxGeneratorConfig
from moegan_tpu.infer.sample import Sampler as JaxSampler
from moegan_tpu.utils.checkpoint import load_generator_params as jax_load_params
from moegan_tpu.utils.checkpoint import save_generator_params as jax_save_params
from moegan_tpu_torch.config import GeneratorConfig
from moegan_tpu_torch.convert import torch_to_jax
from moegan_tpu_torch.infer import serving
from moegan_tpu_torch.infer.png import decode_png
from moegan_tpu_torch.models.generator import AuroraGenerator
from moegan_tpu_torch.utils import msgpack
from moegan_tpu_torch.models.toy_clip import as_tower_pack, init_toy_params
from moegan_tpu_torch.utils.checkpoint import load_generator_params, save_generator_params
from tests.torch_helpers import TINY_KW, decisive_router, jax_variables, randn, unflatten


def _tree():
    rng = np.random.default_rng(0)
    return {
        "dense": {"kernel": rng.standard_normal((3, 5)).astype(np.float32),
                  "bias": np.zeros((5,), np.float32)},
        "ids": np.arange(-7, 5, dtype=np.int32).reshape(3, 4),
        "mask": rng.integers(0, 2, (2, 3)).astype(bool),
        "empty": np.zeros((0, 4), np.float64),
        "scalar_array": np.asarray(2.5, np.float32),
        "np_scalar": np.float32(1.25),
        "ints": [0, 1, -1, -32, -33, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -2 ** 40, 2 ** 63],
        "float": 0.1, "flag": True, "off": False, "none": None,
        "name": "generator", "long_name": "x" * 40, "blob": b"\x00\x01\xff" * 100,
        "many": {str(i): i for i in range(20)},
    }


def _assert_same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert isinstance(b, type(a)) and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def test_round_trip_and_flax_agree():
    tree = _tree()
    ours = msgpack.packb(tree)
    sorted_tree = _sorted(tree)  # flax's tree_map orders a dict's keys
    _assert_same(msgpack.unpackb(ours), tree)
    # flax reads what the port writes, and the port reads what flax writes
    theirs = serialization.msgpack_serialize(tree)
    _assert_same(serialization.msgpack_restore(ours), tree)
    _assert_same(msgpack.unpackb(theirs), tree)
    assert msgpack.packb(sorted_tree) == theirs  # the same encoder choices, byte for byte


def _sorted(tree):
    return {k: _sorted(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


def test_chunked_arrays_and_errors(monkeypatch):
    big = np.arange(1000, dtype=np.float32).reshape(10, 100)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_BYTES", 1024)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1024)
    ours = msgpack.packb({"big": big})
    np.testing.assert_array_equal(serialization.msgpack_restore(ours)["big"], big)
    np.testing.assert_array_equal(
        msgpack.unpackb(serialization.msgpack_serialize({"big": big}))["big"], big)
    # a dtype numpy lacks raises with its name; so does an unknown extension type
    bf16 = serialization.msgpack_serialize({"w": np.zeros((2,), jnp.bfloat16)})
    with pytest.raises(ValueError, match="bfloat16"):
        msgpack.unpackb(bf16)
    with pytest.raises(ValueError, match="extension type 5"):
        msgpack.unpackb(b"\xd4\x05\x00")
    with pytest.raises(ValueError, match="truncated"):
        msgpack.unpackb(ours[:-3])


@pytest.fixture(scope="module")
def tiny_generator():
    g = decisive_router(AuroraGenerator(GeneratorConfig(compute_dtype="float32", **TINY_KW),
                                        gen=torch.Generator().manual_seed(5)))
    return g.state_dict()


@pytest.mark.parametrize("wrapped", [True, False], ids=["wrapped", "bare"])
def test_generator_msgpack_crosses_packages(tmp_path, tiny_generator, wrapped):
    want = torch_to_jax(tiny_generator)
    # the port writes, the JAX package reads
    save_generator_params(str(tmp_path / "ours.msgpack"), tiny_generator, wrapped=wrapped)
    theirs = jax_load_params(str(tmp_path / "ours.msgpack"))
    flat = {"/".join(k): v for k, v in _flatten(theirs)}
    assert set(flat) == set(want)
    for k, v in want.items():
        assert flat[k].dtype == v.dtype
        np.testing.assert_array_equal(flat[k], v)
    # the JAX package writes, the port reads
    jax_save_params(str(tmp_path / "theirs.msgpack"), unflatten(want), wrapped=wrapped)
    got = load_generator_params(str(tmp_path / "theirs.msgpack"))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_flax_written_model_is_served_by_the_port(tmp_path, tiny_generator):
    """aurora_model_final.msgpack written by the JAX package, served by the port's
    handler on the CPU, against the JAX sampler on the same z: at most one
    quantisation step apart (float32 on both sides)."""
    params = jax_variables(_module(tiny_generator))["params"]
    jax_save_params(str(tmp_path / "aurora_model_final.msgpack"), params)
    jcfg = JaxGeneratorConfig(use_pallas=True, compute_dtype="float32", **TINY_KW)
    (tmp_path / "generator_config.json").write_text(jcfg.to_json())
    emb = randn(300, 512)
    handler = serving.InferenceHandler.from_model_dir(str(tmp_path), device="cpu",
                                                      clip_params=as_tower_pack(init_toy_params()))
    try:
        resp = handler.transform_fn({"text": emb.tolist(), "num_samples": 4,
                                     "truncation_psi": 0.6, "seed": 9})
    finally:
        handler.close()
    got = np.stack([decode_png(base64.b64decode(s)) for s in resp["images"]])
    images, _ = JaxSampler(jcfg, params).sample_raw(
        serving.seeded_z(9, 4, 512), np.repeat(emb[None], 4, 0), np.full((4,), 0.6, np.float32))
    want = np.clip((np.asarray(images) + 1.0) * 127.5, 0, 255).astype(np.uint8)
    assert got.shape == (4, 16, 16, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _module(sd):
    g = AuroraGenerator(GeneratorConfig(compute_dtype="float32", **TINY_KW))
    g.load_state_dict(sd)
    return g
