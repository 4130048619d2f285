"""The port's serving stack on the CPU, against the JAX package's sampler.

A tiny generator is written with the JAX package's `save_generator_params`
(the `.npz` layout) and its `GeneratorConfig.to_json()`, then served by
`moegan_tpu_torch.infer.serving` with device="cpu" (string prompts through the
random-init CLIP text tower that `from_model_dir` loads).
"""

import base64
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from moegan_tpu.config import GeneratorConfig as JaxGeneratorConfig
from moegan_tpu.infer.sample import Sampler as JaxSampler
from moegan_tpu.utils.checkpoint import infer_generator_config as jax_infer_config
from moegan_tpu.utils.checkpoint import load_generator_params as jax_load_params
from moegan_tpu.utils.checkpoint import save_generator_params
from moegan_tpu_torch.config import GeneratorConfig
from moegan_tpu_torch.convert import torch_to_jax
from moegan_tpu_torch.infer import serving
from moegan_tpu_torch.infer.png import decode_png, encode_png
from moegan_tpu_torch.models.generator import AuroraGenerator
from moegan_tpu_torch.utils.checkpoint import infer_generator_config, load_generator_params
from moegan_tpu_torch.utils.checkpoint import save_generator_params as port_save_params
from tests.torch_helpers import TINY_KW, decisive_router, jax_variables, randn

EMB = randn(200, 512)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("model")
    g = decisive_router(AuroraGenerator(GeneratorConfig(compute_dtype="float32", **TINY_KW),
                                        gen=torch.Generator().manual_seed(3)))
    params = jax_variables(g)["params"]
    save_generator_params(str(d / "gen.npz"), params)
    jcfg = JaxGeneratorConfig(use_pallas=True, compute_dtype="float32", **TINY_KW)
    (d / "generator_config.json").write_text(jcfg.to_json())
    return d, jcfg, params


@pytest.fixture(scope="module")
def handler(model_dir):
    h = serving.InferenceHandler.from_model_dir(str(model_dir[0]), device="cpu")
    yield h
    h.close()


def _pixels(b64_pngs):
    return np.stack([decode_png(base64.b64decode(s)) for s in b64_pngs])


def test_served_pixels_match_jax_sampler(model_dir, handler):
    _, jcfg, params = model_dir
    resp = handler.transform_fn({"text": EMB.tolist(), "num_samples": 4,
                                 "truncation_psi": 0.6, "seed": 7})
    got = _pixels(resp["images"])
    z = serving.seeded_z(7, 4, 512)  # the port's z; jax.random would give others
    images, _ = JaxSampler(jcfg, params).sample_raw(
        z, np.repeat(EMB[None], 4, 0), np.full((4,), 0.6, np.float32))
    want = np.clip((np.asarray(images) + 1.0) * 127.5, 0, 255).astype(np.uint8)
    assert got.shape == (4, 16, 16, 3)
    # float32 on both sides: at most one quantisation step apart.
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert set(resp["expert_utilization"]) == {"block_0", "block_1", "block_2"}


def test_batcher_coalesces_and_matches_unbatched(handler):
    b = serving.MicroBatcher(handler.sampler, slots=4, max_wait_s=0.5)
    try:
        seeds, psis = [11, 22, 33, 44], [0.5, 0.7, 0.9, 1.0]
        boxes = [None] * 4

        def go(i):
            boxes[i] = b.submit(EMB, psis[i], seeds[i])

        threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(10)
        for ev, _ in boxes:
            assert ev.wait(60)
        assert b.dispatches == 1 and b.requests == 4
        for i, (_, box) in enumerate(boxes):
            want, _ = handler.sampler.sample_raw(
                serving.seeded_z(seeds[i], 4, 512), np.repeat(EMB[None], 4, 0),
                np.full((4,), psis[i], np.float32))
            # batch 16 vs batch 4: the CPU's float32 kernels sum in
            # batch-dependent orders, ~1e-5 on values of magnitude 1.
            np.testing.assert_allclose(box["images"], want.numpy(), atol=1e-4)
    finally:
        b.close()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _poll(base, rid, timeout=60.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        with urllib.request.urlopen(f"{base}/poll?request_id={rid}", timeout=30) as r:
            job = json.loads(r.read())
        if job["status"] in ("COMPLETED", "FAILED"):
            return job
        time.sleep(0.05)
    raise TimeoutError(rid)


def test_http_round_trip_and_missing_slices(handler, tmp_path):
    # /image-metrics through an evaluator of 8 pixel columns (the handler's own
    # holds InceptionV3 and a 2048-d sqrtm, seconds on the CPU)
    fid = serving.FIDEvaluator(
        lambda x: np.asarray(x, np.float32).reshape(len(x), -1)[:, :8], feature_dim=8)
    fid.load_reference_stats(str(tmp_path / "reference_stats.npz"))  # missing: mu=0, Sigma=I
    inception_fid, handler.fid = handler.fid, fid
    server = serving.make_server(handler, host="127.0.0.1", port=0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        job = _poll(base, _post(f"{base}/generate", {"text": EMB.tolist(), "num_samples": 2})["request_id"])
        assert job["status"] == "COMPLETED"
        assert _pixels(job["data"]["images"]).shape == (2, 16, 16, 3)
        job = _poll(base, _post(f"{base}/generate", {"text": "a red bird", "num_samples": 3,
                                                     "seed": 4})["request_id"])
        assert job["status"] == "COMPLETED" and job["data"]["prompt"] == "a red bird"
        # the prompt's embedding is the CLIP text tower's, served as an embedding would be
        emb = handler.sampler.encode_text("a red bird")[0].numpy()
        assert emb.shape == (512,) and np.isfinite(emb).all()
        direct = handler.transform_fn({"text": emb.tolist(), "num_samples": 3, "seed": 4})
        assert job["data"]["images"] == direct["images"]
        rid = _post(f"{base}/image-metrics", {"text": EMB.tolist(), "num_samples": 9,
                                              "seed": 4})["request_id"]
        job = _poll(base, rid)
        assert job["status"] == "COMPLETED", job["data"]
        assert len(job["data"]["images"]) == 4  # capped at MAX_NUM_SAMPLES
        assert np.isfinite(job["data"]["fid_score"]) and job["data"]["fid_score"] > 0
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}
    finally:
        handler.fid = inception_fid
        server.shutdown()
        server.server_close()
        th.join(10)
    assert not th.is_alive()


def test_png_round_trips_with_pil():
    img = np.random.default_rng(0).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(encode_png(img)))), img)
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)
    buf = io.BytesIO()  # PIL picks its own scanline filters
    Image.fromarray(img).save(buf, format="PNG")
    np.testing.assert_array_equal(decode_png(buf.getvalue()), img)


def test_checkpoint_config_and_lookup(model_dir, tmp_path):
    d, jcfg, params = model_dir
    flat = load_generator_params(str(d / "gen.npz"))
    want = jax_infer_config(params).to_dict()
    got = infer_generator_config(flat).to_dict()
    assert {k: v for k, v in want.items() if k in got} == got
    cfg = GeneratorConfig.from_dict(json.loads(jcfg.to_json()))  # JAX-only keys skipped
    assert cfg == GeneratorConfig(compute_dtype="float32", **TINY_KW)
    assert serving.find_model_file(str(d)) == str(d / "gen.npz")
    (tmp_path / "m.msgpack").write_bytes(b"")  # msgpack is read now: an empty file is cut short
    with pytest.raises(ValueError, match="truncated"):
        load_generator_params(serving.find_model_file(str(tmp_path)))


@pytest.mark.parametrize("layout", [
    # the canonical msgpack beside an unrelated .npz deeper in the tree
    {"aurora_model_final.msgpack": "", "sub/reference_stats.npz": ""},
    # msgpack only, in a subdirectory, beside files that are no model
    {"generator_config.json": "{}", "ckpt/b.msgpack": "", "ckpt/a.msgpack": "", "ckpt/x.txt": ""},
    # an orbax step directory and no file the search takes
    {"notes.txt": "", "ckpts/12/state": "", "ckpts/7/state": ""},
])
def test_find_model_file_matches_jax(tmp_path, layout):
    """The port searches a model directory in the JAX package's order."""
    from moegan_tpu.infer.serving import find_model_file as jax_find_model_file

    for rel, text in layout.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(text)
    want = jax_find_model_file(str(tmp_path))
    got = serving.find_model_file(str(tmp_path))
    assert want is not None and os.path.relpath(got, tmp_path) == os.path.relpath(want, tmp_path)
    if os.path.isdir(got):
        with pytest.raises(NotImplementedError, match="orbax"):  # not read by the port
            load_generator_params(got)
    elif got.endswith(".msgpack"):
        with pytest.raises(ValueError, match="truncated"):  # read, and found empty
            load_generator_params(got)


def test_save_npz_reads_back_in_both_packages(tmp_path):
    sd = AuroraGenerator(GeneratorConfig(**TINY_KW)).state_dict()
    port_save_params(str(tmp_path / "g.npz"), sd)
    want = torch_to_jax(sd)
    theirs = jax_load_params(str(tmp_path / "g.npz"))  # unwraps `generator/`
    for k, v in want.items():
        node = theirs
        for part in k.split("/"):
            node = node[part]
        np.testing.assert_array_equal(np.asarray(node), v)
    ours = load_generator_params(str(tmp_path / "g.npz"))
    assert set(ours) == set(want)


def test_port_imports_no_jax():
    """Every module of the port (the training, distributed, evaluation and
    MLOps slices' included), chip_smoke.py, the port's profile scripts and the
    helper module that the distributed tests spawn their ranks from import
    with jax, flax, optax, msgpack, orbax, moegan_tpu, PIL and matplotlib
    blocked (the card's machine has neither PIL nor matplotlib)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'orbax', 'moegan_tpu', 'PIL',\n"
        "          'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import moegan_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'moegan_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "sys.path.insert(0, 'scripts')\n"
        "import chip_smoke, torch_mma_ex2_rates, torch_serving_profile, torch_train_profile\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_dist_helpers\n"
        "print(' '.join(names))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 66
    assert {"moegan_tpu_torch.models.discriminator", "moegan_tpu_torch.losses.gan",
            "moegan_tpu_torch.train.schedules", "moegan_tpu_torch.train.state",
            "moegan_tpu_torch.train.step"} <= names
    assert {"moegan_tpu_torch.parallel.api", "moegan_tpu_torch.parallel.mesh",
            "moegan_tpu_torch.parallel.sharding", "moegan_tpu_torch.train.loop",
            "moegan_tpu_torch.data.datasets", "moegan_tpu_torch.data.loader",
            "moegan_tpu_torch.utils.metrics", "moegan_tpu_torch.utils.profiling"} <= names
    assert {"moegan_tpu_torch.utils.msgpack", "moegan_tpu_torch.utils.checkpoint",
            "moegan_tpu_torch.models.bpe", "moegan_tpu_torch.models.clip",
            "moegan_tpu_torch.models.toy_clip", "moegan_tpu_torch.losses.clip_loss",
            "moegan_tpu_torch.cli.train_model"} <= names
    assert {"moegan_tpu_torch.models.inception", "moegan_tpu_torch.infer.fid",
            "moegan_tpu_torch.infer.evaluate", "moegan_tpu_torch.cli.evaluate",
            "moegan_tpu_torch.cli.generate_images"} <= names
    assert {"moegan_tpu_torch.data.augment", "moegan_tpu_torch.data.pipeline",
            "moegan_tpu_torch.cli.process_data", "moegan_tpu_torch.cli.tune",
            "moegan_tpu_torch.cli.job_train", "moegan_tpu_torch.hpo.search",
            "moegan_tpu_torch.orchestration.flags", "moegan_tpu_torch.orchestration.jobs",
            "moegan_tpu_torch.orchestration.pipeline"} <= names


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA the smoke exits non-zero and prints no result line, in the
    repository and in a directory that holds nothing else of it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run in full")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(os.path.join(root, "chip_smoke.py"), "rb").read())
    for cwd, script in ((root, "chip_smoke.py"), (str(tmp_path), str(lone))):
        out = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
