"""The port's layer spans and counters (`moegan_tpu_torch.utils.profiling`), on the CPU.

Off (no profiler session) a span is the shared no-op and records nothing;
under `torch.profiler` a tiny training step records exactly the span tree
of `train/step.py`, the generator and the discriminator, each span also a
user annotation of the kineto trace on the same clock; the loader's gather
span runs on its worker thread; the step's numbers do not depend on the
profiler; the batcher's queue wait reaches /metrics.
"""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from moegan_tpu_torch.config import DiscriminatorConfig, GeneratorConfig, TrainConfig
from moegan_tpu_torch.data.datasets import ImageTextDataset
from moegan_tpu_torch.data.loader import BatchLoader, prefetch_to_device
from moegan_tpu_torch.infer import serving
from moegan_tpu_torch.infer.sample import Sampler
from moegan_tpu_torch.models.generator import AuroraGenerator
from moegan_tpu_torch.train.state import create_train_state
from moegan_tpu_torch.train.step import draw_noise, make_train_step
from moegan_tpu_torch.utils import profiling
from tests.torch_helpers import TINY_KW

B = 4
SCHED = {"temperature_factor": 2.5, "effective_kl_weight": 1e-3}
CFG = TrainConfig(generator=GeneratorConfig(compute_dtype="float32", **TINY_KW),
                  discriminator=DiscriminatorConfig(max_resolution=16, compute_dtype="float32"),
                  steps_per_epoch=20, batch_size=B)

STEP_CHILDREN = ["moegan.step.d_phase", "moegan.step.d_adamw", "moegan.step.g_phase",
                 "moegan.step.g_adamw", "moegan.step.metrics"]
D_PHASE = ["moegan.d", "moegan.step.r1", "moegan.g", "moegan.d", "moegan.d",
           "moegan.step.d_backward"]
G_PHASE = ["moegan.g", "moegan.d", "moegan.step.g_backward"]
G_CHILDREN = ["moegan.g.mapping", "moegan.g.r4", "moegan.g.r8", "moegan.g.r16"]


def _block(r):
    parts = (["upsample"] if r > 4 else []) + ["conv", "self_attn", "cross_attn", "moe"]
    parts += ["to_rgb"] if r >= CFG.generator.rgb_min_resolution else []
    return [f"moegan.g.r{r}.{p}" for p in parts]


@pytest.fixture
def recorder():
    profiling.reset()
    yield profiling.RECORDER
    profiling.reset()


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": torch.as_tensor(rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)),
            "text": torch.as_tensor(rng.standard_normal((B, 512)).astype(np.float32))}


def _state_and_step():
    state = create_train_state(CFG, device="cpu", seed=1)
    return state, make_train_step(CFG, steps_per_epoch=20)


def _noise(state, seed):
    return draw_noise(state.generator, B, torch.Generator().manual_seed(seed))


def _profiled(fn, *args):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return prof, out


def _children(records, parent):
    return [r.name for r in records if r.parent is parent]


def test_profiler_flag_is_the_plain_bool_torch_keeps():
    """The recorder's switch is torch's own Python flag: a torch that drops or
    renames it fails here, not silently."""
    assert isinstance(torch.autograd.profiler._is_profiler_enabled, bool)
    assert not profiling.profiler_on() and not torch.autograd.profiler._is_profiler_enabled
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert profiling.profiler_on() is True
    assert not profiling.profiler_on()


def test_off_span_is_the_shared_noop_and_records_nothing(recorder, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function entered for {name} with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert profiling.span("moegan.x") is profiling.span("moegan.y", device=False)
    with profiling.span("moegan.x") as held:
        assert held is None
    state, step = _state_and_step()
    step(state, _batch(0), SCHED, noise=_noise(state, 0))
    assert recorder.records == [] and recorder.dropped == 0
    assert profiling.summary()["spans"] == {}


def test_training_step_records_the_span_tree(recorder):
    state, step = _state_and_step()

    def two_steps():
        for i in range(2):
            step(state, _batch(i), SCHED, noise=_noise(state, i))

    _profiled(step, state, _batch(9), SCHED, _noise(state, 9))  # the profiler's first calls
    profiling.reset()
    prof, _ = _profiled(two_steps)
    records = list(recorder.records)
    assert all(r.t1 is not None and r.events is None for r in records)  # closed; no card
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == ["moegan.step"] * 2
    assert len({r.root for r in roots}) == 2
    for root in roots:
        tree = [r for r in records if r.root == root.root]
        assert _children(tree, root) == STEP_CHILDREN
        phase = {r.name: r for r in tree if r.parent is root}
        assert _children(tree, phase["moegan.step.d_phase"]) == D_PHASE
        assert _children(tree, phase["moegan.step.g_phase"]) == G_PHASE
        gens = [r for r in tree if r.name == "moegan.g"]
        assert [g.parent.name for g in gens] == ["moegan.step.d_phase", "moegan.step.g_phase"]
        for g in gens:
            assert _children(tree, g) == G_CHILDREN
            for r in (4, 8, 16):
                (block,) = [x for x in tree if x.parent is g and x.name == f"moegan.g.r{r}"]
                assert _children(tree, block) == _block(r)
        for leaf in ("moegan.step.r1", "moegan.step.d_backward", "moegan.step.g_backward"):
            (node,) = [r for r in tree if r.name == leaf]
            assert _children(tree, node) == []
    assert len(records) == 2 * (1 + 5 + 3 + 4 + 2 * (2 + 3 + 4 + 6 + 6))
    assert {r.thread for r in records} == {threading.get_ident()}

    # the same spans are the kineto trace's user annotations, on the same clock
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("moegan.") and e.is_user_annotation()]
    assert sorted(e.name() for e in events) == sorted(r.name for r in records)
    by_name: dict = {}
    for e in sorted(events, key=lambda e: e.start_ns()):
        by_name.setdefault(e.name(), []).append(e)
    for name, evs in by_name.items():
        recs = sorted((r for r in records if r.name == name), key=lambda r: r.t0)
        for e, r in zip(evs, recs):
            assert abs(e.start_ns() - r.t0) < 100_000, name
            assert abs(e.start_ns() + e.duration_ns() - r.t1) < 100_000, name

    s = profiling.summary()["spans"]
    assert s["moegan.step"]["count"] == 2 and s["moegan.g.r8.upsample"]["count"] == 4
    assert s["moegan.d"]["count"] == 8 and s["moegan.step"]["device_ms"] is None
    assert s["moegan.step"]["host_ms"] >= s["moegan.step.g_phase"]["host_ms"] > 0


def test_summary_self_time_is_the_span_less_its_children():
    rec = profiling.SpanRecorder()

    def add(name, parent, t0, t1, device_ms):
        r = profiling._Span(rec, name)
        r.parent, r.root = parent, parent.root if parent else 1
        r.t0, r.t1, r.device_ms = t0, t1, device_ms
        rec.records.append(r)
        return r

    root = add("a", None, 0, 10_000_000, 10.0)
    b = add("a.b", root, 1_000_000, 4_000_000, 3.0)
    add("a.c", root, 5_000_000, 9_000_000, 4.0)
    add("a.b.d", b, 1_500_000, 2_000_000, 0.5)
    root2 = add("a", None, 20_000_000, 22_000_000, 2.0)
    add("a.c", root2, 20_500_000, 21_000_000, 1.5)
    s = rec.summary()["spans"]
    assert s["a"] == {"count": 2, "host_ms": 12.0, "device_ms": 12.0,
                      "self_device_ms": pytest.approx(10.0 - 7.0 + 2.0 - 1.5)}
    assert s["a.b"]["self_device_ms"] == pytest.approx(2.5)
    assert s["a.c"]["device_ms"] == 5.5 and s["a.c"]["self_device_ms"] == 5.5
    assert s["a.b.d"]["host_ms"] == pytest.approx(0.5)


def test_records_are_capped_and_drops_counted(recorder, monkeypatch):
    rec = profiling.SpanRecorder(cap=3)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(5):
            with profiling.span("moegan.x"):
                pass
    assert len(rec.records) == 3 and rec.dropped == 2
    assert rec.summary()["spans"]["moegan.x"]["count"] == 3
    rec.reset()
    assert rec.records == [] and rec.dropped == 0


def test_loader_spans_run_on_their_threads(recorder):
    rng = np.random.default_rng(0)
    ds = ImageTextDataset(rng.random((12, 4, 4, 3), dtype=np.float32),
                          rng.random((12, 8), dtype=np.float32))
    loader = BatchLoader(ds, 3, seed=0)

    def drain():
        return list(prefetch_to_device(loader.epoch(0), "cpu"))

    _, batches = _profiled(drain)
    assert len(batches) == 4
    threads = {}
    for r in recorder.records:
        threads.setdefault(r.name, set()).add(r.thread)
    me = threading.get_ident()
    assert threads["moegan.loader.wait"] == threads["moegan.loader.to_device"] == {me}
    assert me not in threads["moegan.loader.gather"]
    s = profiling.summary()["spans"]
    assert s["moegan.loader.gather"]["count"] == 4 and s["moegan.loader.to_device"]["count"] == 4
    assert s["moegan.loader.wait"]["count"] == 5  # four batches and the end of the epoch
    assert all(r.parent is None for r in recorder.records)


def test_step_numbers_do_not_depend_on_the_profiler(recorder):
    out = []
    for on in (False, True):
        state, step = _state_and_step()
        run = (lambda f, *a: _profiled(f, *a)[1]) if on else (lambda f, *a: f(*a))
        metrics = [run(step, state, _batch(i), SCHED, _noise(state, i))[1] for i in range(2)]
        params = [p.detach().clone() for p in list(state.generator.parameters())
                  + list(state.discriminator.parameters())]
        out.append((metrics, params))
    (m0, p0), (m1, p1) = out
    for a, b in zip(m0, m1):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert profiling.summary()["spans"]["moegan.step"]["count"] == 2


def test_sample_raw_is_a_root_over_the_generator(recorder):
    gcfg = GeneratorConfig(compute_dtype="float32", **TINY_KW)
    sampler = Sampler(gcfg, AuroraGenerator(gcfg).state_dict(), device="cpu")
    z = np.zeros((2, gcfg.latent_dim), np.float32)
    _profiled(sampler.sample_raw, z, np.ones((2, 512), np.float32), np.full(2, 0.7, np.float32))
    roots = [r for r in recorder.records if r.parent is None]
    assert [r.name for r in roots] == ["moegan.sample"]
    assert _children(recorder.records, roots[0]) == ["moegan.g"]
    assert {r.root for r in recorder.records} == {roots[0].root}


def test_batcher_queue_wait_reaches_metrics(recorder):
    gcfg = GeneratorConfig(compute_dtype="float32", **TINY_KW)
    sampler = Sampler(gcfg, AuroraGenerator(gcfg).state_dict(), device="cpu")
    batcher = serving.MicroBatcher(sampler, max_wait_s=0.05)
    handler = serving.InferenceHandler(sampler, fid=None, batcher=batcher)
    server = serving.make_server(handler, metrics={"fid": 1.5}, host="127.0.0.1", port=0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        emb = np.ones(512, np.float32)
        waits = [batcher.submit(emb, 0.7, seed) for seed in range(3)]
        for ev, box in waits:
            assert ev.wait(60.0) and "images" in box
        url = f"http://127.0.0.1:{server.server_address[1]}/metrics"
        with urllib.request.urlopen(url, timeout=30) as r:
            got = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        th.join(10)
        batcher.close()
    assert not th.is_alive()
    assert got["fid"] == 1.5
    stats = got["batcher"]
    assert stats["requests"] == 3 and 1 <= stats["dispatches"] <= 3
    assert stats["dispatches"] == batcher.dispatches and len(batcher.dispatch_ms) >= 1
    assert 0 <= stats["queue_wait_ms_p50"] <= stats["queue_wait_ms_p95"] < 60_000
    assert 0 < stats["dispatch_ms_p50"] <= stats["dispatch_ms_p95"]
    counters = profiling.summary()["counters"]
    assert counters["serve.requests"] == 3
    assert counters["serve.queue_wait_s"] == pytest.approx(sum(batcher.queue_wait_ms) * 1e-3)
    assert recorder.records == []  # no profiler session: counters only


def test_trace_writes_the_span_summary(tmp_path, recorder):
    state, step = _state_and_step()
    with profiling.trace(str(tmp_path)) as logdir:
        step(state, _batch(0), SCHED, noise=_noise(state, 0))
    spans = json.loads((tmp_path / f"spans_{os.getpid()}.json").read_text())
    assert logdir == str(tmp_path)
    assert spans["spans"]["moegan.step"]["count"] == 1 and spans["dropped"] == 0
    assert spans["spans"]["moegan.g.r16.upsample"]["count"] == 2
