"""Serving: model-container handler + HTTP control plane (counterpart of
moegan_tpu/infer/serving.py).

Same request/response schema and endpoints as the JAX package:
POST /generate {text, num_samples<=4, truncation_psi, seed?} -> {request_id};
GET /poll?request_id -> {status, data}; GET /metrics; GET /healthz. A
`MicroBatcher` coalesces up to 4 concurrent requests x 4 samples into one
generator call (batch 16; a lone request runs at batch 4).

`text` is a prompt string (encoded by the CLIP text tower, loaded at
startup: `CLIP_WEIGHTS_PATH`'s converted `.npz`, else the random init) or a
512-float embedding. The model directory holds the JAX package's
`aurora_model_final.msgpack` (or another `.msgpack` or `.npz` generator).

`calculate_fid` (forced on by POST /image-metrics, which caps
num_samples at 4) adds `fid_score`: the request's images against
`reference_stats.npz` in the working directory (μ=0, Σ=I when it is
missing), InceptionV3 features on the handler's device and a 2048-d scipy
`sqrtm` on the host (seconds a request).

Differences from the JAX package:
- z for a seed comes from a `torch.Generator`, not `jax.random`, so the
  same seed gives other images than the JAX server.
- PNGs are written with the standard library (`infer/png.py`).
- Everything runs on `device` ("cuda" by default; "cpu" only when asked).
"""

from __future__ import annotations

import base64
import collections
import itertools
import json
import os
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from moegan_tpu_torch.config import GeneratorConfig
from moegan_tpu_torch.infer.fid import FIDEvaluator
from moegan_tpu_torch.infer.png import encode_png
from moegan_tpu_torch.infer.sample import Sampler, expert_utilization_stats, is_string_prompt

MAX_NUM_SAMPLES = 4

_SEED_BASE = int.from_bytes(os.urandom(4), "little")
_SEED_COUNTER = itertools.count()


def next_default_seed() -> int:
    """Process-unique default seed (urandom base + atomic counter)."""
    return (_SEED_BASE + next(_SEED_COUNTER)) % (2**31)


def images_to_b64_pngs(images_m11) -> list[str]:
    """[-1, 1] NHWC float -> list of base64 PNG strings."""
    arr = np.asarray(torch.as_tensor(images_m11).float().cpu())
    arr = np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)
    return [base64.b64encode(encode_png(img)).decode("utf-8") for img in arr]


def find_model_file(model_dir: str) -> Optional[str]:
    """The saved model in model_dir, searched in the JAX package's order
    (moegan_tpu/infer/serving.py::find_model_file): `aurora_model_final.msgpack`
    at the top, then the first `.msgpack` or `.npz` of a top-down walk (files
    sorted within each directory), then an orbax step directory (`default` or
    all digits). The port reads `.msgpack` and `.npz`, not orbax directories
    (`utils.checkpoint.load_generator_params`)."""
    canonical = os.path.join(model_dir, "aurora_model_final.msgpack")
    if os.path.exists(canonical):
        return canonical
    for root, _, files in os.walk(model_dir):
        for f in sorted(files):
            if f.endswith((".msgpack", ".npz")):
                return os.path.join(root, f)
    for root, dirs, _ in os.walk(model_dir):
        for d in sorted(dirs):
            if d == "default" or d.isdigit():
                return os.path.join(root, d)
    return None


def seeded_z(seed: int, k: int, latent: int) -> np.ndarray:
    """[k, latent] standard normal from a CPU torch.Generator seeded with `seed`."""
    return torch.randn((k, latent), generator=torch.Generator().manual_seed(seed)).numpy()


class MicroBatcher:
    """Coalesces concurrent requests into one fixed-shape generator call.

    A dispatcher thread takes up to `slots` requests (waiting at most
    `max_wait_s` after the first) and runs them as one batch of
    slots * samples_per_req images, each request's z from its seed and a
    per-sample psi vector. Unused slots repeat slot 0 and are discarded. A
    lone request runs at its own batch (samples_per_req).
    """

    def __init__(self, sampler: Sampler, slots: int = 4,
                 samples_per_req: int = MAX_NUM_SAMPLES, max_wait_s: float = 0.01):
        self.sampler = sampler
        self.slots = slots
        self.k = samples_per_req
        self.max_wait = max_wait_s
        self.emb_dim = int(sampler.cfg.text_embedding_dim)
        self.dispatches = 0
        self.requests = 0
        self.dispatch_ms: collections.deque = collections.deque(maxlen=64)  # recent call times
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, text_emb, psi: float, seed: int):
        """Returns (event, box); box gets 'images'/'routing' or 'error' when event fires."""
        emb = np.asarray(text_emb, np.float32).reshape(-1)
        if emb.shape[0] != self.emb_dim:
            raise ValueError(f"text embedding must have {self.emb_dim} dims, got {emb.shape[0]}")
        ev = threading.Event()
        box: dict = {}
        self._q.put((emb, float(psi), int(seed), ev, box))
        return ev, box

    def close(self, timeout: float = 5.0) -> None:
        """Stop the dispatcher thread."""
        self._q.put(None)
        self._thread.join(timeout)

    def prewarm(self, timeout: float = 600.0):
        """Run both dispatch shapes (lone request, full batch) once before serving.

        The calls run on the dispatcher thread itself: PyTorch creates its
        cuBLAS/cuDNN handles per thread, so warming another thread would
        leave the first served calls to pay for them.
        """
        for S in sorted({1, self.slots}):
            ev = threading.Event()
            box: dict = {}
            self._q.put(("prewarm", S, ev, box))
            if not ev.wait(timeout):
                raise TimeoutError("prewarm did not finish")
            if "error" in box:
                raise RuntimeError(box["error"])

    def _warm(self, S: int) -> None:
        n, latent = S * self.k, int(self.sampler.cfg.latent_dim)
        self.sampler.sample_raw(np.zeros((n, latent), np.float32),
                                np.zeros((n, self.emb_dim), np.float32),
                                np.ones((n,), np.float32))

    def _loop(self):
        while True:
            first = self._q.get()
            if first is None:
                return
            if isinstance(first[0], str):  # ("prewarm", S, event, box), sent before traffic
                _, S, ev, box = first
                try:
                    self._warm(S)
                except Exception as e:  # reported to prewarm()
                    box["error"] = f"{type(e).__name__}: {e}"
                ev.set()
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            stop = False
            while len(batch) < self.slots:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    item = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                    break
                batch.append(item)
            try:
                self._run(batch)
            except Exception as e:  # report to every waiter, keep serving
                for *_, ev, box in batch:
                    box["error"] = f"{type(e).__name__}: {e}"
                    ev.set()
            if stop:
                return

    def _run(self, batch):
        R, k = len(batch), self.k
        latent = self.sampler.cfg.latent_dim
        S = self.slots if R > 1 else 1
        embs = np.zeros((S, self.emb_dim), np.float32)
        psis = np.ones((S,), np.float32)
        zs = np.zeros((S, k, latent), np.float32)
        for i, (emb, psi, seed, _, _) in enumerate(batch):
            embs[i], psis[i], zs[i] = emb, psi, seeded_z(seed, k, latent)
        for i in range(R, S):
            embs[i], zs[i] = embs[0], zs[0]
        t0 = time.perf_counter()
        images, routing = self.sampler.sample_raw(
            zs.reshape(S * k, latent), np.repeat(embs, k, axis=0), np.repeat(psis, k, axis=0))
        images = images.float().cpu().numpy()
        routing = tuple(p.float().cpu().numpy() for p in routing)
        self.dispatch_ms.append((time.perf_counter() - t0) * 1e3)
        self.dispatches += 1
        self.requests += R
        for i, (_, _, _, ev, box) in enumerate(batch):
            box["images"] = images[i * k:(i + 1) * k]
            box["routing"] = tuple(p[i * k:(i + 1) * k] for p in routing)
            ev.set()


class InferenceHandler:
    """MMS-style handler: transform_fn / handle with the reference's schema.

    Without a `batcher`, each request runs the sampler alone at
    MAX_NUM_SAMPLES and keeps its first num_samples images."""

    def __init__(self, sampler: Sampler, fid: Optional[FIDEvaluator] = None,
                 batcher: Optional[MicroBatcher] = None):
        self.sampler = sampler
        self.fid = fid
        self.batcher = batcher

    @classmethod
    def from_model_dir(cls, model_dir: str, cfg: Optional[GeneratorConfig] = None,
                       clip_params=None, batching: bool = True,
                       device="cuda") -> "InferenceHandler":
        """Load the generator under model_dir (architecture `cfg`, else from a
        `generator_config.json` beside it, else from the param shapes), the
        tower pack that encodes string prompts (`clip_params`, default the CLIP
        towers of `models.clip.load_clip_params`) and the FID evaluator
        (InceptionV3, `reference_stats.npz` read from the working directory)."""
        from moegan_tpu_torch.convert import jax_to_torch
        from moegan_tpu_torch.models.clip import load_clip_params
        from moegan_tpu_torch.utils.checkpoint import infer_generator_config, load_generator_params

        path = find_model_file(model_dir)
        if path is None:
            raise FileNotFoundError(f"no model artifact under {model_dir}")
        flat = load_generator_params(path)
        cfg_path = os.path.join(model_dir, "generator_config.json")
        if cfg is None and os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = GeneratorConfig.from_dict(json.load(f))
        elif cfg is None:
            cfg = infer_generator_config(flat)
        if clip_params is None:
            clip_params = load_clip_params(device=device)
        sampler = Sampler(cfg, jax_to_torch(flat), device=device, clip_params=clip_params)
        fid = FIDEvaluator(reference_stats_path="reference_stats.npz", device=sampler.device)
        return cls(sampler, fid, MicroBatcher(sampler) if batching else None)

    def close(self) -> None:
        if self.batcher is not None:
            self.batcher.close()

    def transform_fn(self, request: dict) -> dict:
        """{text (a prompt or a 512-float embedding), num_samples, truncation_psi,
        seed?, calculate_fid?} -> {images, prompt, expert_utilization, fid_score?}."""
        text = request.get("text", "")
        if text is None or (not isinstance(text, (list, tuple, np.ndarray)) and not text):
            raise ValueError("request must include 'text'")
        num_samples = min(int(request.get("num_samples", 1)), MAX_NUM_SAMPLES)
        psi = float(request.get("truncation_psi", 0.7))
        raw_seed = request.get("seed")
        seed = int(raw_seed) if raw_seed is not None else next_default_seed()

        string = is_string_prompt(text)
        emb = None if string else np.asarray(text, np.float32).reshape(-1)
        if self.batcher is not None:
            if string:  # a list of prompts serves its first, as in JAX
                emb = self.sampler.encode_text(text)[0].cpu().numpy()
            ev, box = self.batcher.submit(emb, psi, seed)
            if not ev.wait(timeout=120.0):
                raise TimeoutError("generation timed out in the batcher")
            if "error" in box:
                raise RuntimeError(box["error"])
            images = box["images"][:num_samples]
            stats = expert_utilization_stats(box["routing"])
        else:
            # one generator shape serves every request: MAX_NUM_SAMPLES, then slice
            images, stats = self.sampler(text if string else emb, MAX_NUM_SAMPLES, psi,
                                         seed=seed, return_stats=True)
            images = images[:num_samples].float().cpu().numpy()
        resp = {
            "images": images_to_b64_pngs(images),
            "prompt": text if string else emb.tolist(),
            "expert_utilization": stats,
        }
        if request.get("calculate_fid") and self.fid is not None:
            resp["fid_score"] = self.fid(images)
        return resp

    def handle(self, data, context=None):
        """MMS entry: list of {'body': bytes} -> list of JSON strings."""
        if data is None:
            return None
        out = []
        for item in data:
            body = item.get("body") if isinstance(item, dict) else item
            if isinstance(body, (bytes, bytearray)):
                body = body.decode("utf-8")
            req = json.loads(body) if isinstance(body, str) else body
            try:
                out.append(json.dumps(self.transform_fn(req)))
            except Exception as e:  # the container contract returns error JSON
                out.append(json.dumps({"error": str(e)}))
        return out


class JobStore:
    """In-memory job table: request_id -> {status, data, expiration_time}."""

    def __init__(self, ttl_seconds: float = 24 * 3600):
        self.ttl = ttl_seconds
        self._jobs: dict[str, dict] = {}
        self._lock = threading.Lock()

    def put(self, request_id: str, status: str, data=None):
        with self._lock:
            self._jobs[request_id] = {
                "request_id": request_id, "status": status, "data": data,
                "expiration_time": time.time() + self.ttl,
            }

    def get(self, request_id: str) -> Optional[dict]:
        with self._lock:
            job = self._jobs.get(request_id)
            if job and job["expiration_time"] < time.time():
                del self._jobs[request_id]
                return None
            return job

    def sweep(self):
        now = time.time()
        with self._lock:
            for k in [k for k, v in self._jobs.items() if v["expiration_time"] < now]:
                del self._jobs[k]


def make_server(handler: InferenceHandler, *, metrics: Optional[dict] = None,
                host: str = "127.0.0.1", port: int = 8080) -> ThreadingHTTPServer:
    """HTTP server with the JAX package's public API; `port=0` picks a free port."""
    store = JobStore()
    model_metrics = metrics or {}
    stop_sweeper = threading.Event()

    def sweeper():
        while not stop_sweeper.wait(min(store.ttl / 4, 60.0)):
            store.sweep()

    def run_job(request_id: str, payload: dict):
        try:
            store.put(request_id, "PROCESSING")
            store.put(request_id, "COMPLETED", handler.transform_fn(payload))
        except Exception as e:  # the job fails; the server keeps serving
            store.put(request_id, "FAILED", {"error": f"{type(e).__name__}: {e}"})

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

        def do_OPTIONS(self):
            self.send_response(200)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "GET,POST,OPTIONS")
            self.send_header("Access-Control-Allow-Headers", "Content-Type")
            self.end_headers()

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._send(400, {"error": "invalid JSON body"})
            store.sweep()
            if self.path in ("/generate", "/image-metrics"):
                if not payload.get("text"):
                    return self._send(400, {"error": "missing 'text'"})
                if self.path == "/image-metrics":
                    payload = {**payload, "calculate_fid": True, "num_samples": min(
                        int(payload.get("num_samples", MAX_NUM_SAMPLES)), MAX_NUM_SAMPLES)}
                rid = str(uuid.uuid4())
                store.put(rid, "INITIALIZING")
                threading.Thread(target=run_job, args=(rid, payload), daemon=True).start()
                return self._send(202, {"request_id": rid})
            return self._send(404, {"error": f"unknown path {self.path}"})

        def do_GET(self):
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            if url.path == "/poll":
                rid = parse_qs(url.query).get("request_id", [None])[0]
                if not rid:
                    return self._send(400, {"error": "missing request_id"})
                job = store.get(rid)
                if job is None:
                    return self._send(404, {"status": "NOT_FOUND"})
                return self._send(200, {"status": job["status"], "data": job["data"]})
            if url.path == "/metrics":
                return self._send(200, model_metrics)
            if url.path == "/healthz":
                return self._send(200, {"status": "ok"})
            return self._send(404, {"error": f"unknown path {url.path}"})

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=sweeper, daemon=True).start()
    orig_shutdown = server.shutdown

    def shutdown():
        stop_sweeper.set()
        orig_shutdown()

    server.shutdown = shutdown
    server.job_store = store
    return server


def serve(model_dir: str, host: str = "127.0.0.1", port: int = 8080, metrics=None,
          device="cuda"):
    handler = InferenceHandler.from_model_dir(model_dir, device=device)
    print("prewarming dispatch shapes (lone request, full batch)...")
    handler.batcher.prewarm()
    server = make_server(handler, metrics=metrics, host=host, port=port)
    print(f"serving on http://{host}:{server.server_address[1]} ({handler.sampler.device})")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        handler.close()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Serve the port's generator over HTTP.")
    ap.add_argument("--model-dir", default=os.environ.get("SM_MODEL_DIR", "./model"))
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    serve(args.model_dir, args.host, args.port, device=args.device)
