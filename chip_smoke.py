#!/usr/bin/env python3
"""Drive the PyTorch port's 64x64 serving path on one NVIDIA GPU and check it.

Run from the repository root: `python3 chip_smoke.py`. It needs one CUDA
device and nvcc (it builds the port's kernels from `moegan_tpu_torch/ops/csrc`).
It imports nothing of JAX or of the JAX package. Phases, each fatal on
failure (non-zero exit, no result line):

1. the card's name and power limit; build both CUDA kernels;
2. each kernel against its plain PyTorch version on the card, in bf16, at
   every shape the serving path gives it at batch 16, with times (CUDA
   events) for the kernel, the plain version and, for attention,
   `F.scaled_dot_product_attention` as a yardstick;
3. the served slice: the default 64x64 generator built from a seed, written
   as `.npz` + `generator_config.json`, loaded by the port's
   `InferenceHandler`, served over HTTP on 127.0.0.1; one lone /generate
   (a batch-4 call) then 4 concurrent ones (one batch-16 call), every PNG
   decoded and checked; the kernels' launch counts are read around this
   phase alone;
4. the whole generator on the card (kernels, bf16) against the same weights
   and inputs on the CPU (plain versions, float32).

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

SEED = 0
N = 16  # the micro-batcher's full batch: 4 requests x 4 samples
# Router means are N(0, 0.01) at init, so a random model's routing logits
# differ by ~1e-3 and bf16 noise decides many tokens' top-1 expert. Scaling
# combined_mu makes most decisions clear of that noise, so phase 4 compares
# the same routing on the card and the CPU.
ROUTER_SCALE = 100.0
# The HTTP clients' /poll interval (the bundled frontend polls every 3 s).
POLL_S = 0.02
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after two warm-up calls (CUDA events)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# --- phase 2: kernels against their plain versions -------------------------------------


def flash_phase(dev, tfa):
    """The three self-attention shapes (res 16/32/64) at batch N."""
    import torch.nn.functional as F

    rows = []
    g = torch.Generator(device=dev).manual_seed(SEED)
    for res, H, D in ((16, 8, 16), (32, 2, 32), (64, 1, 32)):
        T = res * res
        y = torch.randn((N, T, 3 * H * D), generator=g, device=dev).to(torch.bfloat16)
        q, k, v = (y[..., i * H * D:(i + 1) * H * D].unflatten(-1, (H, D)) for i in range(3))
        o, lse = tfa.flash_attention(q, k, v, with_lse=True)
        o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, with_lse=True)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        o_max = o_ref.float().abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        # o is a softmax average of N(0, 1) values over T keys (std ~sqrt(e/T));
        # its largest |o| is ~0.4-1.7 at these shapes. The limit is a few
        # bf16 ulps of that (2^-8 relative is 0.5-1 ulp): the final rounding
        # of o, plus p rounded to bf16 against the running max (kernel) or the
        # row max (plain).
        tol = 4 * 2.0 ** -8 * o_max
        check(err <= tol, f"flash res {res}: max |o - plain| {err} > {tol} (max |o| {o_max})")
        # lse in base-2 units, fp32. l sums p rounded to bf16 against
        # different maxima; those roundings (each <= 2^-9 relative) mostly
        # cancel over T terms.
        check(lse_err <= 1e-3, f"flash res {res}: max |lse - plain| {lse_err} > 1e-3")
        o2 = tfa.flash_attention(q, k, v)
        check(torch.equal(o, o2), f"flash res {res}: the no-lse call differs from the lse call")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = time_ms(lambda: tfa.flash_attention(q, k, v), 20)
        plain_ms = time_ms(lambda: tfa.flash_attention_reference(q, k, v), 5)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
        flops = 4.0 * N * H * T * T * D
        nbytes = 4.0 * N * T * H * D * 2  # q, k, v read once, o written once, bf16
        b_ms, b_by = bound_ms(flops, nbytes)
        rows.append(dict(res=res, B=N, T=T, H=H, D=D, max_abs_err=err, max_abs_ref=o_max,
                         tol=tol, lse_max_abs_err=lse_err,
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms, flops=flops, bytes=nbytes,
                         exps=float(N * H * T * T), bound_ms=b_ms, bound_by=b_by))
        print("flash_attention_fwd " + json.dumps(rows[-1]), flush=True)
    return rows


def moe_args(dev, C, T, hidden=128, E=4, ties=0, seed=0):
    """Serving-shaped MoE inputs: weights at the init scales, router scaled as the model's."""
    g = torch.Generator(device=dev).manual_seed(seed)
    F_ = 4 * C

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def ru(*shape, bound):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * bound

    x = rn(T, C)
    tl = rn(T, E, scale=0.05)
    if ties:  # x = 0 and equal text logits for experts 0 and 1: an exact tie
        x[:ties] = 0.0
        tl[:ties] = torch.tensor([1.0, 1.0, 0.0, 0.0], device=dev)
    return [
        x.to(torch.bfloat16), rn(C, hidden, scale=0.01).to(torch.bfloat16),
        rn(hidden, E, scale=0.01 * ROUTER_SCALE), tl,
        torch.full((1,), 0.25, device=dev),
        ru(E, C, F_, bound=C ** -0.5).to(torch.bfloat16), ru(E, F_, bound=C ** -0.5),
        ru(E, F_, C, bound=F_ ** -0.5).to(torch.bfloat16), ru(E, C, bound=F_ ** -0.5),
    ]


def moe_compare(tfm, args, hard, label):
    out, p = tfm.fused_moe_ffn(*args, hard=hard)
    out_ref, p_ref = tfm.moe_ffn_reference(*args, hard=hard)
    out2, p2 = tfm.fused_moe_ffn(*args, hard=hard)
    torch.cuda.synchronize()
    # The split partial sums are added in a fixed order: the same inputs give the same bits.
    check(torch.equal(out, out2) and torch.equal(p, p2), f"moe {label}: two calls differ")
    if hard:
        # Tokens whose top two soft probabilities are within fp32 noise may
        # pick either expert; both answers are right, so they are left out.
        soft = tfm.routing_probs(((args[0].float() @ args[1].float()) @ args[2] + args[3])
                                 * args[4], hard=False)
        top2 = soft.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-5
        clear |= (p_ref == 0.5).any(-1)  # forced exact ties must match exactly
    else:
        clear = torch.ones(out.shape[0], dtype=torch.bool, device=out.device)
    excluded = int((~clear).sum().item())
    check(excluded <= max(2, out.shape[0] // 1000), f"moe {label}: {excluded} near-tie tokens")
    p_err = (p - p_ref)[clear].abs().max().item()
    err = (out.float() - out_ref.float())[clear].abs().max().item()
    scale = out_ref.float().abs().max().item()
    check(p_err <= 1e-5, f"moe {label}: max |probs - plain| {p_err} > 1e-5")
    # A few bf16 ulps of the largest |out| (2^-8 relative is 0.5-1 ulp): the
    # final rounding of out plus, under soft routing, the kernel's bf16
    # rounding of p*h before the second product (2^-9 relative per term).
    tol = 4 * 2.0 ** -8 * scale
    check(err <= tol, f"moe {label}: max |out - plain| {err} > {tol} (max |out| {scale})")
    return err, p_err, excluded, p, scale


def moe_phase(dev, tfm):
    """The five MoE blocks at batch N, hard (served) and soft, plus a batch with forced ties."""
    rows = []
    for res, C in ((4, 512), (8, 256), (16, 128), (32, 64), (64, 32)):
        T = N * res * res
        args = moe_args(dev, C, T, seed=res)
        err_h, perr_h, excl, p, scale = moe_compare(tfm, args, True, f"res {res} hard")
        err_s, perr_s, _, _, _ = moe_compare(tfm, args, False, f"res {res} soft")
        ms = time_ms(lambda: tfm.fused_moe_ffn(*args, hard=True), 10)
        plain_ms = time_ms(lambda: tfm.moe_ffn_reference(*args, hard=True), 3)
        E, F_, h = 4, 4 * C, args[1].shape[1]
        # Work this data needs under hard routing: each token's selected
        # expert(s) only, plus the router; weights of experts that any token uses.
        selections = float((p > 0).sum().item())
        used = int((p > 0).any(0).sum().item())
        flops = selections * 4.0 * C * F_ + 2.0 * T * C * h + 2.0 * T * h * E
        nbytes = (T * C * 2 * 2 + T * E * 4 * 2 + C * h * 2 + h * E * 4
                  + used * (2 * C * F_ * 2 + (F_ + C) * 4))
        b_ms, b_by = bound_ms(flops, nbytes)
        rows.append(dict(res=res, T=T, C=C, F=F_, E=E, max_abs_err=max(err_h, err_s),
                         hard_err=err_h, soft_err=err_s, max_abs_ref=scale,
                         probs_err=max(perr_h, perr_s),
                         near_tie_tokens_excluded=excl, ms=ms, plain_ms=plain_ms, flops=flops,
                         dense_flops=4.0 * T * C * F_ * E, bytes=float(nbytes), bound_ms=b_ms,
                         bound_by=b_by, plan=list(tfm.kernel_plan(T, C, F_, E, dev))))
        print("fused_moe_fwd " + json.dumps(rows[-1]), flush=True)
    args = moe_args(dev, 256, 1000, ties=37, seed=99)  # ragged T, forced ties
    err, _, _, p, _ = moe_compare(tfm, args, True, "forced ties")
    check(torch.equal(p[:37], torch.tensor([[0.5, 0.5, 0.0, 0.0]], device=dev).expand(37, 4)),
          "moe forced ties: tied rows are not split evenly")
    print(f"fused_moe_fwd forced-ties T=1000 C=256 max_abs_err={err}", flush=True)
    return rows


# --- phase 3: the served slice ------------------------------------------------------------


def build_model_dir(path):
    from moegan_tpu_torch.config import GeneratorConfig
    from moegan_tpu_torch.convert import save_npz
    from moegan_tpu_torch.models.generator import AuroraGenerator

    cfg = GeneratorConfig()
    gen = AuroraGenerator(cfg, gen=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("combined_mu"):
                p.mul_(ROUTER_SCALE)
    save_npz(os.path.join(path, "generator.npz"), gen.state_dict())
    with open(os.path.join(path, "generator_config.json"), "w") as f:
        f.write(cfg.to_json())
    return cfg, gen.state_dict()


def http_json(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def request_once(base, emb, seed, out, i):
    t0 = time.perf_counter()
    rid = http_json(f"{base}/generate", {"text": emb.tolist(), "num_samples": 4,
                                         "truncation_psi": 0.7, "seed": seed})["request_id"]
    while True:
        job = http_json(f"{base}/poll?request_id={rid}")
        if job["status"] in ("COMPLETED", "FAILED"):
            break
        if time.perf_counter() - t0 > 300:
            job = {"status": "TIMEOUT", "data": None}
            break
        time.sleep(POLL_S)
    out[i] = (job, (time.perf_counter() - t0) * 1e3)


def serve_phase(model_path, tfa, tfm):
    from moegan_tpu_torch.infer.png import decode_png
    from moegan_tpu_torch.infer.serving import InferenceHandler, make_server

    handler = InferenceHandler.from_model_dir(model_path, device="cuda")
    handler.batcher.prewarm()
    server = make_server(handler, host="127.0.0.1", port=0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(SEED)
    embs = rng.standard_normal((5, 512)).astype(np.float32)
    results = [None] * 5
    try:
        torch.cuda.synchronize()
        tfa.flash_attention.launches = 0
        tfm.fused_moe_ffn.launches = 0
        d0 = handler.batcher.dispatches
        request_once(base, embs[0], 1, results, 0)  # default 10 ms batching window
        handler.batcher.max_wait = 0.5  # let the 4 concurrent requests meet in one batch
        threads = [threading.Thread(target=request_once, args=(base, embs[i], 1 + i, results, i))
                   for i in range(1, 5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        torch.cuda.synchronize()
        launches = {"flash_attention_fwd": tfa.flash_attention.launches,
                    "fused_moe_fwd": tfm.fused_moe_ffn.launches}
        dispatches = handler.batcher.dispatches - d0
        dispatch_ms = list(handler.batcher.dispatch_ms)[-dispatches:]
    finally:
        server.shutdown()
        server.server_close()
        handler.close()
        th.join(30)
    for i, r in enumerate(results):
        check(r is not None, f"request {i} did not return")
        job, ms = r
        check(job["status"] == "COMPLETED", f"request {i}: {job['status']} {job.get('data')}")
        imgs = [decode_png(base64.b64decode(s)) for s in job["data"]["images"]]
        check(len(imgs) == 4, f"request {i}: {len(imgs)} images, want 4")
        check(all(im.shape == (64, 64, 3) for im in imgs), f"request {i}: image shape")
        check(len(job["data"]["expert_utilization"]) == 5, f"request {i}: expert_utilization")
    lat = [r[1] for r in results]
    print(f"served 5 requests in {dispatches} generator calls; latency ms: lone={lat[0]:.1f} "
          f"concurrent={[round(x, 1) for x in lat[1:]]}; generator calls ms: "
          f"{[round(x, 1) for x in dispatch_ms]}", flush=True)
    print("serve " + json.dumps({"latency_ms": lat, "poll_ms": POLL_S * 1e3,
                                 "dispatches": dispatches, "dispatch_ms": dispatch_ms,
                                 "launches": launches}), flush=True)
    check(dispatches >= 2, f"{dispatches} generator calls for 5 requests")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched while serving")
    return launches, lat, dispatches


# --- phase 4: the whole generator on the card against the CPU -----------------------------


def image_stats(raw_card, raw_cpu):
    """Differences of the served (clipped) images, and of the raw ones relative to their range."""
    a, b = np.clip(raw_card, -1, 1), np.clip(raw_cpu, -1, 1)
    diff = np.abs(a - b)
    return {"max_abs_diff": float(diff.max()), "mean_abs_diff": float(diff.mean()),
            "p99_abs_diff": float(np.quantile(diff, 0.99)),
            "share_over_0.1": float((diff > 0.1).mean()),
            "raw_max_rel_diff": float(np.abs(raw_card - raw_cpu).max() / np.abs(raw_cpu).max())}


def generator_phase(cfg, state_dict, tfm):
    """One batch-4 call on the card (kernels, bf16) against the CPU (plain versions, float32).

    Hard routing turns bf16 noise into a different expert for the few
    tokens whose top two experts are nearly tied, which moves their pixels
    by O(1). So the CPU runs twice: free (its own routing, reported with
    the top-1 agreement) and pinned to the card's routing, which is the
    run the tolerance holds.
    """
    import moegan_tpu_torch.core.moe as moe_mod
    from moegan_tpu_torch.infer.sample import Sampler
    from moegan_tpu_torch.models.generator import AuroraGenerator

    rng = np.random.default_rng(SEED + 1)
    z = torch.from_numpy(rng.standard_normal((4, 512)).astype(np.float32))
    txt = torch.from_numpy(rng.standard_normal((4, 512)).astype(np.float32))
    psi = torch.tensor([0.5, 0.7, 0.9, 1.0])
    card = Sampler(cfg, state_dict, device="cuda")
    with torch.inference_mode():
        out_card = card.gen(z.cuda(), txt.cuda(), psi.cuda())
    img_card = out_card.image.float().cpu().numpy()
    routing_card = [p.float().cpu() for p in out_card.routing]
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = AuroraGenerator(cfg.replace(compute_dtype="float32")).eval()
    cpu.load_state_dict(state_dict)
    with torch.inference_mode():
        free = cpu(z, txt, psi)
    pinned_probs = iter(routing_card)
    plain = moe_mod.fused_moe_ffn

    def pinned(x, fw, cw_f, text_logits, inv_temp, *rest, hard=False):
        # Text logits of +-1e4 clip to +-20 and make hard routing pick
        # exactly the card's expert(s), ties included.
        p = next(pinned_probs).reshape(text_logits.shape)
        return plain(x, fw, cw_f, torch.where(p > 0, 1e4, -1e4), inv_temp, *rest, hard=hard)

    moe_mod.fused_moe_ffn = pinned
    try:
        with torch.inference_mode():
            held = cpu(z, txt, psi)
    finally:
        moe_mod.fused_moe_ffn = plain
    check(np.isfinite(img_card).all(), "card images are not finite")
    check(img_card.shape == (4, 64, 64, 3), f"image shape {img_card.shape}")
    for a, b in zip(routing_card, held.routing):
        check(torch.equal(a, b), "pinned routing differs from the card's")
    stats = {
        "pinned": image_stats(img_card, held.image.numpy()),
        "free": image_stats(img_card, free.image.numpy()),
        "top1_agreement": [float((a.argmax(-1) == b.argmax(-1)).float().mean())
                           for a, b in zip(routing_card, free.routing)],
    }
    print("generator_vs_cpu " + json.dumps(stats), flush=True)
    # bf16 activations against float32 with the same routing: each bf16
    # rounding is 2^-9 relative and the path has a few dozen of them in
    # sequence (5 blocks of convs, attention, MoE), so the raw images agree
    # to a few percent of their range.
    tol = 0.05
    rel = stats["pinned"]["raw_max_rel_diff"]
    check(rel <= tol, f"generator vs CPU (pinned routing): max |diff| / max |image| {rel} > {tol}")
    return stats


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from moegan_tpu_torch.ops import _build
    from moegan_tpu_torch.ops import flash_attention as tfa
    from moegan_tpu_torch.ops import fused_moe as tfm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    torch.manual_seed(SEED)
    build_s = _build.build_all()
    print(f"nvcc build: {build_s:.1f} s for {list(_build.SOURCES)}", flush=True)

    flash_rows = flash_phase(dev, tfa)
    moe_rows = moe_phase(dev, tfm)

    model_dir = tempfile.mkdtemp(prefix="moegan_smoke_model_")
    try:
        cfg, state_dict = build_model_dir(model_dir)
        launches, _, _ = serve_phase(model_dir, tfa, tfm)
        generator_phase(cfg, state_dict, tfm)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)

    def total(rows, key):
        return sum(r[key] for r in rows)

    kernels = []
    for name, rows, src, replaces, lib in (
        ("flash_attention_fwd", flash_rows, "moegan_tpu_torch/ops/csrc/flash_attention.cu",
         "moegan_tpu/ops/flash_attention.py:226", True),
        ("fused_moe_fwd", moe_rows, "moegan_tpu_torch/ops/csrc/fused_moe.cu",
         "moegan_tpu/ops/fused_moe.py:97; moegan_tpu/ops/fused_moe.py:722", False),
    ):
        ops_ms = sum(r["flops"] for r in rows) / PEAK_BF16_FLOPS * 1e3
        bytes_ms = sum(r["bytes"] for r in rows) / PEAK_BYTES * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(r["max_abs_err"] for r in rows),
            # times and bounds: the sum over the shapes of one batch-16 generator call
            "ms": total(rows, "ms"), "plain_ms": total(rows, "plain_ms"),
            "bound_ms": total(rows, "bound_ms"),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": total(rows, "library_ms") if lib else None,
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
