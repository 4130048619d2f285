#!/usr/bin/env python3
"""Drive the PyTorch port's 64x64 serving path, training step, distributed
training, opt-in kernel configuration, training CLI, training
configurations (the flagship preset, the step's options, progressive
training, one expert), generation and evaluation (FID, CLIPScore,
/image-metrics, the evaluate and generate_images CLIs) and the MLOps chain
(data processing, tuning, the managed job, deployment) on one NVIDIA GPU
and check them.

Run from the repository root: `python3 chip_smoke.py`. It needs one CUDA
device and nvcc (it builds the port's kernels from `moegan_tpu_torch/ops/csrc`).
It imports nothing of JAX or of the JAX package. Phases, each fatal on
failure (non-zero exit, no result line):

1. the card's name, power limit and SM clock limit; build the CUDA kernels
   (one nvcc process per source, started together);
2. each forward kernel against its plain PyTorch version on the card, in
   bf16, at every shape the serving path gives it at batch 16, with times
   (CUDA events) for the kernel, the plain version and, for attention,
   `F.scaled_dot_product_attention` as a yardstick, the device time alone
   (the calls replayed from a CUDA graph) and the SFU floor (for attention
   B*H*T^2 exponentials, for the MoE forward two SFU operations a GELU,
   over an assumed 16 per SM per clock at the SM clock limit), printed on
   each shape's line;
3. each backward kernel against its plain version at every shape the
   training step gives it at batch 64 (flash: dq, dk, dv, SDPA forward +
   backward as the yardstick, the exponential floor of the function's
   B*H*T^2 exponentials, the forward's o and lse and its times with and
   without lse beside SDPA's forward without and with grad; MoE: all
   nine gradients of `FusedMoEFunction` against the autograd of
   `moe_ffn_reference`, the soft forward's out and probs, and the times,
   device times, bounds and GELU floors of the soft forward and the
   backward), two calls bit-identical;
4. the served slice: the default 64x64 generator built from a seed, written
   as `.npz` + `generator_config.json`, loaded by the port's
   `InferenceHandler` (with the random-init CLIP towers), served over HTTP on
   127.0.0.1; one lone /generate
   (a batch-4 call) then 4 concurrent ones (one batch-16 call), every PNG
   decoded and checked; the forward kernels' launch counts are read around
   this phase alone;
5. the whole generator on the card (kernels, bf16) against the same weights
   and inputs on the CPU (plain versions, float32);
6. the training step: the default `TrainConfig` (64x64, batch 64) through
   `create_train_state` + `make_train_step`, 5 steps on a synthetic batch;
   losses and parameters finite, parameters changed, ms/step (CUDA events,
   median of steps 3-5) and images/s; each step's launches of the four
   kernels are counted on their own and must be 6 / 3 / 10 / 5;
7. one full-width step at batch 4 on the card (kernels, bf16) against the
   same weights, batch and noise on the CPU (plain versions, float32):
   losses and the cosine of each parameter group's gradient;
8. the expert-parallel combine kernels (forward, soft and one-hot, and
   backward) against their plain versions at every MoE shape of the step at
   batch 64, for 2 and 1 local experts, two calls bit-identical;
9. the distributed path: two ranks (data 1 x expert 2) spawned on the one
   card over gloo after every kernel was built here. One distributed step
   against the single-process step on the same weights, batch and noise
   (losses within 2 %, gradient cosine >= 0.99), then `train_aurora_gan`
   for one epoch of 3 steps and a validation batch; each step's launches
   must be 6 / 3 flash, 0 / 0 fused MoE and 10 / 5 combine, the validation
   batch's 5 combine forwards. ms/step is two ranks sharing one card over
   gloo, not a multi-GPU number.

10. the JAX package's opt-in kernel configuration, MOEGAN_FUSED_LN=1 and
   MOEGAN_PALLAS_MOE_BWD=3, set in this phase alone and restored after it:
   (a) both LayerNorm kernels against their plain twins at the five norm
   shapes of the step at batch 64, two calls bit-identical, times (with the
   host, device times hot in L2, and cold: over input copies that move at
   least 100 MB a pass) beside `F.layer_norm`'s; (b) the three legacy MoE
   backward entry points, each against its own plain twin at the five MoE
   blocks (each with the forward's routing, as the step launches them), two
   calls bit-identical, with times, device times, bounds, GELU floors and
   each block's plan (dW1's and dW2's routes), and `FusedMoEFunction`'s gradients under =3
   against =1;
   (c) 5 training steps at batch 64 (launches 6 / 3 flash, 10 fused MoE forwards, 0 fused MoE
   backwards, 5 of each legacy entry point, 20 / 10 LayerNorm) and the
   batch-4 step against the CPU's under the same flags, to phase 7's
   limits; (d) one batch-16 generator call with MOEGAN_FUSED_LN=1 against
   the default call (10 LayerNorm forwards, phase 5's limit). Phases 6, 9
   and 11 require 0 launches of these five kernels.
11. the training CLI's default run, `cli.train_model.main(["--synthetic",
   "--epochs", "2", "--batch_size", "32", "--save_dir", D])` at the full
   64x64 default configuration with the CLIP loss (random-init ViT-B/32
   towers; 64 synthetic images, 2 steps an epoch): every loss and
   clip_loss_{r} finite, two checkpoints, the sidecar,
   `aurora_model_final.msgpack` and `generator_config.json` written, the
   kernels' launches over the run exactly 4 steps' and 2 validation
   batches'; the CLIP loss timed alone at batch 32; the same run with
   `--no_clip_loss`; `--resume --epochs 3` against two uninterrupted 3-epoch
   runs (step and counts equal; parameters and AdamW's moments within 4x
   the two uninterrupted runs' own difference: cuDNN's, grid_sample's and
   the upsample's backward kernels add in no fixed order); ms/step (CUDA
   events, steps 3-6 of both 3-epoch runs); the directory served with a
   string prompt over HTTP (images
   64x64x3 and finite, the text embedding against the CPU's float32 tower,
   cosine >= 0.999); `save_checkpoint` and `restore_checkpoint` timed.
12. the training configurations: (a) `tpu_flagship_config()` (every rung at
   least 64 wide): the flash and MoE kernels against their plain versions at
   its shapes at batch 64 (flash head_dim 32/16/32 at T 256/1024/4096, MoE
   C = 512 at res 4-8 down to 64 at res 64), with times and bounds; 5 steps
   at batch 64 (the default step's launches, ms/step) and its batch-4 step
   against the CPU's to phase 7's limits; (b) the flagship with the hinge
   loss, the switch balance over every block, `shared_fake` and 2 mini-steps
   an update: 4 mini-steps at batch 64, each with the shared-fake launches
   (3 / 3 flash, 5 / 5 fused MoE), the parameters unchanged bit for bit
   after mini-steps 1 and 3 and changed after 2 and 4, and 2 batch-4
   mini-steps against the CPU's to phase 7's limits; (c) `train_progressive`
   through stages 16, 32 and 64 (one epoch each, batch 32, default
   channels): the transferred-tensor counts that
   tests/test_torch_progressive.py pins, each stage's steps and launches,
   finite parameters; (d) one expert: the forward kernel (hard and soft) and
   the backward at E = 1 against their plain versions, and a one-expert
   generator's batch-16 call against the CPU's to phase 5's limit; (e) phase
   9's two ranks under `shared_fake`, 2 mini-steps an update and the switch
   balance over every block, 2 mini-steps against the single-card steps to
   phase 9's limits.
13. generation and evaluation, at the default 64x64 configuration with the
   random-init InceptionV3 and CLIP towers: (a) the flash forward (no lse)
   and the fused MoE forward (hard and soft, timed hard) against their plain
   versions at the evaluator's batch 64, with times and bounds; (b)
   InceptionV3 features (bf16, cuDNN) of 8 generated images against the
   CPU's float32, each image's cosine >= FEATURE_COSINE, both variants, and
   64 images' features timed; (c) `cli.evaluate.main(["--synthetic",
   "--batch_size", "64", "--save_reference_stats", P, "--device", "cuda",
   "--model_path", M])` once per feature source (128 samples, 2 generator
   calls): fid and clip_score finite, expert_utilization summing to 1, the
   stats file, exactly 3 flash and 5 fused MoE forwards a generator call and
   nothing else; the Inception run's FID recomputed from the CPU's float32
   features of the same images (see FID_REL_TOL); wall time split into
   generator, Inception, CLIP, sqrtm and the rest; (d) the model directory
   served from an empty working directory: /image-metrics with a prompt and
   with an embedding, without reference_stats.npz (the μ=0, Σ=I fallback)
   and then with (c)'s file, fid_score finite, latency reported; a lone
   request to the `batching=False` handler; (e) `cli.generate_images` writes
   a 2x2 grid (128x128x3) and prints the expert statistics.
14. the MLOps chain: four stages on an `orchestration.Pipeline` with the
   upload-data and run-hpo flags set: (a) `cli.process_data --synthetic 2048`
   (1,000 validation, 1,048 train, 3,144 augmented 64x64 images; the card's
   text embeddings of 32 captions against the CPU's float32 tower, cosine >=
   0.999; the card's augmentations against the same function on the CPU,
   <= 1e-4; wall seconds of resize, tower set-up, text, augment and write);
   (b) `cli.tune` on (a)'s data cut to 128 / 64 images and 2 epochs, the
   search space's batch 8 at res 16 with the CLI's full channels: 4 trials
   in process, 2 at a time, then 2 as job-runner processes, then 1 alone;
   objectives finite, two trials overlapping, the three files with the JAX
   package's keys, the flash and fused MoE kernels launched by the trials in
   process; (c) `cli.job_train` with the best hyperparameters at the CLI's
   defaults (64x64, batch 32, the CLIP loss) for 1 epoch on 128 train images:
   exactly 4 steps' and 31 validation batches' launches, ms/step; then the
   model directory published (`model_metrics.json`) and served: one
   /generate of 4 images, GET /metrics returning the document; every stage
   SUCCEEDED and both flags reset; (e) `train_toy_clip` on 1,024 shapes on
   the card for 200 steps, its loss falling, and `retrieval_accuracy`.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import base64
import contextlib
import functools
import glob
import io
import itertools
import json
import math
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
# combined_mu makes most decisions clear of that noise, so phase 5 compares
# the same routing on the card and the CPU.
ROUTER_SCALE = 100.0
# The HTTP clients' /poll interval (the bundled frontend polls every 3 s).
POLL_S = 0.02
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
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


def graph_ms(fn, reps: int) -> float:
    """Device ms per call: `reps` calls captured in one CUDA graph, one replay
    timed with CUDA events after a warm-up replay. Unlike `time_ms`, this
    leaves out the host's cost per call, which bounds small calls."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up on a side stream before capture
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


# Bytes one pass over `cold_graph_ms`'s input copies moves: twice the H100's
# 50 MB L2, so every copy's reads come from device memory.
COLD_BYTES = 100e6


def cold_graph_ms(fn, inputs) -> float:
    """Device ms per call of fn(*a), a cycling over the input copies `inputs`,
    two passes captured in one CUDA graph (as `graph_ms`). Give one more copy
    than a pass of COLD_BYTES needs, so at least COLD_BYTES of other traffic
    passes between two calls on one copy."""
    turn = itertools.cycle(inputs)
    return graph_ms(lambda: fn(*next(turn)), 2 * len(inputs))


def host_us(fn, calls: int = 200) -> float:
    """Host µs per call: `calls` calls enqueued without a synchronize (the
    wrapper's Python and launch cost, while the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def cold_copies(nbytes: float) -> int:
    """Input copies for `cold_graph_ms` of a call that moves `nbytes`."""
    return math.ceil(COLD_BYTES / nbytes) + 1


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# Hopper's SFU rate, assumed: ex2 results per SM per clock.
# scripts/torch_mma_ex2_rates.py measures the card's rate.
EX2_PER_SM_CLOCK = 16


@functools.cache
def sm_clock_mhz() -> float:
    """The card's SM clock limit, as `nvidia-smi --query-gpu=clocks.max.sm` reads it."""
    query = ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"]
    out = subprocess.run(query, capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0])


def exp_floor_ms(exps: float) -> float:
    """Least time for `exps` exponentials (or other SFU operations: a GELU is a
    reciprocal and an exponential) on the SFUs of every SM at the SM clock limit."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exps / (EX2_PER_SM_CLOCK * sms * sm_clock_mhz() * 1e6) * 1e3


# --- phase 2: kernels against their plain versions -------------------------------------


def flash_phase(dev, tfa, batch=N, tag="", lse_tol=1e-3):
    """The three self-attention shapes (res 16/32/64) at `batch` (`tag` prefixes
    the per-shape lines; `lse_tol` is the lse limit, see flash_bwd_phase)."""
    import torch.nn.functional as F

    rows = []
    g = torch.Generator(device=dev).manual_seed(SEED)
    for res, H, D in ((16, 8, 16), (32, 2, 32), (64, 1, 32)):
        T = res * res
        y = torch.randn((batch, T, 3 * H * D), generator=g, device=dev).to(torch.bfloat16)
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
        check(err <= tol, f"flash {tag}res {res}: max |o - plain| {err} > {tol} (max |o| "
                          f"{o_max})")
        # lse in base-2 units, fp32. l sums p rounded to bf16 against
        # different maxima; those roundings (each <= 2^-9 relative) mostly
        # cancel over T terms.
        check(lse_err <= lse_tol, f"flash {tag}res {res}: max |lse - plain| {lse_err} > "
                                  f"{lse_tol}")
        o2 = tfa.flash_attention(q, k, v)
        check(torch.equal(o, o2), f"flash {tag}res {res}: the no-lse call differs from the lse "
                                  f"call")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = time_ms(lambda: tfa.flash_attention(q, k, v), 20)
        plain_ms = time_ms(lambda: tfa.flash_attention_reference(q, k, v), 5)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
        dev_ms = graph_ms(lambda: tfa.flash_attention(q, k, v), 20)
        lib_dev_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
        flops = 4.0 * batch * H * T * T * D
        nbytes = 4.0 * batch * T * H * D * 2  # q, k, v read once, o written once, bf16
        b_ms, b_by = bound_ms(flops, nbytes)
        exps = float(batch * H * T * T)
        rows.append(dict(res=res, B=batch, T=T, H=H, D=D,
                         block_q=tfa.flash_plan(batch, H, T, D,
                                                torch.cuda.get_device_properties(0)
                                                .multi_processor_count),
                         max_abs_err=err, max_abs_ref=o_max, tol=tol, lse_max_abs_err=lse_err,
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms, device_ms=dev_ms,
                         library_device_ms=lib_dev_ms, flops=flops, bytes=nbytes,
                         exps=exps, exp_floor_ms=exp_floor_ms(exps), bound_ms=b_ms,
                         bound_by=b_by))
        print(f"flash_attention_fwd {tag}" + json.dumps(rows[-1]), flush=True)
        del y, q, k, v, o, lse, o_ref, lse_ref, o2, qt, kt, vt
        torch.cuda.empty_cache()
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
    if hard and p.shape[-1] > 1:
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


def moe_phase(dev, tfm, batch=N, tag=""):
    """The five MoE blocks at `batch`, hard (served) and soft, timed hard (`tag`
    prefixes the per-shape lines)."""
    rows = []
    for res, C in ((4, 512), (8, 256), (16, 128), (32, 64), (64, 32)):
        T = batch * res * res
        args = moe_args(dev, C, T, seed=res)
        err_h, perr_h, excl, p, scale = moe_compare(tfm, args, True, f"{tag}res {res} hard")
        err_s, perr_s, _, _, _ = moe_compare(tfm, args, False, f"{tag}res {res} soft")
        ms = time_ms(lambda: tfm.fused_moe_ffn(*args, hard=True), 10)
        dev_ms = graph_ms(lambda: tfm.fused_moe_ffn(*args, hard=True), 10)
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
                         near_tie_tokens_excluded=excl, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, flops=flops,
                         dense_flops=4.0 * T * C * F_ * E, bytes=float(nbytes), bound_ms=b_ms,
                         bound_by=b_by,
                         # every token tile computes every expert it selects: T*E*F
                         # GELUs at most, 2 SFU operations each
                         gelu_floor_ms=exp_floor_ms(2.0 * selections * F_),
                         plan=list(tfm.kernel_plan(T, C, F_, E, dev))))
        print(f"fused_moe_fwd {tag}" + json.dumps(rows[-1]), flush=True)
    return rows


def moe_ties_phase(dev, tfm):
    """A ragged batch of 1000 tokens whose first 37 tie exactly: split evenly."""
    args = moe_args(dev, 256, 1000, ties=37, seed=99)
    err, _, _, p, _ = moe_compare(tfm, args, True, "forced ties")
    check(torch.equal(p[:37], torch.tensor([[0.5, 0.5, 0.0, 0.0]], device=dev).expand(37, 4)),
          "moe forced ties: tied rows are not split evenly")
    print(f"fused_moe_fwd forced-ties T=1000 C=256 max_abs_err={err}", flush=True)


# --- phase 3: the backward kernels against their plain versions ------------------------

B_TRAIN = 64  # the default TrainConfig's batch
TRAIN_ATTN = ((16, 8, 16), (32, 2, 32), (64, 1, 32))  # (res, heads, head_dim)
TRAIN_MOE = ((4, 512), (8, 256), (16, 128), (32, 64), (64, 32))  # (res, C)


def flash_bwd_phase(dev, tfa, shapes=TRAIN_ATTN, tag=""):
    """The backward at the three self-attention shapes of the 64x64 step at batch 64
    (`shapes`: (res, heads, head_dim); `tag` prefixes the per-shape lines).

    The kernel runs on the whole batch. Its plain version, the autograd of
    `flash_attention_reference`, holds [B, H, T, T] fp32 scores and
    probabilities and their gradients (about 4 GiB each at res 64 and batch
    64), so at res 64 it checks the first 16 images, and is timed on the
    whole batch 16 images at a time; each image's gradient depends on that
    image alone.
    """
    import torch.nn.functional as F

    rows = []
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    for res, H, D in shapes:
        T = res * res
        y = torch.randn((B_TRAIN, T, 3 * H * D), generator=g, device=dev).to(torch.bfloat16)
        q, k, v = (y[..., i * H * D:(i + 1) * H * D].unflatten(-1, (H, D)) for i in range(3))
        do = torch.randn((B_TRAIN, T, H, D), generator=g, device=dev).to(torch.bfloat16)
        o, lse = tfa.flash_attention(q, k, v, with_lse=True)
        # The forward's o and lse at the training batch, against the plain
        # version in chunks of 16 images. o to the limit of flash_phase. Both
        # sides sum p rounded to bf16 (each term within 2^-9 relative), the
        # kernel against its running max, the plain version against the row
        # max, so each l is within 2^-9 of the exact sum and the two lse
        # within log2((1 + 2^-9) / (1 - 2^-9)) = 5.6e-3 of each other (plus
        # fp32 sums over T terms). flash_phase's 1e-3 is what held over batch
        # 16's rows; batch 64 at res 16 gave 1.08e-3.
        lse_tol = 6e-3
        o_err = o_max = lse_err = 0.0
        for i in range(0, B_TRAIN, 16):
            o_ref, lse_ref = tfa.flash_attention_reference(
                q[i:i + 16], k[i:i + 16], v[i:i + 16], with_lse=True)
            o_err = max(o_err, (o[i:i + 16].float() - o_ref.float()).abs().max().item())
            o_max = max(o_max, o_ref.float().abs().max().item())
            lse_err = max(lse_err, (lse[i:i + 16] - lse_ref).abs().max().item())
            del o_ref, lse_ref
        check(o_err <= 4 * 2.0 ** -8 * o_max,
              f"flash fwd {tag}res {res} batch {B_TRAIN}: max |o - plain| {o_err} (max |o| "
              f"{o_max})")
        check(lse_err <= lse_tol,
              f"flash fwd {tag}res {res} batch {B_TRAIN}: max |lse - plain| {lse_err} > "
              f"{lse_tol}")
        # The forward as the step launches it: 3 calls without lse (the D
        # phase's fake), 3 with (under autograd), beside SDPA's forward
        # without grad and with grad (where it keeps its logsumexp).
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        fwd_ms = time_ms(lambda: tfa.flash_attention(q, k, v), 10)
        fwd_lse_ms = time_ms(lambda: tfa.flash_attention(q, k, v, with_lse=True), 10)
        fwd_lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 10)
        fwd_dev_ms = graph_ms(lambda: tfa.flash_attention(q, k, v), 10)
        fwd_lse_dev_ms = graph_ms(lambda: tfa.flash_attention(q, k, v, with_lse=True), 10)
        fwd_lib_dev_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 10)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))

        def sdpa_fwd_grad():
            with torch.enable_grad():
                F.scaled_dot_product_attention(qg, kg, vg)

        fwd_lse_lib_ms = time_ms(sdpa_fwd_grad, 10)
        del qt, kt, vt, qg, kg, vg
        got = tfa.flash_attention_bwd(q, k, v, o, lse, do)
        again = tfa.flash_attention_bwd(q, k, v, o, lse, do)
        nb = 16 if res == 64 else B_TRAIN
        want = tfa.flash_attention_bwd_reference(q[:nb], k[:nb], v[:nb], do[:nb])
        torch.cuda.synchronize()
        errs, refs = [], []
        for name, a, b, c in zip("qkv", got, again, want):
            check(torch.equal(a, b), f"flash bwd {tag}res {res}: two calls give different "
                                     f"d{name}")
            err = (a[:nb].float() - c.float()).abs().max().item()
            ref = c.float().abs().max().item()
            # The kernel rounds p and ds to bf16 before their products and
            # its outputs to bf16; the plain version keeps them in fp32
            # until the final rounding. Sums over T terms of such roundings
            # (2^-9 relative each, of both signs) stay within a few bf16
            # ulps of the largest gradient.
            tol = 8 * 2.0 ** -8 * ref
            check(err <= tol, f"flash bwd {tag}res {res}: max |d{name} - plain| {err} > {tol}")
            errs.append(err)
            refs.append(ref)
        del want
        ms = time_ms(lambda: tfa.flash_attention_bwd(q, k, v, o, lse, do), 10)
        dev_ms = graph_ms(lambda: tfa.flash_attention_bwd(q, k, v, o, lse, do), 10)

        def plain_bwd():  # the whole batch, nb images at a time
            for i in range(0, B_TRAIN, nb):
                tfa.flash_attention_bwd_reference(q[i:i + nb], k[i:i + nb], v[i:i + nb],
                                                  do[i:i + nb])

        plain_ms = time_ms(plain_bwd, 3)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt), (qt, kt, vt), dot)

        lib_ms = time_ms(sdpa_fwd_bwd, 10)
        # S recomputed, then dP, dV, dQ, dK: five [T, T, D] products (the
        # TPU kernel's cost estimate); q, k, v, o, do and lse read once,
        # dq, dk, dv written once.
        flops = 10.0 * B_TRAIN * H * T * T * D
        nbytes = 8.0 * B_TRAIN * T * H * D * 2 + 4.0 * B_TRAIN * H * T
        b_ms, b_by = bound_ms(flops, nbytes)
        # The function's B*H*T^2 exponentials (p once a score); the kernels
        # exponentiate S twice, in the dk/dv and in the dq kernel.
        exps = float(B_TRAIN * H * T * T)
        rows.append(dict(res=res, B=B_TRAIN, T=T, H=H, D=D, max_abs_err=max(errs),
                         max_abs_ref=max(refs), errs_dq_dk_dv=errs, fwd_o_err=o_err,
                         fwd_lse_err=lse_err, plain_batch=nb, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=lib_ms, flops=flops, bytes=nbytes,
                         exps=exps, exp_floor_ms=exp_floor_ms(exps), bound_ms=b_ms,
                         bound_by=b_by, fwd_ms=fwd_ms, fwd_lse_ms=fwd_lse_ms,
                         fwd_library_ms=fwd_lib_ms, fwd_lse_library_ms=fwd_lse_lib_ms,
                         fwd_device_ms=fwd_dev_ms, fwd_lse_device_ms=fwd_lse_dev_ms,
                         fwd_library_device_ms=fwd_lib_dev_ms))
        print(f"flash_attention_bwd {tag}" + json.dumps(rows[-1]), flush=True)
        del q, k, v, y, do, o, lse, got, again, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def moe_bwd_phase(dev, tfm, shapes=TRAIN_MOE, tag="", batch=B_TRAIN, E=4):
    """`FusedMoEFunction` (both kernels) against the autograd of `moe_ffn_reference`,
    all nine gradients, at the five MoE blocks of the 64x64 step at batch 64
    (`shapes`: (res, C); `E` experts; `tag` prefixes the per-shape lines)."""
    rows = []
    names = ("x", "fw", "cw_f", "text_logits", "inv_temp", "w1", "b1", "w2", "b2")
    for res, C in shapes:
        T = batch * res * res
        args = moe_args(dev, C, T, E=E, seed=100 + res)
        args[4] = args[4].clone()
        g = torch.Generator(device=dev).manual_seed(SEED + res)
        dout = (torch.randn((T, C), generator=g, device=dev) * 0.1).to(torch.bfloat16)
        dprobs = torch.randn((T, E), generator=g, device=dev) * 0.1

        def grads(fn):
            leaves = [a.detach().requires_grad_(True) for a in args]
            out, probs = fn(*leaves)
            return out.detach(), probs.detach(), torch.autograd.grad(
                (out, probs), leaves, (dout, dprobs))

        out, probs, got = grads(tfm.FusedMoEFunction.apply)
        out2, probs2, again = grads(tfm.FusedMoEFunction.apply)
        out_ref, probs_ref, want = grads(lambda *a: tfm.moe_ffn_reference(*a, hard=False))
        torch.cuda.synchronize()
        # The soft forward at the training T, to the limits of moe_compare.
        check(torch.equal(out, out2) and torch.equal(probs, probs2),
              f"moe fwd {tag}res {res} batch {batch}: two calls differ")
        out_err = (out.float() - out_ref.float()).abs().max().item()
        out_max = out_ref.float().abs().max().item()
        p_err = (probs - probs_ref).abs().max().item()
        check(out_err <= 4 * 2.0 ** -8 * out_max,
              f"moe fwd {tag}res {res} batch {batch}: max |out - plain| {out_err} (max {out_max})")
        check(p_err <= 1e-5, f"moe fwd {tag}res {res} batch {batch}: max |probs - plain| {p_err}")
        del out, out2, out_ref, probs, probs2, probs_ref
        # The soft forward as the step launches it (twice a step: G and D phases).
        fwd_ms = time_ms(lambda: tfm.fused_moe_ffn(*args, hard=False), 10)
        fwd_dev_ms = graph_ms(lambda: tfm.fused_moe_ffn(*args, hard=False), 10)
        p_fwd = tfm.fused_moe_ffn(*args, hard=False)[1]
        errs = {}
        for name, a, b, c in zip(names, got, again, want):
            check(torch.equal(a, b), f"moe bwd {tag}res {res}: two calls give different d{name}")
            err = (a.float() - c.float()).abs().max().item()
            ref = c.float().abs().max().item()
            # Relative to the largest |grad|. The weight gradients sum up to
            # 262k tokens and dx sums E*F = 512-8192 hidden units: the
            # kernel rounds dz and p*h to bf16 (2^-9 relative) before those
            # sums and the plain version does not, and the gradients of the
            # bf16 weights are rounded to bf16 on both sides.
            tol = 2e-2 * ref
            check(err <= tol, f"moe bwd {tag}res {res}: max |d{name} - plain| {err} > {tol}")
            errs[name] = [err, ref]
        x, fw, cw, tl, it, w1, b1, w2, b2 = args
        # As FusedMoEFunction launches it, reading the forward's routing.
        ms = time_ms(lambda: tfm.fused_moe_bwd(x, fw, cw, tl, it, w1, b1, w2, b2, dout,
                                               probs=p_fwd), 5)
        dev_ms = graph_ms(lambda: tfm.fused_moe_bwd(x, fw, cw, tl, it, w1, b1, w2, b2, dout,
                                                    probs=p_fwd), 5)
        plain_ms = time_ms(lambda: tfm.moe_ffn_bwd_reference(x, fw, cw, tl, it, w1, b1, w2, b2,
                                                             dout), 3)
        F_ = 4 * C
        flops = 10.0 * T * C * F_ * E
        # x and dout read (bf16), the weights read (bf16), dx and dp, the
        # weight and bias gradients written (fp32).
        nbytes = (2.0 * T * C * 2 + 2 * E * C * F_ * 2 + T * C * 4 + T * E * 4
                  + 2 * E * C * F_ * 4 + (E * F_ + E * C) * 4)
        b_ms, b_by = bound_ms(flops, nbytes)
        # The soft forward's work: x, the router and the weights read, out and probs
        # written; the router's products besides the FFN's 4*T*C*F*E.
        h = fw.shape[1]
        fwd_flops = 4.0 * T * C * F_ * E + 2.0 * T * C * h + 2.0 * T * h * E
        fwd_bytes = (T * C * 2 * 2 + T * E * 4 * 2 + C * h * 2 + h * E * 4
                     + E * (2 * C * F_ * 2 + (F_ + C) * 4))
        fwd_b_ms, fwd_b_by = bound_ms(fwd_flops, fwd_bytes)
        # T*E*F GELUs (with gelu' in the backward, sharing its exponential), 2 SFU
        # operations each
        gelu_floor = exp_floor_ms(2.0 * T * E * F_)
        rows.append(dict(res=res, T=T, C=C, F=F_, E=E,
                         max_abs_err=max(e for e, _ in errs.values()),
                         max_rel_err=max(e / max(r, 1e-30) for e, r in errs.values()),
                         errs=errs, fwd_out_err=out_err, fwd_probs_err=p_err, ms=ms,
                         device_ms=dev_ms,
                         plain_ms=plain_ms, flops=flops, bytes=nbytes,
                         bound_ms=b_ms, bound_by=b_by, gelu_floor_ms=gelu_floor,
                         fwd_ms=fwd_ms, fwd_device_ms=fwd_dev_ms, fwd_flops=fwd_flops,
                         fwd_bytes=fwd_bytes, fwd_bound_ms=fwd_b_ms, fwd_bound_by=fwd_b_by,
                         fwd_gelu_floor_ms=gelu_floor,
                         plan=list(tfm.bwd_kernel_plan(T, C, F_, E, dev)),
                         fwd_plan=list(tfm.kernel_plan(T, C, F_, E, dev))))
        print(f"fused_moe_bwd {tag}" + json.dumps(rows[-1]), flush=True)
        del got, again, want, args, dout, dprobs, p_fwd
        torch.cuda.empty_cache()
    return rows


# --- phase 4: the served slice ------------------------------------------------------------


def build_model_dir(path):
    from moegan_tpu_torch.config import GeneratorConfig
    from moegan_tpu_torch.utils.checkpoint import save_generator_params
    from moegan_tpu_torch.models.generator import AuroraGenerator

    cfg = GeneratorConfig()
    gen = AuroraGenerator(cfg, gen=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("combined_mu"):
                p.mul_(ROUTER_SCALE)
    save_generator_params(os.path.join(path, "generator.npz"), gen.state_dict())
    with open(os.path.join(path, "generator_config.json"), "w") as f:
        f.write(cfg.to_json())
    return cfg, gen.state_dict()


def http_json(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def request_once(base, text, seed, out, i, path="/generate"):
    """One POST `path` (/generate or /image-metrics) of 4 samples (`text` a prompt
    or an embedding), polled to its end."""
    t0 = time.perf_counter()
    text = text if isinstance(text, str) else text.tolist()
    rid = http_json(f"{base}{path}", {"text": text, "num_samples": 4,
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


# --- phase 5: the whole generator on the card against the CPU -----------------------------


def image_stats(raw_card, raw_cpu):
    """Differences of the served (clipped) images, and of the raw ones relative to their range."""
    a, b = np.clip(raw_card, -1, 1), np.clip(raw_cpu, -1, 1)
    diff = np.abs(a - b)
    return {"max_abs_diff": float(diff.max()), "mean_abs_diff": float(diff.mean()),
            "p99_abs_diff": float(np.quantile(diff, 0.99)),
            "share_over_0.1": float((diff > 0.1).mean()),
            "raw_max_rel_diff": float(np.abs(raw_card - raw_cpu).max() / np.abs(raw_cpu).max())}


@contextlib.contextmanager
def pinned_routing(routing):
    """Make each generator block's hard routing pick exactly the experts of
    `routing` (the blocks' probs of an earlier call, in order), ties included:
    text logits of +-1e4 clip to +-20."""
    import moegan_tpu_torch.core.moe as moe_mod

    probs = iter(routing)
    plain = moe_mod.fused_moe_ffn

    def pinned(x, fw, cw_f, text_logits, inv_temp, *rest, hard=False):
        p = next(probs).reshape(text_logits.shape).to(text_logits.device)
        return plain(x, fw, cw_f, torch.where(p > 0, 1e4, -1e4), inv_temp, *rest, hard=hard)

    moe_mod.fused_moe_ffn = pinned
    try:
        yield
    finally:
        moe_mod.fused_moe_ffn = plain


def generator_phase(cfg, state_dict, n=4, label="generator_vs_cpu", same_precision=False):
    """One batch-4 (or `n`, a multiple of 4) call on the card (kernels, bf16)
    against the CPU (plain versions, float32).

    With `same_precision` the CPU also runs its plain versions in bf16, and
    the limit holds the card's distance from float32 to that run's own
    distance plus the limit: a generator whose images grow large before
    clipping can be further from float32 in bf16 than the limit, plain
    versions or kernels, and the kernels may add no more than the limit.

    Hard routing turns bf16 noise into a different expert for the few
    tokens whose top two experts are nearly tied, which moves their pixels
    by O(1). So the CPU runs twice: free (its own routing, reported with
    the top-1 agreement) and pinned to the card's routing, which is the
    run the tolerance holds.
    """
    from moegan_tpu_torch.infer.sample import Sampler
    from moegan_tpu_torch.models.generator import AuroraGenerator

    rng = np.random.default_rng(SEED + 1)
    z = torch.from_numpy(rng.standard_normal((n, 512)).astype(np.float32))
    txt = torch.from_numpy(rng.standard_normal((n, 512)).astype(np.float32))
    psi = torch.tensor([0.5, 0.7, 0.9, 1.0]).repeat(n // 4)
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
    with pinned_routing(routing_card):
        with torch.inference_mode():
            held = cpu(z, txt, psi)
    check(np.isfinite(img_card).all(), "card images are not finite")
    check(img_card.shape == (n, 64, 64, 3), f"image shape {img_card.shape}")
    for a, b in zip(routing_card, held.routing):
        check(torch.equal(a, b), "pinned routing differs from the card's")
    stats = {
        "pinned": image_stats(img_card, held.image.numpy()),
        "free": image_stats(img_card, free.image.numpy()),
        "top1_agreement": [float((a.argmax(-1) == b.argmax(-1)).float().mean())
                           for a, b in zip(routing_card, free.routing)],
    }
    if same_precision:
        cpu_bf16 = AuroraGenerator(cfg).eval()
        cpu_bf16.load_state_dict(state_dict)
        with pinned_routing(routing_card):
            with torch.inference_mode():
                plain = cpu_bf16(z, txt, psi).image.float().numpy()
        stats["cpu_bf16_pinned"] = image_stats(img_card, plain)
        stats["cpu_bf16_vs_float32"] = image_stats(plain, held.image.numpy())
    print(f"{label} " + json.dumps(stats), flush=True)
    # bf16 activations against float32 with the same routing: each bf16
    # rounding is 2^-9 relative and the path has a few dozen of them in
    # sequence (5 blocks of convs, attention, MoE), so the raw images agree
    # to a few percent of their range.
    tol = 0.05
    rel = stats["pinned"]["raw_max_rel_diff"]
    if same_precision:
        tol += stats["cpu_bf16_vs_float32"]["raw_max_rel_diff"]
    check(rel <= tol, f"{label} (pinned routing): max |diff| / max |image| {rel} > {tol}")
    return stats


# --- phases 6-7: the training step -------------------------------------------------------

# The opt-in kernels (phase 10) are launched by no default path.
OPT_IN_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "moe_bwd_dx", "moe_bwd_dw2", "moe_bwd_dw1")
EXPECTED_STEP_LAUNCHES = {"flash_attention_fwd": 6, "flash_attention_bwd": 3,
                          "fused_moe_fwd": 10, "fused_moe_bwd": 5,
                          "moe_combine_fwd": 0, "moe_combine_bwd": 0,
                          **dict.fromkeys(OPT_IN_KERNELS, 0)}


def counters():
    """{kernel name: its wrapper}; each wrapper counts its launches in `.launches`."""
    from moegan_tpu_torch.ops import flash_attention as tfa
    from moegan_tpu_torch.ops import fused_moe as tfm
    from moegan_tpu_torch.ops import layernorm as tln

    return {"flash_attention_fwd": tfa.flash_attention,
            "flash_attention_bwd": tfa.flash_attention_bwd,
            "fused_moe_fwd": tfm.fused_moe_ffn, "fused_moe_bwd": tfm.fused_moe_bwd,
            "moe_combine_fwd": tfm.moe_ffn_combine, "moe_combine_bwd": tfm.moe_ffn_combine_bwd,
            "layer_norm_fwd": tln.layer_norm_fwd, "layer_norm_bwd": tln.layer_norm_bwd,
            "moe_bwd_dx": tfm.moe_bwd_dx, "moe_bwd_dw2": tfm.moe_bwd_dw2,
            "moe_bwd_dw1": tfm.moe_bwd_dw1}


def launch_counts():
    return {name: fn.launches for name, fn in counters().items()}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def synthetic_batch(n, res, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return {"image": torch.tanh(torch.randn((n, res, res, 3), generator=g, device=device)),
            "text": torch.randn((n, 512), generator=g, device=device)}


def epoch0_schedule(cfg):
    from moegan_tpu_torch.losses.gan import kl_annealing_factor, temperature_factor

    return {"temperature_factor": temperature_factor(0),
            "effective_kl_weight": cfg.loss.kl_weight
            * kl_annealing_factor(0, cfg.loss.kl_annealing_epochs)}


def train_phase(smi, expected=EXPECTED_STEP_LAUNCHES, label="train", cfg=None):
    """5 steps of the default 64x64 TrainConfig (or `cfg`) at batch 64 through
    `create_train_state` + `make_train_step`, random weights from the seed and
    a synthetic batch. Every step's kernel launches are counted on their own
    and must be `expected`."""
    from moegan_tpu_torch.config import TrainConfig
    from moegan_tpu_torch.train.state import create_train_state
    from moegan_tpu_torch.train.step import make_train_step

    cfg = cfg or TrainConfig()
    state = create_train_state(cfg, device="cuda", seed=SEED)
    step = make_train_step(cfg)
    params = dict(state.generator.named_parameters(prefix="generator"))
    params.update(state.discriminator.named_parameters(prefix="discriminator"))
    before = {k: p.detach().clone() for k, p in params.items()}
    batch = synthetic_batch(cfg.batch_size, 64, SEED + 3, "cuda")
    sched = epoch0_schedule(cfg)
    noise_gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, launches, all_metrics = [], [], []
    total = dict.fromkeys(expected, 0)
    for i in range(5):
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch, sched, generator=noise_gen)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        counts = launch_counts()
        launches.append(counts)
        for k, n in counts.items():
            total[k] += n
        all_metrics.append({k: v.tolist() for k, v in metrics.items()})
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, m in enumerate(all_metrics):
        for k, v in m.items():
            check(bool(np.isfinite(np.asarray(v)).all()), f"train step {i + 1}: {k} = {v}")
        check(launches[i] == expected,
              f"{label} step {i + 1}: launches {launches[i]}, want {expected}")
    unchanged = []
    for k, p in params.items():
        check(bool(torch.isfinite(p).all()), f"train: {k} is not finite after 5 steps")
        if torch.equal(p, before[k]):
            unchanged.append(k)
    # Only zero-initialised tensors that the loss does not reach may stay as
    # they were: weight decay moves every other one (the cross-attention's
    # q/k biases and norm2's bias feed nothing, with one text token).
    for k in unchanged:
        check(not bool(before[k].any()), f"train: {k} did not change in 5 steps")
    for opt in (state.g_opt, state.d_opt):
        check(opt.notfinite_count.item() == 0 and opt.count.item() == 5,
              f"train: optimizer count {opt.count.item()}, notfinite {opt.notfinite_count.item()}")
    med = float(np.median(step_ms[2:]))
    row = {"batch": cfg.batch_size, "step_ms": step_ms, "median_ms_steps_3_5": med,
           "images_per_s": cfg.batch_size / med * 1e3, "launches_per_step": launches[-1],
           "peak_mem_gib": peak_gib, "unchanged_zero_tensors": unchanged,
           "metrics_step_5": {k: v for k, v in all_metrics[-1].items()
                              if not isinstance(v, list)}, "card": smi}
    print(f"{label} 64x64 batch {cfg.batch_size}: {med:.2f} ms/step (median of steps 3-5), "
          f"{row['images_per_s']:.1f} images/s, on {smi}", flush=True)
    print(f"{label} " + json.dumps(row), flush=True)
    return total, row


def cosine(a, b):
    """Cosine of two vectors; 1 when both are zero (a tensor the loss does not reach)."""
    a, b = a.double(), b.double()
    if not (a.any() or b.any()):
        return 1.0
    return float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-300))


def train_vs_cpu_phase(label="train_vs_cpu", cfg=None, steps=1):
    """One full-width step (or `steps` mini-steps) of the default TrainConfig (or
    `cfg`) at batch 4 on the card (kernels, bf16) and on the CPU (plain
    versions, float32) from the same weights, batches and noise. Adam's first
    moment after one update is (1 - b1) times the clipped (mean) gradient, so
    its cosine between the two is the gradients' cosine."""
    from moegan_tpu_torch.config import TrainConfig
    from moegan_tpu_torch.train.state import create_train_state
    from moegan_tpu_torch.train.step import draw_noise, make_train_step

    cfg = (cfg or TrainConfig()).replace(batch_size=4)
    cpu_cfg = cfg.replace(generator=cfg.generator.replace(compute_dtype="float32"),
                          discriminator=cfg.discriminator.replace(compute_dtype="float32"))
    torch.set_num_threads(os.cpu_count() or 1)
    batches = [synthetic_batch(4, 64, SEED + 5 + 100 * i, "cpu") for i in range(steps)]
    sched = epoch0_schedule(cfg)
    results = {}
    # D's logits of each call; the last call of a step is the G loss's D(fake).
    logits = {"card": [], "cpu": []}
    for name, c, dev in (("card", cfg, "cuda"), ("cpu", cpu_cfg, "cpu")):
        state = create_train_state(c, device=dev, seed=SEED + 6)
        calls = []
        hook = state.discriminator.register_forward_hook(
            lambda mod, args, out: calls.append(out.detach().float().cpu()))
        step = make_train_step(c)
        noise_gen = torch.Generator().manual_seed(SEED + 7)
        t0 = time.perf_counter()
        each = []
        for batch in batches:
            noise = draw_noise(state.generator, 4, noise_gen, device="cpu")
            state, metrics = step(state, batch, sched, noise=noise)
            each.append({k: v.cpu() for k, v in metrics.items()})
            logits[name].append(calls[-1])
        hook.remove()
        if dev == "cuda":
            torch.cuda.synchronize()
        results[name] = (state, each, time.perf_counter() - t0)
    (card, m_card, _), (cpu, m_cpu, cpu_s) = results["card"], results["cpu"]
    names = ("d_loss", "r1_loss", "d_total", "g_loss", "g_total", "kl_loss", "balance_loss")
    each_losses = [{k: [float(a[k]), float(b[k])] for k in names} for a, b in zip(m_card, m_cpu)]
    losses = each_losses[-1]
    # The hinge G loss is -mean D(fake), a mean of logits of both signs that can
    # sit near 0: 5 % of itself says nothing there. Its limit (and g_total's)
    # adds 5 % of the logits' mean magnitude, the scale of each term it averages.
    hinge_scale = [float(x.abs().mean()) if cfg.loss.gan_loss == "hinge" else 0.0
                   for x in logits["cpu"]]
    check(int(card.g_opt.count) == int(cpu.g_opt.count) == 1,
          f"{label}: optimizer count {int(card.g_opt.count)} / {int(cpu.g_opt.count)}, want 1")
    groups = {}
    for net, opt_card, opt_cpu, module in (
            ("generator", card.g_opt, cpu.g_opt, cpu.generator),
            ("discriminator", card.d_opt, cpu.d_opt, cpu.discriminator)):
        a, b = opt_card.mu.cpu(), opt_cpu.mu
        groups[net] = cosine(a, b)
        off = 0
        spans = {}
        for n, p in module.named_parameters():
            top = n.split(".")[0]
            lo, _ = spans.get(top, (off, off))
            spans[top] = (lo, off + p.numel())
            off += p.numel()
        for top, (lo, hi) in spans.items():
            groups[f"{net}.{top}"] = cosine(a[lo:hi], b[lo:hi])
    row = {"losses_card_cpu": losses, "grad_cosine": groups, "cpu_step_s": cpu_s}
    if cfg.loss.gan_loss == "hinge":
        row["g_phase_logit_mean_abs_cpu"] = hinge_scale
    if steps > 1:
        row["losses_card_cpu_each_step"] = each_losses
    print(f"{label} " + json.dumps(row), flush=True)
    # bf16 activations and weights against float32, through two generator
    # passes, four discriminator passes and a double backward: each bf16
    # rounding is 2^-9 relative, a few dozen in sequence.
    for i, step_losses in enumerate(each_losses):
        for k, (a, b) in step_losses.items():
            lim = 0.05 * abs(b) + (1e-4 if k == "balance_loss" else 1e-6)
            if k in ("g_loss", "g_total"):
                lim += 0.05 * hinge_scale[i]
            check(abs(a - b) <= lim, f"{label} step {i + 1}: {k} card {a} cpu {b} (limit {lim})")
    # The whole generator's gradient passes through more bf16 roundings (two
    # generator passes and D) than the shallow discriminator's.
    for k, c in groups.items():
        floor = {"generator": 0.95, "discriminator": 0.99}.get(k, 0.9)
        check(c >= floor, f"{label}: gradient cosine of {k} {c} < {floor}")
    return losses, groups


# --- phase 8: the expert-parallel combine kernels against their plain versions ---------


def combine_args(dev, E, C, T, onehot, seed):
    """A rank's inputs to the combine at expert parallelism 4 / E: E local experts of
    4, probs = the local columns of a softmax (or one-hot) over 4, weights at the
    init scales."""
    g = torch.Generator(device=dev).manual_seed(seed)
    F_ = 4 * C
    probs = torch.softmax(torch.randn((T, 4), generator=g, device=dev) * 2, dim=-1)
    if onehot:
        probs = torch.nn.functional.one_hot(probs.argmax(-1), 4).float()

    def ru(*shape, bound):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * bound

    return [torch.randn((T, C), generator=g, device=dev).to(torch.bfloat16),
            probs[:, :E].contiguous(),
            ru(E, C, F_, bound=C ** -0.5).to(torch.bfloat16), ru(E, F_, bound=C ** -0.5),
            ru(E, F_, C, bound=F_ ** -0.5).to(torch.bfloat16), ru(E, C, bound=F_ ** -0.5)]


def combine_phase(dev, tfm):
    """`moe_ffn_combine` and `moe_ffn_combine_bwd` against their plain versions at
    the five MoE blocks of the 64x64 step at batch 64, for E_local = 2 (expert
    parallelism 2, phase 9's layout) and 1 (expert parallelism 4)."""
    fwd_rows, bwd_rows = [], []
    names = ("dx", "dprobs", "dw1", "db1", "dw2", "db2")
    for E in (2, 1):
        for res, C in TRAIN_MOE:
            T, F_ = B_TRAIN * res * res, 4 * C
            errs = {}
            for onehot in (False, True):
                args = combine_args(dev, E, C, T, onehot, seed=200 + res + 10 * E + onehot)
                out = tfm.moe_ffn_combine(*args)
                again = tfm.moe_ffn_combine(*args)
                want = tfm.moe_ffn_combine_reference(*args)
                torch.cuda.synchronize()
                label = f"combine fwd E={E} res {res} {'one-hot' if onehot else 'soft'}"
                check(torch.equal(out, again), f"{label}: two calls differ")
                err = (out.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                # As moe_compare: the final bf16 rounding of out and of p*h.
                tol = 4 * 2.0 ** -8 * scale
                check(err <= tol, f"{label}: max |out - plain| {err} > {tol} (max {scale})")
                errs["onehot" if onehot else "soft"] = [err, scale]
                if onehot:
                    hard_ms = time_ms(lambda: tfm.moe_ffn_combine(*args), 10)
                    selections = float((args[1] > 0).sum().item())
                else:
                    soft_args = args
                del out, again, want
            x, probs, w1, b1, w2, b2 = soft_args
            ms = time_ms(lambda: tfm.moe_ffn_combine(*soft_args), 10)
            plain_ms = time_ms(lambda: tfm.moe_ffn_combine_reference(*soft_args), 3)
            w_bytes = 2.0 * E * C * F_ * 2 + (E * F_ + E * C) * 4
            # x and probs read, the weights read once, out written (soft routing:
            # every token weighs every local expert)
            flops = 4.0 * T * C * F_ * E
            nbytes = T * C * 2 + T * E * 4 + w_bytes + T * C * 2
            b_ms, b_by = bound_ms(flops, nbytes)
            fwd_rows.append(dict(E_local=E, res=res, T=T, C=C, F=F_, max_abs_err=max(
                e for e, _ in errs.values()), errs=errs, ms=ms, onehot_ms=hard_ms,
                onehot_selections=selections, plain_ms=plain_ms, flops=flops, bytes=nbytes,
                bound_ms=b_ms, bound_by=b_by, plan=list(tfm.kernel_plan(T, C, F_, E, dev))))
            print("moe_combine_fwd " + json.dumps(fwd_rows[-1]), flush=True)

            g = torch.Generator(device=dev).manual_seed(300 + res + E)
            dout = (torch.randn((T, C), generator=g, device=dev) * 0.1).to(torch.bfloat16)
            got = tfm.moe_ffn_combine_bwd(*soft_args, dout)
            again = tfm.moe_ffn_combine_bwd(*soft_args, dout)
            want = tfm.moe_ffn_combine_bwd_reference(*soft_args, dout)
            torch.cuda.synchronize()
            berrs = {}
            for name, a, b, c in zip(names, got, again, want):
                check(torch.equal(a, b), f"combine bwd E={E} res {res}: two calls give "
                                         f"different {name}")
                err = (a.float() - c.float()).abs().max().item()
                ref = c.float().abs().max().item()
                # As moe_bwd_phase: dz and p*h rounded to bf16 before sums over
                # up to 262k tokens or 4096 hidden units.
                check(err <= 2e-2 * ref, f"combine bwd E={E} res {res}: max |{name} - plain| "
                                         f"{err} > {2e-2 * ref}")
                berrs[name] = [err, ref]
            del got, again, want
            ms = time_ms(lambda: tfm.moe_ffn_combine_bwd(*soft_args, dout), 5)
            plain_ms = time_ms(lambda: tfm.moe_ffn_combine_bwd_reference(*soft_args, dout), 3)
            flops = 10.0 * T * C * F_ * E
            # x, dout (bf16), probs and the weights read; dx, dprobs and the
            # weight and bias gradients written (fp32)
            nbytes = (2.0 * T * C * 2 + T * E * 4 + w_bytes + T * C * 4 + T * E * 4
                      + 2 * E * C * F_ * 4 + (E * F_ + E * C) * 4)
            b_ms, b_by = bound_ms(flops, nbytes)
            bwd_rows.append(dict(E_local=E, res=res, T=T, C=C, F=F_, max_abs_err=max(
                e for e, _ in berrs.values()), max_rel_err=max(
                e / max(r, 1e-30) for e, r in berrs.values()), errs=berrs, ms=ms,
                plain_ms=plain_ms, flops=flops, bytes=nbytes, bound_ms=b_ms, bound_by=b_by,
                plan=list(tfm.bwd_kernel_plan(T, C, F_, E, dev))))
            print("moe_combine_bwd " + json.dumps(bwd_rows[-1]), flush=True)
            del soft_args, args, dout
            torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


# --- phase 9: the distributed path, two ranks sharing the card over gloo -----------------

DIST_RANKS = 2  # data 1 x expert 2
DIST_STEP_LAUNCHES = {"flash_attention_fwd": 6, "flash_attention_bwd": 3,
                      "fused_moe_fwd": 0, "fused_moe_bwd": 0,
                      "moe_combine_fwd": 10, "moe_combine_bwd": 5,
                      **dict.fromkeys(OPT_IN_KERNELS, 0)}
DIST_EVAL_LAUNCHES = {"flash_attention_fwd": 3, "flash_attention_bwd": 0,
                      "fused_moe_fwd": 0, "fused_moe_bwd": 0,
                      "moe_combine_fwd": 5, "moe_combine_bwd": 0,
                      **dict.fromkeys(OPT_IN_KERNELS, 0)}
DIST_TIMEOUT_S = 600


def dist_cfg():
    from moegan_tpu_torch.config import MeshConfig, TrainConfig

    return TrainConfig(num_epochs=1, seed=SEED + 8, log_interval=1,
                       mesh=MeshConfig(expert_parallelism=DIST_RANKS))


def flat_moments(state):
    """{"generator" | "discriminator": Adam's first moment of the whole parameters,
    flat fp32 on the CPU, in `named_parameters` order}."""
    from moegan_tpu_torch.parallel.sharding import gather_full

    out = {}
    for net, module, opt in (("generator", state.generator, state.g_opt),
                             ("discriminator", state.discriminator, state.d_opt)):
        sizes = [p.numel() for p in module.parameters()]
        named = {n: v.view_as(p) for v, (n, p) in
                 zip(opt.mu.split(sizes), module.named_parameters())}
        if state.mesh is not None:
            named = gather_full(named, state.mesh)
        out[net] = torch.cat([v.reshape(-1).float().cpu() for v in named.values()])
    return out


def dist_rank(rank, port, out_dir, batches, noises, cfg_dict, loop):
    """One rank of phase 9 (run in a spawned process on cuda:0, gloo): the steps
    on the given global batches and noise, then with `loop` the training loop."""
    import datetime

    sys.path.insert(0, ROOT)
    result = {}
    try:
        import torch.distributed as dist

        import moegan_tpu_torch.train.loop as loop_mod
        from moegan_tpu_torch.config import TrainConfig
        from moegan_tpu_torch.data.datasets import synthetic_dataset
        from moegan_tpu_torch.losses.gan import kl_annealing_factor, temperature_factor
        from moegan_tpu_torch.parallel.api import setup_distributed_training

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=DIST_RANKS, timeout=datetime.timedelta(seconds=300))
        cfg = TrainConfig.from_dict(cfg_dict)
        sched = {"temperature_factor": temperature_factor(0),
                 "effective_kl_weight": cfg.loss.kl_weight
                 * kl_annealing_factor(0, cfg.loss.kl_annealing_epochs)}

        # (a) the distributed step on fixed global batches and noise
        mesh, state, step = setup_distributed_training(cfg, device="cuda:0")
        result["mesh"] = [list(mesh.shape), mesh.data_index, mesh.expert_index]
        result["step_launches"], result["step_metrics"] = [], []
        for batch, noise in zip(batches, noises):
            torch.cuda.synchronize()
            reset_counts()
            state, metrics = step(state, batch, sched, noise=noise)
            torch.cuda.synchronize()
            result["step_launches"].append(launch_counts())
            result["step_metrics"].append({k: v.tolist() for k, v in metrics.items()})
        result["moments"] = flat_moments(state)
        result["opt"] = [[o.count.item(), o.notfinite_count.item()]
                         for o in (state.g_opt, state.d_opt)]
        del state, step
        torch.cuda.empty_cache()
        if not loop:
            dist.barrier()
            dist.destroy_process_group()
            return

        # (b) train_aurora_gan: one epoch of 3 steps at global batch 64, one
        # validation batch. The step and eval functions are wrapped to count
        # each call's launches on its own and time it (CUDA events).
        calls = {"train": [], "eval": []}

        def counted(kind, fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                reset_counts()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **kw)
                end.record()
                torch.cuda.synchronize()
                calls[kind].append({"ms": start.elapsed_time(end),
                                    "launches": launch_counts()})
                return out
            return run

        def setup(*a, **kw):
            m, st, fn = setup_distributed_training(*a, **kw)
            return m, st, counted("train", fn)

        loop_mod.setup_distributed_training = setup
        make_eval = loop_mod.make_eval_step
        loop_mod.make_eval_step = lambda c: counted("eval", make_eval(c))
        train = synthetic_dataset(3 * cfg.batch_size, 64, seed=SEED + 9)
        val = synthetic_dataset(cfg.batch_size, 64, seed=SEED + 10)
        seen = []
        state = loop_mod.train_aurora_gan(
            train, val, cfg=cfg, device="cuda:0",
            metric_callback=lambda epoch, m: seen.append(dict(m)) is None)
        torch.cuda.synchronize()
        result["loop_calls"] = calls
        result["loop_val"] = seen
        result["loop_steps"] = state.step
        result["loop_params_finite"] = all(
            bool(torch.isfinite(p).all()) for p in list(state.generator.parameters())
            + list(state.discriminator.parameters()))
        result["loop_opt"] = [[o.count.item(), o.notfinite_count.item()]
                              for o in (state.g_opt, state.d_opt)]
        result["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        import traceback

        result["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def distributed_phase(smi, cfg=None, steps=1, loop=True, expected=DIST_STEP_LAUNCHES,
                      label="distributed"):
    """Phase 9: two ranks (data 1 x expert 2) on cuda:0 over gloo, spawned after every
    kernel was built in this process. (a) one distributed step (or `steps`
    steps of `cfg`, default `dist_cfg()`) against the single-process step on
    the same card, weights, batches and noise; (b) with `loop`,
    train_aurora_gan for one epoch of 3 steps and one validation batch."""
    import socket

    import torch.multiprocessing as mp

    from moegan_tpu_torch.train.state import create_train_state
    from moegan_tpu_torch.train.step import draw_noise, make_train_step

    cfg = cfg or dist_cfg()
    batches = [synthetic_batch(cfg.batch_size, 64, SEED + 11 + 100 * i, "cpu")
               for i in range(steps)]
    state = create_train_state(cfg, device="cuda", seed=cfg.seed)
    noise_gen = torch.Generator().manual_seed(SEED + 12)
    noises = [draw_noise(state.generator, cfg.batch_size, noise_gen, device="cpu")
              for _ in range(steps)]
    sched = epoch0_schedule(cfg)
    step = make_train_step(cfg)
    single_each = []
    for batch, noise in zip(batches, noises):
        state, metrics = step(state, batch, sched, noise=noise)
        single_each.append({k: v.tolist() for k, v in metrics.items()})
    torch.cuda.synchronize()
    single_moments = flat_moments(state)
    check(state.g_opt.count.item() == 1, f"{label}: single-card optimizer count "
                                         f"{state.g_opt.count.item()}")
    del state, step
    torch.cuda.empty_cache()

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix="moegan_smoke_dist_")
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=dist_rank, args=(r, port, out_dir, batches, noises,
                                                 cfg.to_dict(), loop))
             for r in range(DIST_RANKS)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + DIST_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)
    wall_s = time.perf_counter() - t0
    check(not hung, f"{label}: ranks {hung} still ran after {DIST_TIMEOUT_S} s")
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(out_dir, f"rank{r}.pt")
        res = torch.load(path, weights_only=False) if os.path.exists(path) else {}
        check("error" not in res, f"{label} rank {r} failed:\n{res.get('error')}")
        check(p.exitcode == 0 and res, f"{label} rank {r}: exit code {p.exitcode}")
        results.append(res)
    shutil.rmtree(out_dir, ignore_errors=True)

    report = {"layout": "data 1 x expert 2", "wall_s": wall_s, "card": smi,
              "note": "two ranks sharing one card over gloo: not a multi-GPU number"}
    losses = ("d_loss", "r1_loss", "d_total", "g_loss", "g_total", "kl_loss", "balance_loss")
    for r, res in enumerate(results):
        check(res["mesh"] == [[1, DIST_RANKS], 0, r], f"{label} rank {r}: mesh {res['mesh']}")
        for i, (launched, got, want) in enumerate(zip(res["step_launches"], res["step_metrics"],
                                                      single_each)):
            check(launched == expected, f"{label} rank {r} step {i + 1}: launches {launched}")
            for k in losses:
                a, b = got[k], want[k]
                # The sharded path routes through the router in fp32 on x as it
                # is; the fused kernel's router works from bf16 tokens and
                # weights. bf16 activations over two generator passes and four
                # D passes.
                lim = 0.02 * abs(b) + (1e-4 if k == "balance_loss" else 1e-6)
                check(abs(a - b) <= lim, f"{label} rank {r} step {i + 1}: {k} {a} against "
                                         f"single {b}")
        check(res["opt"] == [[1, 0], [1, 0]], f"{label} rank {r}: optimizer counts {res['opt']}")
        cos = {net: cosine(res["moments"][net], single_moments[net])
               for net in ("generator", "discriminator")}
        for net, c in cos.items():
            check(c >= 0.99, f"{label} rank {r}: gradient cosine of {net} {c} < 0.99")
        report[f"rank{r}"] = {
            "step_vs_single": [{k: [got[k], want[k]] for k in losses}
                               for got, want in zip(res["step_metrics"], single_each)],
            "grad_cosine": cos, "step_launches": res["step_launches"]}
        if not loop:
            continue
        calls = res["loop_calls"]
        check(len(calls["train"]) == 3 and len(calls["eval"]) == 1,
              f"{label} rank {r}: {len(calls['train'])} steps, {len(calls['eval'])} evals")
        for i, c in enumerate(calls["train"]):
            check(c["launches"] == expected,
                  f"{label} rank {r} loop step {i + 1}: launches {c['launches']}")
        check(calls["eval"][0]["launches"] == DIST_EVAL_LAUNCHES,
              f"{label} rank {r} eval: launches {calls['eval'][0]['launches']}")
        check(res["loop_steps"] == 3 and res["loop_params_finite"],
              f"{label} rank {r}: {res['loop_steps']} steps, params finite "
              f"{res['loop_params_finite']}")
        check(res["loop_opt"] == [[3, 0], [3, 0]],
              f"{label} rank {r}: optimizer counts {res['loop_opt']}")
        check(len(res["loop_val"]) == 1 and all(np.isfinite(v) for v in res["loop_val"][0].values()),
              f"{label} rank {r}: validation {res['loop_val']}")
        report[f"rank{r}"].update({
            "loop_step_ms": [c["ms"] for c in calls["train"]],
            "loop_eval_ms": calls["eval"][0]["ms"],
            "loop_launches_per_step": [c["launches"] for c in calls["train"]],
            "eval_launches": calls["eval"][0]["launches"], "val": res["loop_val"][0],
            "peak_mem_gib": res["peak_mem_gib"]})
    if not loop:
        print(f"{label} " + json.dumps(report), flush=True)
        # the main path's launches: rank 0's steps
        return {k: sum(c[k] for c in results[0]["step_launches"]) for k in expected}, report
    step_ms = results[0]["loop_calls"]["train"]
    med = float(np.median([c["ms"] for c in step_ms]))
    report["median_step_ms_rank0"] = med
    print(f"{label} (2 ranks sharing one card over gloo, not a multi-GPU number): "
          f"{med:.1f} ms/step (median of 3, rank 0) on {smi}", flush=True)
    print(f"{label} " + json.dumps(report), flush=True)
    # the main path's launches: rank 0's loop, 3 steps and the validation batch
    launches = {k: sum(c["launches"][k] for c in step_ms) + results[0]["loop_calls"]["eval"][0][
        "launches"][k] for k in DIST_STEP_LAUNCHES}
    return launches, report


# --- phase 10: the opt-in kernel configuration ---------------------------------------------

OPT_IN_FLAGS = {"MOEGAN_FUSED_LN": "1", "MOEGAN_PALLAS_MOE_BWD": "3"}
OPT_IN_STEP_LAUNCHES = {"flash_attention_fwd": 6, "flash_attention_bwd": 3,
                        "fused_moe_fwd": 10, "fused_moe_bwd": 0,
                        "moe_combine_fwd": 0, "moe_combine_bwd": 0,
                        # norm1 and norm3 of 5 blocks in 2 generator forwards; the
                        # G phase's backward; one legacy backward per MoE block
                        "layer_norm_fwd": 20, "layer_norm_bwd": 10,
                        "moe_bwd_dx": 5, "moe_bwd_dw2": 5, "moe_bwd_dw1": 5}


@contextlib.contextmanager
def env_flags(flags):
    """Set the environment variables `flags` inside the block, restored after it."""
    saved = {k: os.environ.get(k) for k in flags}
    os.environ.update(flags)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def layer_norm_phase(dev, tln):
    """(a) Both LayerNorm kernels against their plain twins at the five norm
    shapes of the 64x64 step at batch 64 (x [B*T, C] bf16), two calls
    bit-identical, with times for the kernel, the twin and F.layer_norm:
    `ms` (CUDA events, the host's cost per call included), `device_ms` (a
    CUDA graph's replay, inputs hot in L2), `cold_device_ms` (the same over
    rotating input copies, reads from device memory) and `host_us` (host
    time a call, enqueued without a synchronize)."""
    import torch.nn.functional as F

    fwd_rows, bwd_rows = [], []
    for res, C in TRAIN_MOE:
        N = B_TRAIN * res * res
        g = torch.Generator(device=dev).manual_seed(500 + res)
        x = (torch.randn((N, C), generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn(C, generator=g, device=dev)
        bias = 0.1 * torch.randn(C, generator=g, device=dev)
        dy = (torch.randn((N, C), generator=g, device=dev) * 0.1).to(torch.bfloat16)
        y, y2 = tln.layer_norm_fwd(x, scale, bias), tln.layer_norm_fwd(x, scale, bias)
        want = tln.layer_norm(x, scale, bias)
        got, again = tln.layer_norm_bwd(x, scale, dy), tln.layer_norm_bwd(x, scale, dy)
        want_b = tln.layer_norm_bwd_reference(x, scale, dy)
        torch.cuda.synchronize()
        label = f"layer norm res {res} (N={N}, C={C})"
        check(torch.equal(y, y2), f"{label}: two forward calls differ")
        err = (y.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        # Both round fp32 statistics once to bf16; their sums run in other orders.
        check(err <= 2.0 ** -8 * top, f"{label}: max |y - plain| {err} (max |y| {top})")
        errs = {"y": [err, top]}
        for name, a, b, c, lim in zip(("dx", "dscale", "dbias"), got, again, want_b,
                                      (2 * 2.0 ** -8, 1e-3, 1e-3)):
            check(torch.equal(a, b), f"{label}: two backward calls give different {name}")
            e = (a.float() - c.float()).abs().max().item()
            r = c.float().abs().max().item()
            # dx: one bf16 rounding of a difference of fp32 means; dscale and
            # dbias: fp32 sums over N rows in other orders.
            check(e <= lim * r, f"{label}: max |{name} - plain| {e} > {lim} * {r}")
            errs[name] = [e, r]
        del y, y2, want, got, again, want_b
        sb, bb = scale.to(torch.bfloat16), bias.to(torch.bfloat16)

        def lib_fwd(x):
            return F.layer_norm(x, (C,), sb, bb, 1e-5)

        def lib_bwd(x, dy):
            xr = x.detach().requires_grad_(True)
            sr, br = sb.detach().requires_grad_(True), bb.detach().requires_grad_(True)
            return torch.autograd.grad(F.layer_norm(xr, (C,), sr, br, 1e-5), (xr, sr, br), dy)

        # x read and y written (bf16), scale and bias read; ~8 fp32 operations
        # per element (two sums, the centring, the square, the scale, the shift)
        nbytes = 4.0 * N * C + 8.0 * C
        b_ms, b_by = bound_ms(8.0 * N * C, nbytes, PEAK_FP32_FLOPS)
        xs = [(x,)] + [(x.clone(),) for _ in range(cold_copies(nbytes) - 1)]
        fwd_rows.append(dict(
            res=res, N=N, C=C, max_abs_err=err, max_abs_ref=top,
            ms=time_ms(lambda: tln.layer_norm_fwd(x, scale, bias), 20),
            device_ms=graph_ms(lambda: tln.layer_norm_fwd(x, scale, bias), 20),
            cold_device_ms=cold_graph_ms(lambda a: tln.layer_norm_fwd(a, scale, bias), xs),
            cold_copies=len(xs), host_us=host_us(lambda: tln.layer_norm_fwd(x, scale, bias)),
            plain_ms=time_ms(lambda: tln.layer_norm(x, scale, bias), 10),
            library_ms=time_ms(lambda: lib_fwd(x), 20), library_device_ms=graph_ms(
                lambda: lib_fwd(x), 20), library_cold_device_ms=cold_graph_ms(lib_fwd, xs),
            flops=8.0 * N * C, bytes=nbytes, bound_ms=b_ms, bound_by=b_by))
        print("layer_norm_fwd " + json.dumps(fwd_rows[-1]), flush=True)
        del xs
        # x and dy read, dx written (bf16), scale read, dscale and dbias
        # written; ~16 fp32 operations per element
        nbytes = 6.0 * N * C + 12.0 * C
        b_ms, b_by = bound_ms(16.0 * N * C, nbytes, PEAK_FP32_FLOPS)
        xs = [(x, dy)] + [(x.clone(), dy.clone()) for _ in range(cold_copies(nbytes) - 1)]
        bwd_rows.append(dict(
            res=res, N=N, C=C, max_abs_err=max(e for e, _ in errs.values()), errs=errs,
            ms=time_ms(lambda: tln.layer_norm_bwd(x, scale, dy), 20),
            device_ms=graph_ms(lambda: tln.layer_norm_bwd(x, scale, dy), 20),
            cold_device_ms=cold_graph_ms(lambda a, b: tln.layer_norm_bwd(a, scale, b), xs),
            cold_copies=len(xs), host_us=host_us(lambda: tln.layer_norm_bwd(x, scale, dy)),
            plain_ms=time_ms(lambda: tln.layer_norm_bwd_reference(x, scale, dy), 10),
            # F.layer_norm's forward and backward
            library_ms=time_ms(lambda: lib_bwd(x, dy), 20),
            library_device_ms=graph_ms(lambda: lib_bwd(x, dy), 20),
            library_cold_device_ms=cold_graph_ms(lib_bwd, xs),
            flops=16.0 * N * C, bytes=nbytes, bound_ms=b_ms, bound_by=b_by))
        print("layer_norm_bwd " + json.dumps(bwd_rows[-1]), flush=True)
        del x, dy, xs
    torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


LEGACY_UNITS = {"moe_bwd_dx": 8.0, "moe_bwd_dw2": 4.0, "moe_bwd_dw1": 6.0}


def legacy_moe_phase(dev, tfm):
    """(b) The three legacy MoE backward entry points, each against its own
    plain twin at the five MoE blocks of the step at batch 64, two calls
    bit-identical; each with the forward's routing, as the step launches
    them; then `FusedMoEFunction`'s nine gradients under
    MOEGAN_PALLAS_MOE_BWD=3 against those under =1."""
    rows = {name: [] for name in LEGACY_UNITS}
    names = ("x", "fw", "cw_f", "text_logits", "inv_temp", "w1", "b1", "w2", "b2")
    for res, C in TRAIN_MOE:
        T, E, F_ = B_TRAIN * res * res, 4, 4 * C
        args = moe_args(dev, C, T, seed=400 + res)
        g = torch.Generator(device=dev).manual_seed(600 + res)
        dout = (torch.randn((T, C), generator=g, device=dev) * 0.1).to(torch.bfloat16)
        dprobs = torch.randn((T, E), generator=g, device=dev) * 0.1
        x, fw, cw, tl, it, w1, b1, w2, b2 = args
        probs = tfm.fused_moe_ffn(*args, hard=False)[1]  # the forward's routing
        weights = E * C * F_ * 2 + E * F_ * 4
        for name, fn, ref, inputs, nbytes in (
                ("moe_bwd_dx", tfm.moe_bwd_dx, tfm.moe_bwd_dx_reference, args,
                 # x, dout, probs read; W1, b1, W2, b2 read; dx and dp written (fp32)
                 2 * T * C * 2 + T * E * 4 + 2 * weights + E * C * 4 + T * C * 4 + T * E * 4),
                ("moe_bwd_dw2", tfm.moe_bwd_dw2, tfm.moe_bwd_dw2_reference, args[:7],
                 # x, dout, probs, W1, b1 read; dW2 and db2 written (fp32)
                 2 * T * C * 2 + T * E * 4 + weights + E * F_ * C * 4 + E * C * 4),
                ("moe_bwd_dw1", tfm.moe_bwd_dw1, tfm.moe_bwd_dw1_reference, args[:8],
                 # x, dout, probs, W1, b1, W2 read; dW1 and db1 written (fp32)
                 2 * T * C * 2 + T * E * 4 + weights + E * F_ * C * 2 + E * C * F_ * 4
                 + E * F_ * 4)):
            # As FusedMoEFunction launches them under =3: with the forward's routing.
            kw = {"probs": probs}
            want = ref(*inputs, dout)
            errs = {}
            got, again = fn(*inputs, dout, **kw), fn(*inputs, dout, **kw)
            torch.cuda.synchronize()
            for i, (a, b, c) in enumerate(zip(got, again, want)):
                check(torch.equal(a, b), f"{name} res {res}: two calls give different output {i}")
                e = (a - c).abs().max().item()
                r = c.abs().max().item()
                # As moe_bwd_phase: bf16 p*dout and dz before sums over up to
                # 262k tokens or 8192 hidden units.
                check(e <= 2e-2 * r, f"{name} res {res}: output {i} max |err| {e} > 2e-2 * {r}")
                errs[i] = [e, r]
            del got, again, want
            ms = time_ms(lambda: fn(*inputs, dout, **kw), 5)
            dev_ms = graph_ms(lambda: fn(*inputs, dout, **kw), 5)
            plain_ms = time_ms(lambda: ref(*inputs, dout), 3)
            flops = LEGACY_UNITS[name] * T * C * F_ * E
            b_ms, b_by = bound_ms(flops, float(nbytes))
            plan = tfm.legacy_kernel_plan(name[8:], T, C, F_, E, dev)
            extra = {}
            if name != "moe_bwd_dx":
                extra["route"] = "scratch" if plan.scratch else "recompute"
            rows[name].append(dict(res=res, T=T, C=C, F=F_, E=E,
                                   max_abs_err=max(e for e, _ in errs.values()),
                                   max_rel_err=max(e / max(r, 1e-30) for e, r in errs.values()),
                                   errs=errs, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                   flops=flops, bytes=float(nbytes), bound_ms=b_ms,
                                   bound_by=b_by,
                                   # T*E*F GELUs in each entry point (with gelu'
                                   # in dx and dW1, without in dW2), 2 SFU
                                   # operations each
                                   gelu_floor_ms=exp_floor_ms(2.0 * T * E * F_),
                                   plan=list(plan), **extra))
            print(f"{name} " + json.dumps(rows[name][-1]), flush=True)

        def grads(mode):
            with env_flags({"MOEGAN_PALLAS_MOE_BWD": mode}):
                leaves = [a.detach().requires_grad_(True) for a in args]
                out, probs = tfm.FusedMoEFunction.apply(*leaves)
                return torch.autograd.grad((out, probs), leaves, (dout, dprobs))

        legacy, fused = grads("3"), grads("1")
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(names, legacy, fused):
            e = (a.float() - b.float()).abs().max().item()
            r = b.float().abs().max().item()
            # the same gradient, bf16 rounding at other places (p*dout against
            # p*h): each within moe_bwd_phase's limit of the plain version
            check(e <= 2e-2 * r, f"FusedMoEFunction res {res}: d{name} under =3 against =1 "
                                 f"{e} > 2e-2 * {r}")
            errs[name] = [e, r]
        print("legacy_vs_fused " + json.dumps({"res": res, "errs": errs}), flush=True)
        del args, dout, dprobs, legacy, fused, probs
        torch.cuda.empty_cache()
    return rows


def served_opt_in_phase(cfg, state_dict):
    """(d) One batch-16 generator call with MOEGAN_FUSED_LN=1 against the default
    call on the same weights and z, on the card: once free (its own routing,
    reported) and once pinned to the default call's routing (checked to phase
    5's limit). Each call launches the LayerNorm forward 10 times."""
    from moegan_tpu_torch.infer.sample import Sampler

    rng = np.random.default_rng(SEED + 13)
    z, txt = (torch.from_numpy(rng.standard_normal((N, 512)).astype(np.float32)).cuda()
              for _ in range(2))
    psi = torch.linspace(0.5, 1.0, N, device="cuda")
    card = Sampler(cfg, state_dict, device="cuda")
    with torch.inference_mode():
        ref = card.gen(z, txt, psi)
        with env_flags({"MOEGAN_FUSED_LN": "1"}):
            reset_counts()
            free = card.gen(z, txt, psi)
            torch.cuda.synchronize()
            free_launches = launch_counts()
            with pinned_routing([p.float() for p in ref.routing]):
                held = card.gen(z, txt, psi)
    raw_ref = ref.image.float().cpu().numpy()
    stats = {"pinned": image_stats(held.image.float().cpu().numpy(), raw_ref),
             "free": image_stats(free.image.float().cpu().numpy(), raw_ref),
             "top1_agreement": [float((a.argmax(-1) == b.argmax(-1)).float().mean())
                                for a, b in zip(free.routing, ref.routing)],
             "launches": free_launches}
    print("served_opt_in " + json.dumps(stats), flush=True)
    check(np.isfinite(held.image.float().cpu().numpy()).all(), "opt-in images are not finite")
    check(free_launches["layer_norm_fwd"] == 10 and free_launches["layer_norm_bwd"] == 0,
          f"opt-in generator call: launches {free_launches}")
    rel = stats["pinned"]["raw_max_rel_diff"]
    check(rel <= 0.05, f"opt-in generator call against default (pinned routing): {rel} > 0.05")
    return stats


def opt_in_phase(dev, smi, cfg, state_dict):
    """Phase 10: the JAX package's opt-in kernel configuration, flags set here
    alone and restored after: (a) LayerNorm kernels, (b) the legacy MoE
    backward, (c) the training step (5 steps at batch 64, and the batch-4 step
    against the CPU's under the same flags), (d) one served generator call."""
    from moegan_tpu_torch.ops import fused_moe as tfm
    from moegan_tpu_torch.ops import layernorm as tln

    ln_fwd_rows, ln_bwd_rows = layer_norm_phase(dev, tln)
    legacy_rows = legacy_moe_phase(dev, tfm)
    with env_flags(OPT_IN_FLAGS):
        launches, row = train_phase(smi, OPT_IN_STEP_LAUNCHES, "train_opt_in")
        train_vs_cpu_phase("train_vs_cpu_opt_in")
    torch.cuda.empty_cache()
    served_opt_in_phase(cfg, state_dict)
    return launches, ln_fwd_rows, ln_bwd_rows, legacy_rows


# --- phase 11: the training CLI's default run ----------------------------------------------

CLI_BATCH = 32
# The synthetic set holds 64 images (an epoch is 2 steps at batch 32) and the
# validation set 32 (one batch an epoch).
CLI_STEPS_PER_EPOCH = 2
# A validation batch's launches: the eval generator's forwards (hard routing).
EXPECTED_EVAL_LAUNCHES = {"flash_attention_fwd": 3, "fused_moe_fwd": 5}
PROMPT = "a red circle on a dark background"


@contextlib.contextmanager
def timed_steps(times: list, metrics: list):
    """Record the CUDA-event time and the metrics of every training step that
    `train_aurora_gan` takes inside the block."""
    from moegan_tpu_torch.train import loop

    orig = loop.make_train_step

    def make(*args, **kwargs):
        step = orig(*args, **kwargs)

        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(*a, **kw)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            metrics.append({k: v.tolist() for k, v in out[1].items()})
            return out

        return timed

    loop.make_train_step = make
    try:
        yield
    finally:
        loop.make_train_step = orig


def cli_run(argv):
    """`cli.train_model.main(argv)` with every step timed: (state, step ms, step
    metrics, the tower pack the run loaded or None, wall seconds)."""
    from moegan_tpu_torch.cli import train_model
    from moegan_tpu_torch.models import clip

    times, metrics, towers = [], [], []
    load = clip.load_clip_params

    def keep(*args, **kwargs):
        towers.append(load(*args, **kwargs))
        return towers[-1]

    clip.load_clip_params = keep
    t0 = time.perf_counter()
    try:
        with timed_steps(times, metrics):
            state = train_model.main(argv)
        torch.cuda.synchronize()
    finally:
        clip.load_clip_params = load
    return state, times, metrics, (towers or [None])[0], time.perf_counter() - t0


def compare_states(a, b):
    """The largest differences of two training states: parameters in absolute
    terms and relative to each tensor's largest |value|; AdamW's moments in
    relative L2 over all tensors; step and counts."""
    from moegan_tpu_torch.train.state import state_payload

    pa, pb = state_payload(a, 0), state_payload(b, 0)
    out = {"step": (pa["step"], pb["step"]), "param_max_abs": 0.0, "param_max_rel": 0.0,
           "param_share_differing": 0.0}
    n_diff = n_all = 0
    for net in ("generator", "discriminator"):
        for k, v in pb[net].items():
            d = (pa[net][k] - v).abs()
            out["param_max_abs"] = max(out["param_max_abs"], float(d.max()))
            out["param_max_rel"] = max(out["param_max_rel"],
                                       float(d.max() / v.abs().max().clamp_min(1e-30)))
            n_diff += int((d > 0).sum())
            n_all += d.numel()
    out["param_share_differing"] = n_diff / n_all
    for opt in ("optimizer_g", "optimizer_d"):
        out[f"{opt}_counts"] = ((pa[opt]["count"], pa[opt]["notfinite_count"]),
                                (pb[opt]["count"], pb[opt]["notfinite_count"]))
        for m in ("mu", "nu"):
            num = sum(float(((pa[opt][m][k] - v) ** 2).sum()) for k, v in pb[opt][m].items())
            den = sum(float((v ** 2).sum()) for v in pb[opt][m].values())
            out[f"{opt}_{m}_rel_l2"] = (num / max(den, 1e-300)) ** 0.5
    return out


def cli_phase(smi):
    """Phase 11: `python -m moegan_tpu_torch.cli.train_model --synthetic` at the
    default 64x64 configuration on the card, as a user runs it: (1) 2 epochs at
    batch 32 with the CLIP loss (random-init ViT-B/32 towers), every step's
    losses finite, checkpoints and the final msgpack written, the kernels'
    launches counted over the run, ms/step beside the same run without the
    CLIP loss; (2) resumed for a third epoch against an uninterrupted 3-epoch
    run; (3) the written directory served, one string prompt over HTTP, its
    embedding against the CPU's float32 text tower; (4) save and restore timed."""
    from moegan_tpu_torch.cli import train_model
    from moegan_tpu_torch.infer.png import decode_png
    from moegan_tpu_torch.infer.serving import InferenceHandler, make_server
    from moegan_tpu_torch.losses.clip_loss import multi_level_clip_loss
    from moegan_tpu_torch.models.clip import load_clip_params
    from moegan_tpu_torch.train.state import create_train_state
    from moegan_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    root = tempfile.mkdtemp(prefix="moegan_smoke_cli_")
    try:
        run_dir, plain_dir, ckpt_dir = (os.path.join(root, n) for n in ("run", "no_clip", "ckpt"))
        whole_dirs = [os.path.join(root, f"whole_{i}") for i in range(2)]
        base = ["--synthetic", "--batch_size", str(CLI_BATCH)]
        cfg = train_model.config_from_args(train_model.build_parser().parse_args(base))
        taps = sorted(r for r, w in cfg.loss.clip_weights.items() if w > 0)
        # (1) the default run: CLIP loss on
        reset_counts()
        state, times, metrics, towers, run_s = cli_run(base + ["--epochs", "2",
                                                               "--save_dir", run_dir])
        launches = launch_counts()
        steps, evals = 2 * CLI_STEPS_PER_EPOCH, 2
        want = {k: steps * n + evals * EXPECTED_EVAL_LAUNCHES.get(k, 0)
                for k, n in EXPECTED_STEP_LAUNCHES.items()}
        check(launches == want, f"cli: launches {launches}, want {want}")
        check(len(metrics) == steps and state.step == steps, f"cli: {len(metrics)} steps")
        for i, m in enumerate(metrics):
            check(all(f"clip_loss_{r}" in m for r in taps), f"cli step {i + 1}: {sorted(m)}")
            for k, v in m.items():
                check(bool(np.isfinite(np.asarray(v)).all()), f"cli step {i + 1}: {k} = {v}")
        files = sorted(os.listdir(run_dir))
        check(files == ["aurora_model_final.msgpack", "checkpoint_2.pt", "checkpoint_4.pt",
                        "generator_config.json", "metrics.jsonl", "model_math_version.txt"],
              f"cli: the run wrote {files}")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            records = {json.loads(line)["name"] for line in f}
        check({"val_clip_loss", "val_d_loss", "val_g_loss"} <= records, f"cli: {records}")
        # The CLIP loss alone as the G phase runs it: every tap of a batch, one tower pass.
        g = torch.Generator(device="cuda").manual_seed(SEED + 11)
        tap_images = {r: torch.tanh(torch.randn((CLI_BATCH, r, r, 3), generator=g,
                                                device="cuda")) for r in taps}
        text = torch.randn((CLI_BATCH, 512), generator=g, device="cuda")
        clip_loss_ms = time_ms(lambda: multi_level_clip_loss(towers, tap_images, text), 10)
        del towers, tap_images
        torch.cuda.empty_cache()
        _, plain_times, plain_metrics, _, plain_s = cli_run(
            base + ["--epochs", "2", "--no_clip_loss", "--save_dir", plain_dir])
        check(not any(k.startswith("clip_loss") for k in plain_metrics[-1]), "cli: no_clip_loss")

        # (2) resumed for a third epoch, against two uninterrupted 3-epoch runs
        torch.cuda.empty_cache()
        resumed, resumed_times, _, _, resume_s = cli_run(base + ["--epochs", "3", "--resume",
                                                                 "--save_dir", run_dir])
        check(len(resumed_times) == CLI_STEPS_PER_EPOCH, f"resume: {len(resumed_times)} steps")
        whole = []
        for d in whole_dirs:
            torch.cuda.empty_cache()
            whole.append(cli_run(base + ["--epochs", "3", "--save_dir", d]))
        diff = compare_states(resumed, whole[0][0])
        spread = compare_states(whole[1][0], whole[0][0])
        # cuDNN's, grid_sample's and the bilinear upsample's backward kernels add
        # in no fixed order, so two runs from the same seed differ by rounding,
        # which the adversarial steps grow (the CPU test holds resume bit for
        # bit). The resumed run must be as close to the uninterrupted one as a
        # second uninterrupted run is: each difference within 4x that spread,
        # step and counts equal. A resume that drew other noise or data would
        # put AdamW's first moment off by the last steps' whole share (~50 %).
        print(f"resume: resumed against uninterrupted 3-epoch run: {json.dumps(diff)}; two "
              f"uninterrupted runs: {json.dumps(spread)}", flush=True)
        check(diff["step"][0] == diff["step"][1] == 3 * CLI_STEPS_PER_EPOCH, f"resume: {diff}")
        opts = ("optimizer_g", "optimizer_d")
        check(all(diff[f"{o}_counts"][0] == diff[f"{o}_counts"][1] for o in opts),
              f"resume: {diff}")
        for key in ["param_max_abs"] + [f"{o}_{m}_rel_l2" for o in opts for m in ("mu", "nu")]:
            check(diff[key] <= 4 * spread[key] + 1e-6,
                  f"resume: {key} {diff[key]} against two uninterrupted runs' {spread[key]}")
        whole_times = whole[0][1] + whole[1][1]
        clip_ms = float(np.median(whole[0][1][2:] + whole[1][1][2:]))
        plain_ms = float(np.median(plain_times[2:]))
        print(f"cli 64x64 batch {CLI_BATCH}: {clip_ms:.2f} ms/step with the CLIP loss (taps "
              f"{taps}; median of steps 3-6 of two 3-epoch runs), {plain_ms:.2f} without "
              f"(steps 3-4); the CLIP loss alone {clip_loss_ms:.2f} ms, "
              f"{100 * clip_loss_ms / clip_ms:.1f} % of the step; on {smi}", flush=True)
        whole_s = [w[4] for w in whole]
        del whole
        torch.cuda.empty_cache()

        # (3) the written directory served: a string prompt over HTTP
        t_serve = time.perf_counter()
        reset_counts()
        handler = InferenceHandler.from_model_dir(run_dir, device="cuda")
        served = handler.sampler.gen.state_dict()  # the resumed run's final generator
        for k, v in resumed.generator.state_dict().items():
            check(torch.equal(served[k], v), f"serve: {k} differs from the trained generator")
        handler.batcher.prewarm()
        server = make_server(handler, host="127.0.0.1", port=0)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        results = [None, None]
        try:
            for i in range(2):  # the first call of the text tower pays for its set-up
                request_once(url, PROMPT, 7, results, i)
            images = handler.sampler(PROMPT, num_samples=4, seed=7)
            card_emb = handler.sampler.encode_text(PROMPT)[0].float().cpu()
            # Where a prompt's time goes: the text tower on this (warm) thread,
            # and on fresh threads, as each HTTP job runs on a thread of its own.
            encode_ms = time_ms(lambda: handler.sampler.encode_text(PROMPT), 5)
            thread_ms = []

            def encode_on_new_thread():
                t0 = time.perf_counter()
                handler.sampler.encode_text(PROMPT)
                torch.cuda.synchronize()
                thread_ms.append((time.perf_counter() - t0) * 1e3)

            for _ in range(2):
                th_enc = threading.Thread(target=encode_on_new_thread)
                th_enc.start()
                th_enc.join(120)
            torch.cuda.synchronize()
        finally:
            server.shutdown()
            server.server_close()
            handler.close()
            th.join(30)
        serve_launches = launch_counts()
        for i, r in enumerate(results):
            check(r is not None and r[0]["status"] == "COMPLETED", f"serve prompt {i}: {r}")
            imgs = [decode_png(base64.b64decode(b)) for b in r[0]["data"]["images"]]
            check(len(imgs) == 4 and all(im.shape == (64, 64, 3) for im in imgs),
                  f"serve prompt {i}: images")
            check(r[0]["data"]["prompt"] == PROMPT, f"serve prompt {i}: {r[0]['data']['prompt']}")
        check(tuple(images.shape) == (4, 64, 64, 3) and bool(torch.isfinite(images).all()),
              "serve: sampler images")
        for name in ("flash_attention_fwd", "fused_moe_fwd"):
            check(serve_launches[name] > 0, f"serve: {name} was not launched")
        with torch.no_grad():
            cpu_emb = load_clip_params(device="cpu", compute_dtype="float32").encode_text(PROMPT)[0]
        emb_cos = cosine(card_emb, cpu_emb)
        check(emb_cos >= 0.999, f"serve: text embedding cosine {emb_cos} against the CPU's")
        lat = [r[1] for r in results]
        serve_s = time.perf_counter() - t_serve
        print(f"serve string prompt: latency ms first={lat[0]:.1f} second={lat[1]:.1f}; text "
              f"tower {encode_ms:.2f} ms on a warm thread, {[round(x, 1) for x in thread_ms]} ms "
              f"on two fresh threads; text embedding cosine against the CPU float32 tower "
              f"{emb_cos:.6f}", flush=True)

        # (4) checkpoint I/O
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(ckpt_dir, resumed, 2)
        save_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, f"checkpoint_{resumed.step}.pt"))
        fresh = create_train_state(cfg, device="cuda", seed=SEED + 9)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh, start_epoch = restore_checkpoint(ckpt_dir, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(start_epoch == 3 and compare_states(fresh, resumed)["param_max_abs"] == 0.0,
              "checkpoint: the restored state differs from the saved one")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row = {"batch": CLI_BATCH, "clip_taps": taps, "step_ms": times, "no_clip_step_ms": plain_times,
           "whole_3_epoch_step_ms": whole_times, "ms_per_step_clip": clip_ms,
           "ms_per_step_no_clip": plain_ms, "clip_loss_ms": clip_loss_ms,
           "clip_share_of_step": clip_loss_ms / clip_ms, "launches": launches,
           "resume_diff": diff, "two_uninterrupted_runs_diff": spread,
           "serve_latency_ms": lat, "encode_text_ms": encode_ms,
           "encode_text_fresh_thread_ms": thread_ms, "text_embedding_cosine": emb_cos,
           "save_s": save_s,
           "restore_s": restore_s, "checkpoint_bytes": ckpt_bytes,
           "wall_s": {"run": run_s, "no_clip": plain_s, "resume": resume_s, "whole": whole_s,
                      "serve": serve_s}, "card": smi}
    print(f"checkpoint: save {save_s:.3f} s, restore {restore_s:.3f} s, {ckpt_bytes} bytes",
          flush=True)
    print("cli " + json.dumps(row), flush=True)
    return launches


# --- phase 12: the training configurations ------------------------------------------------

# tpu_flagship_config's attention (res, heads, head_dim) and MoE (res, C) rungs.
FLAGSHIP_ATTN = ((16, 8, 32), (32, 8, 16), (64, 2, 32))
FLAGSHIP_MOE = ((4, 512), (8, 512), (16, 256), (32, 128), (64, 64))
# shared_fake: one differentiable generator forward a step (its flash forwards
# keep lse for the backward) and its backward; no D-phase generator forward.
SHARED_STEP_LAUNCHES = {**EXPECTED_STEP_LAUNCHES, "flash_attention_fwd": 3, "fused_moe_fwd": 5}
DIST_SHARED_LAUNCHES = {**DIST_STEP_LAUNCHES, "flash_attention_fwd": 3, "moe_combine_fwd": 5}
# Generator tensors carried into stages 32 and 64 of the default 16 -> 32 -> 64
# ladder; tests/test_torch_progressive.py pins the same counts against the JAX package.
PROGRESSIVE_TRANSFERS = {32: 192, 64: 245}
PROGRESSIVE_BATCH = 32


class LineLog:
    """A MetricLogger that keeps its lines and metric names."""

    def __init__(self):
        self.lines, self.metrics = [], []

    def log_line(self, msg):
        self.lines.append(msg)

    def log_metric(self, name, value, step=None):
        self.metrics.append((name, float(value), step))

    def log_metrics(self, metrics, step=None):
        for k, v in metrics.items():
            self.log_metric(k, v, step)

    def log_vector(self, name, values, step=None):
        self.lines.append(f"{name}: {values}")


def with_options(cfg, hinge=True):
    """`cfg` with shared_fake, gradient accumulation over 2 mini-steps, the switch
    balance over every block and (with `hinge`) the hinge loss."""
    loss = cfg.loss.replace(balance_kind="switch", balance_all_blocks=True)
    if hinge:
        loss = loss.replace(gan_loss="hinge")
    return cfg.replace(shared_fake=True, gradient_accumulation_steps=2, loss=loss)


def params_changed(params, before):
    """Whether every tensor changed; only zero-initialised tensors that the loss
    does not reach may stay as they were (weight decay moves every other one)."""
    for k, p in params.items():
        if torch.equal(p, before[k]) and bool(before[k].any()):
            return False
    return True


def options_phase(smi, cfg):
    """(b) 4 mini-steps of `cfg` (every option, 2 mini-steps an update) at batch 64:
    each mini-step's launches are the shared-fake step's; the parameters stay
    bit for bit after mini-steps 1 and 3 and change after 2 and 4."""
    from moegan_tpu_torch.train.state import create_train_state
    from moegan_tpu_torch.train.step import make_train_step

    state = create_train_state(cfg, device="cuda", seed=SEED + 13)
    step = make_train_step(cfg)
    params = dict(state.generator.named_parameters(prefix="generator"))
    params.update(state.discriminator.named_parameters(prefix="discriminator"))
    sched = epoch0_schedule(cfg)
    noise_gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    step_ms, launches, all_metrics = [], [], []
    total = dict.fromkeys(SHARED_STEP_LAUNCHES, 0)
    for i in range(4):
        batch = synthetic_batch(cfg.batch_size, 64, SEED + 15 + i, "cuda")
        before = {k: p.detach().clone() for k, p in params.items()}
        torch.cuda.synchronize()
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch, sched, generator=noise_gen)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        counts = launch_counts()
        launches.append(counts)
        for k, n in counts.items():
            total[k] += n
        all_metrics.append({k: v.tolist() for k, v in metrics.items()})
        check(counts == SHARED_STEP_LAUNCHES,
              f"options mini-step {i + 1}: launches {counts}, want {SHARED_STEP_LAUNCHES}")
        for k, v in all_metrics[-1].items():
            check(bool(np.isfinite(np.asarray(v)).all()), f"options mini-step {i + 1}: {k} = {v}")
        if i % 2 == 0:
            for k, p in params.items():
                check(torch.equal(p, before[k]), f"options mini-step {i + 1}: {k} changed")
        else:
            check(params_changed(params, before),
                  f"options mini-step {i + 1}: a parameter did not change")
        del before
    for opt in (state.g_opt, state.d_opt):
        got = (opt.count.item(), opt.mini_step.item(), opt.notfinite_count.item())
        check(got == (2, 0, 0), f"options: optimizer (count, mini_step, notfinite) {got}")
    row = {"batch": cfg.batch_size, "mini_step_ms": step_ms,
           "median_ms_mini_steps_2_4": float(np.median(step_ms[1:])),
           "launches_per_mini_step": launches[-1],
           "metrics_mini_step_4": {k: v for k, v in all_metrics[-1].items()
                                   if not isinstance(v, list)}, "card": smi}
    print(f"options (flagship, hinge, switch over all blocks, shared_fake, 2 mini-steps an "
          f"update) batch {cfg.batch_size}: {row['median_ms_mini_steps_2_4']:.2f} ms/mini-step "
          f"(median of 2-4) on {smi}", flush=True)
    print("options " + json.dumps(row), flush=True)
    return total, row


def progressive_phase(smi):
    """(c) `train_progressive` on the synthetic set through stages (16, 1), (32, 1),
    (64, 1) at the default channels and batch 32: each stage's transferred
    tensors, steps and launches, finite parameters."""
    from moegan_tpu_torch.config import TrainConfig
    from moegan_tpu_torch.data.datasets import synthetic_dataset
    from moegan_tpu_torch.train.progressive import train_progressive

    cfg = TrainConfig(batch_size=PROGRESSIVE_BATCH, seed=SEED + 19, log_interval=1)
    train = synthetic_dataset(2 * PROGRESSIVE_BATCH, 64, seed=SEED + 20)
    val = synthetic_dataset(PROGRESSIVE_BATCH, 64, seed=SEED + 21)
    log = LineLog()
    stages = ((16, 1), (32, 1), (64, 1))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state, stage_states = train_progressive(train, val, cfg=cfg, stages=stages, logger=log,
                                            device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    want = dict.fromkeys(EXPECTED_STEP_LAUNCHES, 0)
    steps_per_stage = 2  # 64 images at batch 32; one validation batch of 32
    for r, _ in stages:
        n_attn = sum(1 for x in (16, 32, 64) if x <= r)  # flash at T >= 256
        n_moe = int(math.log2(r // 4)) + 1  # one MoE per block from 4x4
        want["flash_attention_fwd"] += steps_per_stage * 2 * n_attn + n_attn
        want["flash_attention_bwd"] += steps_per_stage * n_attn
        want["fused_moe_fwd"] += steps_per_stage * 2 * n_moe + n_moe
        want["fused_moe_bwd"] += steps_per_stage * n_moe
    check(launches == want, f"progressive: launches {launches}, want {want}")
    transfers = [line for line in log.lines if line.startswith("transferred ")]
    want_lines = [f"transferred {PROGRESSIVE_TRANSFERS[r]} generator tensors from the previous "
                  f"stage" for r in (32, 64)]
    check(transfers == want_lines, f"progressive: {transfers}, want {want_lines}")
    check([r for r, _ in stage_states] == [16, 32, 64] and state is stage_states[-1][1],
          "progressive: stages")
    for r, s in stage_states:
        check(s.generator.config.max_resolution == r and s.step == steps_per_stage
              and s.g_opt.count.item() == steps_per_stage, f"progressive stage {r}: {s.step} steps")
        for name, p in list(s.generator.named_parameters()) + list(
                s.discriminator.named_parameters()):
            check(bool(torch.isfinite(p).all()), f"progressive stage {r}: {name} is not finite")
    vals = [(n, v) for n, v, _ in log.metrics if n.startswith("val_")]
    check(len(vals) == 6 and all(np.isfinite(v) for _, v in vals), f"progressive: {vals}")
    row = {"batch": PROGRESSIVE_BATCH, "stages": [list(x) for x in stages],
           "transfers": transfers, "launches": launches, "wall_s": wall_s, "val": vals,
           "card": smi}
    print("progressive " + json.dumps(row), flush=True)
    del state, stage_states
    return launches, row


def one_expert_phase(dev, tfm):
    """(d) the dense one-expert MoE: the forward kernel, hard and soft, and the
    backward at E = 1 against their plain versions at the five MoE blocks of a
    batch-16 call (every routing probability 1), then a one-expert generator's
    batch-16 call on the card against the CPU's, to phase 5's limit beyond the
    CPU's own bf16 distance from float32 (see `generator_phase`)."""
    from moegan_tpu_torch.config import GeneratorConfig
    from moegan_tpu_torch.models.generator import AuroraGenerator

    rows = []
    for res, C in TRAIN_MOE:
        args = moe_args(dev, C, N * res * res, E=1, seed=400 + res)
        for hard in (True, False):
            err, p_err, _, p, scale = moe_compare(tfm, args, hard,
                                                  f"E=1 res {res} {'hard' if hard else 'soft'}")
            check(bool((p == 1.0).all()), f"moe E=1 res {res}: a routing probability is not 1")
            rows.append({"res": res, "C": C, "hard": hard, "max_abs_err": err,
                         "max_abs_ref": scale})
    print("fused_moe_fwd E=1 " + json.dumps(rows), flush=True)
    bwd_rows = moe_bwd_phase(dev, tfm, TRAIN_MOE, tag="E=1 ", batch=N, E=1)
    cfg = GeneratorConfig(num_experts=1)
    sd = AuroraGenerator(cfg, gen=torch.Generator().manual_seed(SEED + 22)).state_dict()
    reset_counts()
    # The dense generator's images reach |x| ~ 900 before clipping at this
    # init, and bf16 puts the CPU's own plain versions ~0.1 of that from
    # float32 (a 2^-10 change of z moves float32's own images by 0.026): the
    # limit is phase 5's beyond what bf16 costs the plain versions.
    stats = generator_phase(cfg, sd, n=N, label="one_expert_generator_vs_cpu",
                            same_precision=True)
    launches = launch_counts()
    want = {**dict.fromkeys(EXPECTED_STEP_LAUNCHES, 0), "flash_attention_fwd": 3,
            "fused_moe_fwd": 5}
    check(launches == want, f"one-expert generator: launches {launches}, want {want}")
    return launches, rows, bwd_rows, stats


def training_configs_phase(dev, smi, tfa, tfm):
    """Phase 12: (a) the flagship preset at full width, its kernels at their
    shapes, 5 steps at batch 64 and the batch-4 step against the CPU's; (b) the
    options together; (c) progressive training; (d) one expert; (e) phase 9's
    distributed step under the options."""
    from moegan_tpu_torch.config import tpu_flagship_config

    out = {}
    flagship = tpu_flagship_config()
    gcfg = flagship.generator
    attn = tuple((r, gcfg.heads_for(c), c // gcfg.heads_for(c)) for r, c in gcfg.channels.items()
                 if r >= 16)
    check(attn == FLAGSHIP_ATTN and tuple(gcfg.channels.items()) == FLAGSHIP_MOE,
          f"flagship shapes {attn} {gcfg.channels}")
    out["flash_rows"] = flash_bwd_phase(dev, tfa, FLAGSHIP_ATTN, tag="flagship ")
    out["moe_rows"] = moe_bwd_phase(dev, tfm, FLAGSHIP_MOE, tag="flagship ")
    torch.cuda.empty_cache()
    out["flagship_launches"], out["flagship_row"] = train_phase(
        smi, label="flagship", cfg=flagship)
    torch.cuda.empty_cache()
    train_vs_cpu_phase("flagship_vs_cpu", cfg=flagship)
    torch.cuda.empty_cache()
    out["options_launches"], out["options_row"] = options_phase(smi, with_options(flagship))
    torch.cuda.empty_cache()
    train_vs_cpu_phase("options_vs_cpu", cfg=with_options(flagship), steps=2)
    torch.cuda.empty_cache()
    out["progressive_launches"], out["progressive_row"] = progressive_phase(smi)
    torch.cuda.empty_cache()
    out["one_expert_launches"], *_ = one_expert_phase(dev, tfm)
    torch.cuda.empty_cache()
    out["distributed_options_launches"], _ = distributed_phase(
        smi, cfg=with_options(dist_cfg(), hinge=False), steps=2, loop=False,
        expected=DIST_SHARED_LAUNCHES, label="distributed_options")
    torch.cuda.empty_cache()
    return out


def flagship_extras(p12) -> dict:
    """The kernels line's numbers of rows 1-5 at the flagship preset's shapes,
    batch 64, summed over one step's launches of each kernel as the default
    rows are: measured times, the bound of that work, the library call's time."""
    fr, mr = p12["flash_rows"], p12["moe_rows"]

    def total(rows, key):
        return sum(r[key] for r in rows)

    # the forward's 6 launches a step: each shape without and with lse
    fwd_bound = sum(2 * bound_ms(4.0 * r["B"] * r["H"] * r["T"] ** 2 * r["D"],
                                 4.0 * r["B"] * r["T"] * r["H"] * r["D"] * 2)[0] for r in fr)
    return {
        "flash_attention_fwd": {
            "flagship_train_ms": total(fr, "fwd_ms") + total(fr, "fwd_lse_ms"),
            "flagship_train_device_ms": total(fr, "fwd_device_ms") + total(fr,
                                                                           "fwd_lse_device_ms"),
            "flagship_train_bound_ms": fwd_bound,
            "flagship_train_library_ms": total(fr, "fwd_library_ms") + total(
                fr, "fwd_lse_library_ms")},
        "flash_attention_bwd": {
            "flagship_ms": total(fr, "ms"), "flagship_device_ms": total(fr, "device_ms"),
            "flagship_bound_ms": total(fr, "bound_ms"), "flagship_plain_ms": total(fr, "plain_ms"),
            "flagship_library_ms": total(fr, "library_ms")},
        "fused_moe_fwd": {
            "flagship_train_fwd_set_ms": total(mr, "fwd_ms"),
            "flagship_train_fwd_set_device_ms": total(mr, "fwd_device_ms"),
            "flagship_train_fwd_set_bound_ms": total(mr, "fwd_bound_ms")},
        "fused_moe_bwd": {
            "flagship_ms": total(mr, "ms"), "flagship_device_ms": total(mr, "device_ms"),
            "flagship_bound_ms": total(mr, "bound_ms"), "flagship_plain_ms": total(mr, "plain_ms"),
            "flagship_max_abs_err": max(r["max_abs_err"] for r in mr)},
    }


# --- phase 13: generation and evaluation ------------------------------------------------

EVAL_BATCH = 64  # cli.evaluate's default batch
# One eval generator call (hard routing): a flash forward per attention block
# at T >= 256 and a fused MoE forward per block, nothing else.
EVAL_CALL_LAUNCHES = {**dict.fromkeys(EXPECTED_STEP_LAUNCHES, 0), "flash_attention_fwd": 3,
                      "fused_moe_fwd": 5}
# Inception on the card (bf16 products of 94 convs) against the CPU's float32:
# each rounding is 2^-9 relative, a few dozen in sequence, so each image's
# 2048 features keep their direction to well within a percent.
FEATURE_COSINE = 0.995
# The FID of the card's features against the FID of the CPU's float32
# features of the same images. FID is a difference of traces several times
# its size, so it moves by a multiple of the features' relative error (on the
# CPU, bf16 Inception against float32 moved the FID of two 64-image
# synthetic sets by 0.12 %, features 0.39 % apart in RMS). A wrong layout or
# pool moves it by tens of percent.
FID_REL_TOL = 0.05


@contextlib.contextmanager
def timed_calls(targets, keep=()):
    """Time every call of each `targets[key] = (owner, name)` on the host, the
    card synchronised before and after. Yields ({key: [seconds, calls]},
    {key in `keep`: the list of its calls' results})."""
    spent = {key: [0.0, 0] for key in targets}
    kept = {key: [] for key in keep}
    saved = []
    for key, (owner, name) in targets.items():
        orig = getattr(owner, name)
        saved.append((owner, name, orig))

        def timed(*a, _orig=orig, _key=key, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _orig(*a, **kw)
            torch.cuda.synchronize()
            spent[_key][0] += time.perf_counter() - t0
            spent[_key][1] += 1
            if _key in kept:
                kept[_key].append(out)
            return out

        setattr(owner, name, timed)
    try:
        yield spent, kept
    finally:
        for owner, name, orig in saved:
            setattr(owner, name, orig)


def cpu_features(images, variant="torchvision"):
    """Float32 InceptionV3 features on the CPU, 32 images at a time."""
    from moegan_tpu_torch.models.inception import inception_model

    model = inception_model(device="cpu", compute_dtype="float32")
    with torch.inference_mode():
        return torch.cat([model.features(images[i:i + 32].float().cpu(), variant)
                          for i in range(0, len(images), 32)])


def features_phase(cfg, state_dict, smi):
    """(b) Inception features of 8 generated images on the card (bf16) against the
    CPU's float32 (both variants), each image's cosine; 64 images' features timed."""
    import torch.nn.functional as F

    from moegan_tpu_torch.infer.sample import Sampler
    from moegan_tpu_torch.models.inception import FEATURE_DIM, inception_model

    rng = np.random.default_rng(SEED + 30)
    z = rng.standard_normal((EVAL_BATCH, 512)).astype(np.float32)
    txt = rng.standard_normal((EVAL_BATCH, 512)).astype(np.float32)
    images, _ = Sampler(cfg, state_dict, device="cuda").sample_raw(
        z, txt, np.ones(EVAL_BATCH, np.float32))
    card = inception_model(device="cuda")
    row = {"images": 8, "card": smi}
    for variant in ("torchvision", "pytorch_fid"):
        with torch.inference_mode():
            got = card.features(images[:8], variant).float().cpu()
        want = cpu_features(images[:8], variant)
        check(tuple(got.shape) == (8, FEATURE_DIM) and bool(torch.isfinite(got).all()),
              f"inception {variant}: features {tuple(got.shape)}")
        cos = F.cosine_similarity(got, want, dim=-1)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        check(cos.min().item() >= FEATURE_COSINE,
              f"inception {variant}: feature cosine {cos.tolist()} < {FEATURE_COSINE}")
        row[variant] = {"cosine_min": cos.min().item(), "cosine": cos.tolist(),
                        "max_rel_diff": rel}
    with torch.inference_mode():
        ms = time_ms(lambda: card.features(images), 5)
    row.update(batch=EVAL_BATCH, ms=ms, images_per_s=EVAL_BATCH / ms * 1e3)
    print(f"inception features, batch {EVAL_BATCH} of 64x64 images: {ms:.2f} ms "
          f"({row['images_per_s']:.0f} images/s) on {smi}", flush=True)
    print("inception " + json.dumps(row), flush=True)
    return row


def evaluate_cli_phase(model_path, root, smi):
    """(c) `cli.evaluate.main` at the default 64x64 configuration, batch 64, once
    per feature source: the result, the launches of each generator call, the
    FID recomputed from the CPU's float32 features (Inception), the wall time
    split into generator, Inception, CLIP, sqrtm and the rest."""
    from moegan_tpu_torch.cli import evaluate as cli_evaluate
    from moegan_tpu_torch.data.datasets import synthetic_dataset
    from moegan_tpu_torch.infer import fid
    from moegan_tpu_torch.models.clip import CLIP
    from moegan_tpu_torch.models.generator import AuroraGenerator
    from moegan_tpu_torch.models.inception import InceptionV3

    targets = {"generator": (AuroraGenerator, "forward"), "inception": (InceptionV3, "features"),
               "clip": (CLIP, "image_features"), "sqrtm": (fid, "_psd_sqrtm")}
    rows, launches_by_source = {}, {}
    for source, dim in (("inception", 2048), ("clip", 512)):
        stats_path = os.path.join(root, f"reference_stats_{source}.npz")
        argv = ["--synthetic", "--batch_size", str(EVAL_BATCH), "--save_reference_stats",
                stats_path, "--device", "cuda", "--model_path", model_path,
                "--feature_source", source]
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with timed_calls(targets, keep=("generator",)) as (spent, kept):
            with contextlib.redirect_stdout(buf):
                res = cli_evaluate.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        launches_by_source[source] = launches
        lines = buf.getvalue().strip().splitlines()
        calls = spent["generator"][1]
        check(calls == 2 and res["num_samples"] == 2 * EVAL_BATCH,
              f"evaluate {source}: {calls} generator calls, {res['num_samples']} samples")
        want = {k: v * calls for k, v in EVAL_CALL_LAUNCHES.items()}
        check(launches == want, f"evaluate {source}: launches {launches}, want {want}")
        check(res["fid_feature_source"] == source and np.isfinite(res["fid"])
              and res["clip_score"] is not None and np.isfinite(res["clip_score"]),
              f"evaluate {source}: {res}")
        util = res["expert_utilization"]
        check(len(util) == 4 and abs(sum(util) - 1.0) < 1e-4, f"evaluate {source}: {util}")
        check(lines[0].startswith("[METRIC] fid: ") and lines[1].startswith("[METRIC] clip_score: ")
              and lines[2] == f"wrote {stats_path}" and json.loads(lines[-1])["fid"] == res["fid"],
              f"evaluate {source}: output {lines}")
        with np.load(stats_path) as data:
            check(data["mu"].shape == (dim,) and data["sigma"].shape == (dim, dim)
                  and bool(np.isfinite(data["sigma"]).all()), f"evaluate {source}: stats file")
        seconds = {k: v[0] for k, v in spent.items()}
        seconds["rest"] = wall - sum(seconds.values())
        row = {"source": source, "fid": res["fid"], "clip_score": res["clip_score"],
               "expert_utilization": util, "num_samples": res["num_samples"], "wall_s": wall,
               "seconds": seconds, "calls": {k: v[1] for k, v in spent.items()},
               "launches": launches, "card": smi}
        if source == "inception":
            fake = torch.cat([out.image.clamp(-1.0, 1.0).float().cpu()
                              for out in kept["generator"]])
            real = synthetic_dataset(max(2 * EVAL_BATCH, 64), 64).images[:len(fake)]
            t1 = time.perf_counter()
            f_fake = cpu_features(fake).double().numpy()
            f_real = cpu_features(torch.from_numpy(real)).double().numpy()
            fid_cpu = fid.frechet_distance(*fid.gaussian_stats(f_fake),
                                           *fid.gaussian_stats(f_real))
            rel = abs(res["fid"] - fid_cpu) / abs(fid_cpu)
            check(rel <= FID_REL_TOL, f"evaluate: FID {res['fid']} against the CPU's float32 "
                                      f"{fid_cpu}: {rel} > {FID_REL_TOL}")
            row.update(fid_cpu_float32=fid_cpu, fid_rel_diff=rel,
                       cpu_recompute_s=time.perf_counter() - t1,
                       images_per_s=res["num_samples"] / wall)
        rows[source] = row
        print(f"evaluate {source}: fid {res['fid']:.4f} clip_score {res['clip_score']:.4f} "
              f"in {wall:.1f} s: " + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()),
              flush=True)
        print("evaluate " + json.dumps(row), flush=True)
        del kept
        torch.cuda.empty_cache()
    return rows, launches_by_source["inception"]


def image_metrics_phase(model_dir, stats_path, root, smi):
    """(d) the model directory served from a working directory of its own:
    /image-metrics with a prompt and with an embedding, first without
    reference_stats.npz (μ=0, Σ=I), then with (c)'s file; a lone request to
    the unbatched handler."""
    from moegan_tpu_torch.infer.png import decode_png
    from moegan_tpu_torch.infer.serving import InferenceHandler, make_server

    work = os.path.join(root, "serve_cwd")
    os.makedirs(work)
    os.chdir(work)  # the handler reads reference_stats.npz from its working directory
    emb = np.random.default_rng(SEED + 31).standard_normal(512).astype(np.float32)
    with np.load(stats_path) as data:
        ref_mu = data["mu"]
    rows, towers = [], None
    for stage in ("fallback", "reference_stats"):
        if stage == "reference_stats":
            shutil.copy(stats_path, "reference_stats.npz")
        handler = InferenceHandler.from_model_dir(model_dir, clip_params=towers, device="cuda")
        towers = handler.sampler.clip_params
        mu = handler.fid.ref_mu
        check(np.array_equal(mu, ref_mu if stage == "reference_stats" else np.zeros(2048)),
              f"image-metrics {stage}: reference statistics")
        handler.batcher.prewarm()
        server = make_server(handler, host="127.0.0.1", port=0)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        results = [None, None]
        try:
            torch.cuda.synchronize()
            reset_counts()
            d0 = handler.batcher.dispatches
            for i, text in enumerate((PROMPT, emb)):
                request_once(base, text, 20 + i, results, i, path="/image-metrics")
            torch.cuda.synchronize()
            launches = launch_counts()
            dispatches = handler.batcher.dispatches - d0
        finally:
            server.shutdown()
            server.server_close()
            handler.close()
            th.join(30)
        for i, r in enumerate(results):
            check(r is not None and r[0]["status"] == "COMPLETED",
                  f"image-metrics {stage} {i}: {r and r[0]}")
            data = r[0]["data"]
            imgs = [decode_png(base64.b64decode(b)) for b in data["images"]]
            check(len(imgs) == 4 and all(im.shape == (64, 64, 3) for im in imgs),
                  f"image-metrics {stage} {i}: images")
            check(np.isfinite(data["fid_score"]), f"image-metrics {stage} {i}: {data['fid_score']}")
        want = {k: v * dispatches for k, v in EVAL_CALL_LAUNCHES.items()}
        check(dispatches == 2 and launches == want,
              f"image-metrics {stage}: {dispatches} calls, launches {launches}")
        rows.append({"stage": stage, "fid_score": [r[0]["data"]["fid_score"] for r in results],
                     "latency_ms": [r[1] for r in results], "launches": launches})
        print("image_metrics " + json.dumps(rows[-1]), flush=True)
    # the unbatched handler: a lone request at MAX_NUM_SAMPLES, sliced
    handler = InferenceHandler.from_model_dir(model_dir, clip_params=towers, batching=False,
                                              device="cuda")
    check(handler.batcher is None, "batching=False kept a batcher")
    handler.transform_fn({"text": emb.tolist(), "num_samples": 2, "seed": 5})  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    resp = handler.transform_fn({"text": emb.tolist(), "num_samples": 2, "seed": 5})
    lone_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    imgs = [decode_png(base64.b64decode(b)) for b in resp["images"]]
    check(len(imgs) == 2 and all(im.shape == (64, 64, 3) for im in imgs), "unbatched: images")
    check(launches == EVAL_CALL_LAUNCHES, f"unbatched: launches {launches}")
    handler.close()
    row = {"image_metrics": rows, "unbatched_ms": lone_ms, "card": smi}
    print(f"image-metrics latency ms {[r['latency_ms'] for r in rows]} (fallback, then "
          f"reference_stats.npz); unbatched lone request {lone_ms:.1f} ms", flush=True)
    return row


def generate_cli_phase(model_path, root):
    """(e) `cli.generate_images.main` at the default 64x64 configuration: a 2x2
    grid of 4 samples, 128x128x3, and the expert statistics."""
    from moegan_tpu_torch.cli import generate_images
    from moegan_tpu_torch.infer.png import decode_png

    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        path = generate_images.main(["--model_path", model_path, "--prompt", PROMPT,
                                     "--output_dir", os.path.join(root, "images"),
                                     "--show_experts", "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = launch_counts()
    check(os.path.basename(path) == "_".join(PROMPT.split())[:64] + ".png",
          f"generate_images: {path}")
    with open(path, "rb") as f:
        grid = decode_png(f.read())
    check(grid.shape == (128, 128, 3), f"generate_images: grid {grid.shape}")
    text = buf.getvalue()
    stats = json.loads(text[text.index("{"):])
    check(set(stats) == {f"block_{i}" for i in range(5)}, f"generate_images: {sorted(stats)}")
    check(launches == EVAL_CALL_LAUNCHES, f"generate_images: launches {launches}")
    row = {"grid": list(grid.shape), "wall_s": wall, "launches": launches}
    print("generate_images " + json.dumps(row), flush=True)
    return row


def evaluation_phase(dev, smi, tfa, tfm):
    """Phase 13: (a) the flash and hard-routed fused MoE forwards at the
    evaluator's batch-64 shapes; (b) Inception on the card against the CPU;
    (c) the evaluate CLI; (d) /image-metrics and the unbatched handler; (e) the
    generate_images CLI. Everything it writes lives in a temporary directory."""
    out = {"flash_rows": flash_phase(dev, tfa, batch=EVAL_BATCH, tag="eval ", lse_tol=6e-3),
           "moe_rows": moe_phase(dev, tfm, batch=EVAL_BATCH, tag="eval ")}
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="moegan_smoke_eval_")
    cwd = os.getcwd()
    try:
        model_dir = os.path.join(root, "model")
        os.makedirs(model_dir)
        cfg, state_dict = build_model_dir(model_dir)
        model_path = os.path.join(model_dir, "generator.npz")
        out["features"] = features_phase(cfg, state_dict, smi)
        torch.cuda.empty_cache()
        out["evaluate"], out["evaluate_launches"] = evaluate_cli_phase(model_path, root, smi)
        out["image_metrics"] = image_metrics_phase(
            model_dir, os.path.join(root, "reference_stats_inception.npz"), root, smi)
        out["generate"] = generate_cli_phase(model_path, root)
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def evaluation_extras(p13) -> dict:
    """The kernels line's numbers of rows 1 and 3-4 at the evaluator's batch 64,
    summed over one generator call's launches: times, bounds, plain and library."""
    fr, mr = p13["flash_rows"], p13["moe_rows"]

    def total(rows, key):
        return sum(r[key] for r in rows)

    return {
        "flash_attention_fwd": {f"eval_{k}": total(fr, k) for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "library_ms", "library_device_ms")},
        "fused_moe_fwd": {f"eval_{k}": total(mr, k) for k in (
            "ms", "device_ms", "plain_ms", "bound_ms")},
    }


# --- phase 14: the MLOps chain ----------------------------------------------------------

# cli.process_data --synthetic: 1,000 validation, 1,048 train and 3,144 augmented
# 64x64 images (the pipeline's split: min(max(1000, n // 5), n // 2) validation).
MLOPS_SAMPLES = 2048
MLOPS_VAL = min(max(1000, MLOPS_SAMPLES // 5), MLOPS_SAMPLES // 2)
MLOPS_TRAIN = MLOPS_SAMPLES - MLOPS_VAL
# Cuts, printed by the phase: the trials train on the first TUNE_TRAIN train and
# TUNE_VAL validation images of the processed set (16 steps an epoch at the
# search space's batch 8) for TUNE_EPOCHS epochs (the search space's 6); the job
# on int(1048 * JOB_PERCENTAGE) = 128 train images (4 steps at batch 32) and all
# 1,000 validation images (31 batches).
TUNE_TRAIN, TUNE_VAL, TUNE_EPOCHS = 128, 64, 2
JOB_PERCENTAGE = 0.1225
# Captions whose card embeddings are held to the CPU's float32 text tower (a
# float32 ViT-B/32 text pass costs ~12 GFLOP a caption on the host), to the
# prompts check's limit.
EMBED_CHECK = 32
# The card's augmentations against the same function on the CPU: the same
# float32 and float64 arithmetic, other summation orders.
AUG_TOL = 1e-4
TOY_SAMPLES, TOY_STEPS = 1024, 200
# The rows a trial or the job launches: flash forward and backward, the fused
# MoE forward (rows 3-4) and backward (row 5).
CHAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "fused_moe_fwd", "fused_moe_bwd")
# The keys of the JAX package's describe_best, trial_timeline and
# publish_model_metrics.
BEST_KEYS = {"BestTrainingJob", "FinalHyperParameters", "FinalObjectiveValue"}
TIMELINE_KEYS = {"trial_id", "status", "objective", "started_at", "ended_at"}
METRICS_KEYS = {"model_name", "training_job", "timestamp", "metrics", "hyperparameters"}


def logged(fn):
    """A pipeline stage that prints its traceback before the pipeline records it."""
    @functools.wraps(fn)
    def stage(ctx):
        try:
            return fn(ctx)
        except Exception:
            import traceback

            traceback.print_exc()
            raise

    return stage


def preprocessing_stage(ctx):
    """(a) `cli.process_data --synthetic 2048` on the card: the artifacts, the
    card's text embeddings against the CPU's float32 tower, the card's
    augmentations against the CPU's, the wall seconds of each part."""
    from moegan_tpu_torch.cli import process_data
    from moegan_tpu_torch.data import augment, pipeline
    from moegan_tpu_torch.data.datasets import ProcessedMSCOCODataset
    from moegan_tpu_torch.models import clip

    data = os.path.join(ctx["root"], "data")
    targets = {"resize": (pipeline, "_resize_batch"), "towers": (clip, "load_clip_params"),
               "text": (pipeline, "extract_clip_text_embeddings"),
               "augment": (augment, "create_augmentations"),
               "write": (ProcessedMSCOCODataset, "save")}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with timed_calls(targets) as (spent, _), contextlib.redirect_stdout(buf):
        info = process_data.main(["--synthetic", str(MLOPS_SAMPLES), "--output_dir", data,
                                  "--device", "cuda"])
    wall = time.perf_counter() - t0
    seconds = {k: v[0] for k, v in spent.items()}
    seconds["text"] -= seconds["towers"]  # the towers load inside the text call
    seconds["rest"] = wall - sum(seconds.values())
    check((info["n_train"], info["n_val"]) == (MLOPS_TRAIN, MLOPS_VAL), f"process_data: {info}")
    names = set(os.listdir(data))
    want = {f"mscoco_{s}_{k}.npy" for s in ("train", "validation", "train_augmented")
            for k in ("images", "text_embeddings", "captions")}
    want |= {"mscoco_train_metadata.pkl", "dataset_statistics.json", "sample_grid.png"}
    check(want <= names, f"process_data: missing {sorted(want - names)}")

    val = ProcessedMSCOCODataset.load(data, "validation", return_captions=True)
    with torch.no_grad():
        tower = clip.load_clip_params(device="cpu", compute_dtype="float32")
        cpu_emb = tower.encode_text(list(val.captions[:EMBED_CHECK])).double()
    del tower
    card_emb = torch.from_numpy(val.text_embeddings[:EMBED_CHECK]).double()
    cos = torch.nn.functional.cosine_similarity(card_emb, cpu_emb, dim=-1)
    check(cos.min().item() >= 0.999, f"process_data: embedding cosine {cos.min().item()} < 0.999")

    train = ProcessedMSCOCODataset.load(data, "train", return_captions=True)
    aug = ProcessedMSCOCODataset.load(data, "train", augmented=True, return_captions=True)
    t1 = time.perf_counter()
    cpu_aug = augment.create_augmentations(train.images, train.text_embeddings, train.captions,
                                           aug_factor=2, seed=0, device="cpu")
    cpu_aug_s = time.perf_counter() - t1
    aug_err = float(np.abs(aug.images - cpu_aug[0]).max())
    check(aug.images.shape == (3 * MLOPS_TRAIN, 64, 64, 3) and aug_err <= AUG_TOL,
          f"process_data: augmented {aug.images.shape}, card against CPU {aug_err} > {AUG_TOL}")
    check(np.array_equal(aug.text_embeddings, cpu_aug[1])
          and list(aug.captions) == list(cpu_aug[2]), "process_data: augmented embeddings")
    row = {"samples": MLOPS_SAMPLES, "n_train": info["n_train"], "n_val": info["n_val"],
           "n_augmented": len(aug), "wall_s": wall, "seconds": seconds,
           "embed_cosine_min": cos.min().item(), "embed_checked": EMBED_CHECK,
           "aug_max_abs_err": aug_err, "cpu_augment_s": cpu_aug_s, "card": ctx["smi"]}
    print(f"process_data {MLOPS_SAMPLES} samples in {wall:.1f} s: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()), flush=True)
    print("process_data " + json.dumps(row), flush=True)
    return {"data_dir": data, "preprocessing": row}


def job_logs(out_dir) -> str:
    """The ends of the job runner's logs under `out_dir`, for a failure message."""
    tails = []
    for path in sorted(glob.glob(os.path.join(out_dir, "jobs", "*", "stdout.log"))):
        with open(path, errors="replace") as f:
            tails.append(f"{path}:\n{f.read()[-3000:]}")
    return "\n".join(tails)


def hpo_stage(ctx):
    """(b) `cli.tune` on the card over (a)'s data, cut (see TUNE_*): 4 trials in
    process, 2 at a time, 2 warm-up; 2 trials as job-runner processes, 2 at a
    time; 1 trial alone in process (its time without a second thread). Every
    objective finite, two trials overlapping, the three files with the JAX
    package's keys, the chain's kernels launched by the 4 trials in process."""
    from moegan_tpu_torch.cli import tune
    from moegan_tpu_torch.data.datasets import ProcessedMSCOCODataset

    root = ctx["root"]
    tune_data = os.path.join(root, "tune_data")
    for split, n in (("train", TUNE_TRAIN), ("validation", TUNE_VAL)):
        ds = ProcessedMSCOCODataset.load(ctx["data_dir"], split, return_captions=True)
        ProcessedMSCOCODataset(ds.images[:n], ds.text_embeddings[:n], ds.captions[:n]).save(
            tune_data, split)
    with open(os.path.join(ROOT, "configs", "hyperparameter_config.json")) as f:
        space = json.load(f)
    static = space["static_hyperparameters"]
    print(f"tune cuts: trials on {TUNE_TRAIN} train / {TUNE_VAL} validation images of the "
          f"processed set, {TUNE_EPOCHS} epochs (the search space's {static['epochs']})",
          flush=True)
    static["epochs"] = str(TUNE_EPOCHS)
    space_path = os.path.join(root, "tune_space.json")
    with open(space_path, "w") as f:
        json.dump(space, f)
    rows, best = {}, None
    # (label, trial mode, trials, at a time): the last run times one trial alone
    for label, mode, jobs, parallel in (("in-process", "in-process", 4, 2),
                                        ("subprocess", "subprocess", 2, 2),
                                        ("in-process alone", "in-process", 1, 1)):
        out = os.path.join(root, f"hpo_{label.replace(' ', '_')}")
        argv = ["--config", space_path, "--data_dir", tune_data, "--out_dir", out,
                "--max_jobs", str(jobs), "--max_parallel_jobs", str(parallel),
                "--warmup_jobs", "2", "--trial_mode", mode, "--device", "cuda"]
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            info = tune.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        files = {}
        for name in ("best_hyperparameters", "trial_timeline", "model_metrics"):
            with open(os.path.join(out, f"{name}.json")) as f:
                files[name] = json.load(f)
        timeline = files["trial_timeline"]
        check(len(timeline) == jobs and all(
            t["status"] == "COMPLETED" and np.isfinite(t["objective"]) for t in timeline),
            f"tune {label}: {timeline}\n{job_logs(out)}")
        check(parallel == 1 or any(
            a["started_at"] < b["ended_at"] and b["started_at"] < a["ended_at"]
            for a in timeline for b in timeline if a["trial_id"] < b["trial_id"]),
            f"tune {label}: no two trials overlapped: {timeline}")
        check(set(files["best_hyperparameters"]) == BEST_KEYS
              and files["best_hyperparameters"] == info
              and all(set(t) == TIMELINE_KEYS for t in timeline)
              and set(files["model_metrics"]) == METRICS_KEYS,
              f"tune {label}: files {files}")
        if label == "in-process":
            # the counters are plain ints bumped from two threads: a lost update
            # lowers a count, never to 0
            check(all(launches[k] > 0 for k in CHAIN_KERNELS)
                  and not any(v for k, v in launches.items() if k not in CHAIN_KERNELS),
                  f"tune in-process: launches {launches}")
            best = info["FinalHyperParameters"]
        trial_s = [t["ended_at"] - t["started_at"] for t in timeline]
        rows[label] = {"trials": jobs, "parallel": parallel, "wall_s": wall, "trial_s": trial_s,
                       "objectives": [t["objective"] for t in timeline],
                       "best": info["FinalObjectiveValue"], "launches": launches,
                       "timeline": timeline, "card": ctx["smi"]}
        print(f"tune {label}: {jobs} trials, {parallel} at a time, in {wall:.1f} s, trial "
              f"seconds {[round(s, 2) for s in trial_s]}, best "
              f"{info['FinalObjectiveValue']:.4f}", flush=True)
        print("tune " + json.dumps({"mode": label, **rows[label]}), flush=True)
    return {"best_hyperparameters": best, "hpo": rows}


def training_stage(ctx):
    """(c) `cli.job_train` with the in-process search's best hyperparameters at the
    CLI's defaults (64x64, batch 32, the CLIP loss), one epoch on the cut train
    split: losses finite, the files written, the launches of 4 steps and 31
    validation batches exactly, ms/step."""
    from moegan_tpu_torch.cli import job_train

    root = ctx["root"]
    job_dir, model_dir = os.path.join(root, "job"), os.path.join(root, "model")
    hp = {**ctx["best_hyperparameters"], "epochs": "1", "batch_size": str(CLI_BATCH),
          "use_percentage": str(JOB_PERCENTAGE)}
    os.makedirs(job_dir)
    hp_path = os.path.join(job_dir, "hyperparameters.json")
    with open(hp_path, "w") as f:
        json.dump({k: str(v) for k, v in hp.items()}, f)
    n_train = int(MLOPS_TRAIN * JOB_PERCENTAGE)
    print(f"job cuts: 1 epoch, use_percentage {JOB_PERCENTAGE} of the {MLOPS_TRAIN} train "
          f"images ({n_train}), batch {CLI_BATCH}", flush=True)
    times, metrics = [], []
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with env_flags({"JOB_DIR": job_dir, "HYPERPARAMETERS_PATH": hp_path, "MODEL_DIR": model_dir,
                    "DATA_DIR": ctx["data_dir"]}), timed_steps(times, metrics), \
            contextlib.redirect_stdout(buf):
        state = job_train.main(["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    steps, val_batches = n_train // CLI_BATCH, MLOPS_VAL // CLI_BATCH
    want = {k: steps * n + val_batches * EXPECTED_EVAL_LAUNCHES.get(k, 0)
            for k, n in EXPECTED_STEP_LAUNCHES.items()}
    check(len(times) == steps and state.step == steps, f"job: {len(times)} steps")
    check(launches == want, f"job: launches {launches}, want {want}")
    check(all(np.isfinite(np.asarray(v, np.float64)).all() for m in metrics for v in m.values()),
          "job: non-finite step metrics")
    for path in ("aurora_model_final.msgpack", "generator_config.json"):
        check(os.path.exists(os.path.join(model_dir, path)), f"job: no {path}")
    check(os.listdir(os.path.join(job_dir, "checkpoints")), "job: no checkpoint")
    with open(os.path.join(job_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    val = {r["name"]: r["value"] for r in records if r["name"].startswith("val_")}
    check("val_clip_loss" in val and all(np.isfinite(v) for v in val.values()), f"job: {val}")
    row = {"hyperparameters": hp, "steps": steps, "wall_s": wall, "step_ms": times,
           "ms_per_step": float(np.median(times[2:])), "val": val, "launches": launches,
           "card": ctx["smi"]}
    print(f"job: {steps} steps at batch {CLI_BATCH}, step ms {[round(t, 1) for t in times]} "
          f"(median of steps 3-{steps}: {row['ms_per_step']:.1f}), wall {wall:.1f} s", flush=True)
    print("job " + json.dumps(row), flush=True)
    return {"model_dir": model_dir, "job_hyperparameters": hp, "val_metrics": val, "job": row}


def deployment_stage(ctx):
    """(c) the job's model directory published and served: model_metrics.json,
    one /generate of 4 64x64 images, GET /metrics returning the document."""
    from moegan_tpu_torch.infer.png import decode_png
    from moegan_tpu_torch.infer.serving import InferenceHandler, make_server
    from moegan_tpu_torch.orchestration.pipeline import publish_model_metrics

    model_dir = ctx["model_dir"]
    doc = publish_model_metrics(ctx["val_metrics"], os.path.join(model_dir, "model_metrics.json"),
                                training_job="job", hyperparameters=ctx["job_hyperparameters"])
    t0 = time.perf_counter()
    handler = InferenceHandler.from_model_dir(model_dir, device="cuda")
    load_s = time.perf_counter() - t0
    server = make_server(handler, metrics=doc, host="127.0.0.1", port=0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(SEED + 40)
    results = [None]
    try:
        request_once(base, rng.standard_normal(512).astype(np.float32), 3, results, 0)
        served = http_json(f"{base}/metrics")
        images, _ = handler.sampler.sample_raw(rng.standard_normal((4, 512)).astype(np.float32),
                                               rng.standard_normal((4, 512)).astype(np.float32),
                                               np.ones(4, np.float32))
        torch.cuda.synchronize()
    finally:
        server.shutdown()
        server.server_close()
        handler.close()
        th.join(30)
    job, latency = results[0]
    check(job["status"] == "COMPLETED", f"deploy: {job}")
    imgs = [decode_png(base64.b64decode(b)) for b in job["data"]["images"]]
    check(len(imgs) == 4 and all(im.shape == (64, 64, 3) for im in imgs), "deploy: images")
    check(tuple(images.shape) == (4, 64, 64, 3) and bool(torch.isfinite(images).all()),
          "deploy: the served generator's images")
    check(served == json.loads(json.dumps(doc)), f"deploy: /metrics {served}")
    row = {"load_s": load_s, "latency_ms": latency, "metrics": served["metrics"]}
    print("deploy " + json.dumps(row), flush=True)
    return {"deployment": row}


def toy_clip_phase(smi):
    """(e) `train_toy_clip` on `shapes_dataset` on the card: the loss falls;
    `retrieval_accuracy` of the trained towers."""
    from moegan_tpu_torch.data.datasets import shape_class_names, shapes_dataset
    from moegan_tpu_torch.models.toy_clip import retrieval_accuracy, train_toy_clip

    ds, labels = shapes_dataset(TOY_SAMPLES, 16, SEED)
    losses = []
    t0 = time.perf_counter()
    model = train_toy_clip(ds.images, ds.captions, steps=TOY_STEPS, batch_size=256, seed=SEED,
                           log_every=0, device="cuda", losses=losses)
    wall = time.perf_counter() - t0
    acc = retrieval_accuracy(model, ds.images, labels, shape_class_names())
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    check(np.isfinite(losses).all() and last < first, f"toy clip: loss {first} -> {last}")
    row = {"samples": TOY_SAMPLES, "steps": TOY_STEPS, "loss_first20": first,
           "loss_last20": last, "retrieval_accuracy": acc, "wall_s": wall, "card": smi}
    print(f"toy clip: infonce {first:.3f} -> {last:.3f} over {TOY_STEPS} steps in {wall:.1f} s, "
          f"retrieval accuracy {acc:.3f}", flush=True)
    print("toy_clip " + json.dumps(row), flush=True)
    return row


def mlops_phase(smi):
    """Phase 14: the four stages on a `Pipeline` with upload-data and run-hpo set
    ((a) process, (b) tune, (c) the job, then deployment); every stage
    SUCCEEDED and both one-shot flags reset; then (e) the toy CLIP."""
    from moegan_tpu_torch.orchestration import STAGES, Pipeline

    root = tempfile.mkdtemp(prefix="moegan_smoke_mlops_")
    cwd = os.getcwd()
    try:
        p = Pipeline(os.path.join(root, "pipeline"))
        for stage, fn in zip(STAGES, (preprocessing_stage, hpo_stage, training_stage,
                                      deployment_stage)):
            p.register(stage, logged(fn))
        p.flags.set("upload-data", True)
        p.flags.set("run-hpo", True)
        t0 = time.perf_counter()
        ctx = p.run({"root": root, "smi": smi})
        wall = time.perf_counter() - t0
        with open(os.path.join(p.work_dir, "pipeline_run.json")) as f:
            history = json.load(f)["history"]
        check([(h["stage"], h["status"]) for h in history]
              == [(s, "SUCCEEDED") for s in STAGES], f"pipeline: {history}")
        check(not p.flags.get("upload-data") and not p.flags.get("run-hpo"),
              f"pipeline: flags {p.flags.all()}")
        print("pipeline " + json.dumps({"history": history, "wall_s": wall}), flush=True)
        torch.cuda.empty_cache()
        toy = toy_clip_phase(smi)
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    launches = {k: ctx["hpo"]["in-process"]["launches"][k] + ctx["job"]["launches"][k]
                for k in EXPECTED_STEP_LAUNCHES}
    return {"ctx": ctx, "toy": toy, "launches": launches}


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
    print(f"{smi}, SM clock limit {sm_clock_mhz():g} MHz", flush=True)
    dev = torch.device("cuda")
    torch.manual_seed(SEED)
    build_s = _build.build_all()
    print(f"nvcc build: {build_s:.1f} s for {list(_build.SOURCES)}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    flash_rows = flash_phase(dev, tfa)
    moe_rows = moe_phase(dev, tfm)
    moe_ties_phase(dev, tfm)
    flash_bwd_rows = flash_bwd_phase(dev, tfa)
    moe_bwd_rows = moe_bwd_phase(dev, tfm)

    model_dir = tempfile.mkdtemp(prefix="moegan_smoke_model_")
    try:
        cfg, state_dict = build_model_dir(model_dir)
        serve_phase(model_dir, tfa, tfm)
        generator_phase(cfg, state_dict)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    launches, _ = train_phase(smi)
    train_vs_cpu_phase()
    torch.cuda.empty_cache()
    combine_fwd_rows, combine_bwd_rows = combine_phase(dev, tfm)
    torch.cuda.empty_cache()
    dist_launches, _ = distributed_phase(smi)
    for name in ("moe_combine_fwd", "moe_combine_bwd"):
        launches[name] = dist_launches[name]
    torch.cuda.empty_cache()
    opt_launches, ln_fwd_rows, ln_bwd_rows, legacy_rows = opt_in_phase(dev, smi, cfg, state_dict)
    for name in OPT_IN_KERNELS:
        launches[name] = opt_launches[name]
    torch.cuda.empty_cache()
    cli_launches = cli_phase(smi)
    torch.cuda.empty_cache()
    p12 = training_configs_phase(dev, smi, tfa, tfm)
    torch.cuda.empty_cache()
    p13 = evaluation_phase(dev, smi, tfa, tfm)
    torch.cuda.empty_cache()
    p14 = mlops_phase(smi)

    def total(rows, key):
        return sum(r[key] for r in rows)

    kernels = []
    # device_ms: the same calls replayed from a CUDA graph (no host cost per call)
    extra = {
        "flash_attention_fwd": {
            "device_ms": total(flash_rows, "device_ms"),
            "library_device_ms": total(flash_rows, "library_device_ms"),
            # the step's 6 launches at batch 64: 3 without lse, 3 with
            "train_ms": total(flash_bwd_rows, "fwd_ms") + total(flash_bwd_rows, "fwd_lse_ms"),
            "train_library_ms": (total(flash_bwd_rows, "fwd_library_ms")
                                 + total(flash_bwd_rows, "fwd_lse_library_ms")),
            "train_device_ms": (total(flash_bwd_rows, "fwd_device_ms")
                                + total(flash_bwd_rows, "fwd_lse_device_ms")),
        },
        "flash_attention_bwd": {"device_ms": total(flash_bwd_rows, "device_ms")},

        "fused_moe_fwd": {
            "device_ms": total(moe_rows, "device_ms"),
            # the soft forward at batch 64, five launches (one a block); the
            # step launches this set twice (G and D phases)
            "train_fwd_set_ms": total(moe_bwd_rows, "fwd_ms"),
            "train_fwd_set_device_ms": total(moe_bwd_rows, "fwd_device_ms"),
        },
        "fused_moe_bwd": {"device_ms": total(moe_bwd_rows, "device_ms")},
        # the legacy entry points with the forward's routing, as FusedMoEFunction
        # launches them under =3
        **{name: {"device_ms": total(rows, "device_ms")} for name, rows in legacy_rows.items()},
        # cold_device_ms: over rotating input copies (reads from device memory)
        **{name: {key: total(rows, key) for key in ("device_ms", "cold_device_ms",
                                                     "library_device_ms",
                                                     "library_cold_device_ms")}
           for name, rows in (("layer_norm_fwd", ln_fwd_rows), ("layer_norm_bwd", ln_bwd_rows))},
    }
    for name, more in flagship_extras(p12).items():
        extra.setdefault(name, {}).update(more)
    for name, more in evaluation_extras(p13).items():
        extra.setdefault(name, {}).update(more)
    for name, rows, src, replaces, lib, shapes in (
        ("flash_attention_fwd", flash_rows, "moegan_tpu_torch/ops/csrc/flash_attention.cu",
         "moegan_tpu/ops/flash_attention.py:226", True, "serving, batch 16"),
        ("fused_moe_fwd", moe_rows, "moegan_tpu_torch/ops/csrc/fused_moe.cu",
         "moegan_tpu/ops/fused_moe.py:97; moegan_tpu/ops/fused_moe.py:722", False,
         "serving, batch 16"),
        ("flash_attention_bwd", flash_bwd_rows,
         "moegan_tpu_torch/ops/csrc/flash_attention_bwd.cu",
         "moegan_tpu/ops/flash_attention.py:521", True, "training, batch 64"),
        ("fused_moe_bwd", moe_bwd_rows, "moegan_tpu_torch/ops/csrc/fused_moe_bwd.cu",
         "moegan_tpu/ops/fused_moe.py:774", False, "training, batch 64"),
        ("moe_combine_fwd", [r for r in combine_fwd_rows if r["E_local"] == 2],
         "moegan_tpu_torch/ops/csrc/fused_moe.cu",
         "moegan_tpu/ops/fused_moe.py:1046; moegan_tpu/ops/fused_moe.py:1224", False,
         "training, batch 64, E_local 2 (expert parallelism 2), soft routing"),
        ("moe_combine_bwd", [r for r in combine_bwd_rows if r["E_local"] == 2],
         "moegan_tpu_torch/ops/csrc/fused_moe_bwd.cu",
         "moegan_tpu/ops/fused_moe.py:1075; moegan_tpu/ops/fused_moe.py:1261", False,
         "training, batch 64, E_local 2 (expert parallelism 2)"),
        ("layer_norm_fwd", ln_fwd_rows, "moegan_tpu_torch/ops/csrc/layer_norm.cu",
         "moegan_tpu/ops/fused_layernorm.py:44", True,
         "training, batch 64, one norm per block, MOEGAN_FUSED_LN=1"),
        ("layer_norm_bwd", ln_bwd_rows, "moegan_tpu_torch/ops/csrc/layer_norm.cu",
         "moegan_tpu/ops/fused_layernorm.py:54", True,
         "training, batch 64, one norm per block, MOEGAN_FUSED_LN=1"),
        ("moe_bwd_dx", legacy_rows["moe_bwd_dx"],
         "moegan_tpu_torch/ops/csrc/fused_moe_legacy.cu",
         "moegan_tpu/ops/fused_moe.py:239", False,
         "training, batch 64, MOEGAN_PALLAS_MOE_BWD=3"),
        ("moe_bwd_dw2", legacy_rows["moe_bwd_dw2"],
         "moegan_tpu_torch/ops/csrc/fused_moe_legacy.cu",
         "moegan_tpu/ops/fused_moe.py:282", False,
         "training, batch 64, MOEGAN_PALLAS_MOE_BWD=3"),
        ("moe_bwd_dw1", legacy_rows["moe_bwd_dw1"],
         "moegan_tpu_torch/ops/csrc/fused_moe_legacy.cu",
         "moegan_tpu/ops/fused_moe.py:310", False,
         "training, batch 64, MOEGAN_PALLAS_MOE_BWD=3"),
    ):
        peak = PEAK_FP32_FLOPS if name.startswith("layer_norm") else PEAK_BF16_FLOPS
        ops_ms = sum(r["flops"] for r in rows) / peak * 1e3
        bytes_ms = sum(r["bytes"] for r in rows) / PEAK_BYTES * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            # launches: the 5 single-device training steps (phase 6); for the
            # combine kernels, rank 0's 3 distributed steps and its validation
            # batch (phase 9); for the opt-in kernels, the 5 steps of phase 10
            "launches": launches[name], "max_abs_err": max(r["max_abs_err"] for r in rows),
            # times and bounds: the sum over the shapes of one generator call
            # (forwards), one training step's backward (backwards) or one
            # norm in each of the five blocks (LayerNorm)
            "ms": total(rows, "ms"), "plain_ms": total(rows, "plain_ms"),
            "bound_ms": total(rows, "bound_ms"),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": total(rows, "library_ms") if lib else None,
            "shapes": shapes,
            # the launches of phase 11's default CLI run (4 steps, 2 validation batches)
            "cli_launches": cli_launches[name],
            # phase 12's paths: the flagship's 5 steps, the options' 4 mini-steps,
            # the progressive run, the one-expert generator call, the distributed
            # options' 2 mini-steps (rank 0)
            **{f"{path}_launches": p12[f"{path}_launches"][name] for path in (
                "flagship", "options", "progressive", "one_expert", "distributed_options")},
            # phase 13's main path: cli.evaluate's Inception run (2 generator calls)
            "evaluate_launches": p13["evaluate_launches"][name],
            # phase 14's main path: the 4 in-process trials (their threads' counts
            # may lose an update) and the managed job (4 steps, 31 validation batches)
            "mlops_launches": p14["launches"][name],
            **extra.get(name, {}),
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
