#!/usr/bin/env python3
"""Measured peak rates of the two units that bound the flash kernels on one GPU.

The flash kernels (moegan_tpu_torch/ops/csrc/flash_attention*.cu) issue
mma.sync m16n8k16 (bf16 in, fp32 accumulate) on the tensor cores and
ex2.approx.ftz.f32 on the SFUs. This script builds three small kernels with
nvcc (sm_90a) and times each over the whole card with CUDA events:

- mma: every warp issues independent mma.sync m16n8k16 (8 accumulators);
- ex2: every thread issues independent ex2.approx.ftz.f32 (8 chains);
- mix: both streams in one warp, in the ratio the flash forward has at
  D = 32 (36 MMAs to 34 exponentials per 16 x 64 tile), to show whether
  the two units overlap.

Run from the repository root on a machine with a CUDA device and nvcc:
    python3 scripts/torch_mma_ex2_rates.py
It prints the card's name, power limit and SM clock limit, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// kind 0: mma only; 1: ex2 only; 2: both (per iteration 9 MMAs, 8 ex2 per thread).
__global__ void rates_kernel(int kind, int iters, float seed, float* out) {
  float acc[8][4];
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float e[8];
  for (int i = 0; i < 8; ++i) e[i] = seed * (threadIdx.x + i);
  const uint32_t a = 0x3F803F80u ^ threadIdx.x, b = 0x3C003C00u;
  for (int it = 0; it < iters; ++it) {
    if (kind != 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) mma(acc[i], a, a, a, a, b, b);
      if (kind == 2) mma(acc[0], a, b, a, b, b, a);
    }
    if (kind != 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = ex2(e[i]) * -0.5f;
    }
  }
  float s = 0.f;
  for (int i = 0; i < 8; ++i) s += acc[i][0] + acc[i][3] + e[i];
  if (s == 12345.f) out[threadIdx.x] = s;  // keeps the work
}

extern "C" int run(int kind, int blocks, int threads, int iters, float* out, void* stream) {
  rates_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(kind, iters, 1e-3f, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from moegan_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = os.path.join(tmp, "rates.cu"), os.path.join(tmp, "rates.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, src], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(lib_path)
    lib.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(1024, device="cuda")
    result = {"card": smi, "sms": sms}
    for threads in (128, 256):
        blocks, iters = sms * 8, 4096
        row = {}
        for kind, name in ((0, "mma"), (1, "ex2"), (2, "mix")):
            def call():
                rc = lib.run(kind, blocks, threads, iters, out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch failed: {rc}")
            call()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                call()
            end.record()
            torch.cuda.synchronize()
            s = start.elapsed_time(end) / 5 / 1e3
            warps = blocks * threads // 32
            mmas = warps * iters * (8 if kind == 0 else 9 if kind == 2 else 0)
            ex2s = blocks * threads * iters * (8 if kind else 0)
            row[name] = {"ms": s * 1e3, "mma_tflops": mmas * 4096 / s / 1e12,
                         "ex2_per_s": ex2s / s}
        result[f"threads_{threads}"] = row
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
