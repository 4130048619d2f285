#!/usr/bin/env python3
"""Where the LayerNorm kernels' device time goes: copies of
`moegan_tpu_torch/ops/csrc/layer_norm.cu` with one part changed, built with
the port's nvcc flags and timed beside the source as it is.

The variants (each a text replacement in a copy of the source; the script
stops if an anchor it replaces is gone):
- `as_is`: the source.
- `fwd_8_blocks_an_sm`: the forward's launch bounds and grid at 8 blocks of
  256 threads an SM (2,048 threads, so 32 registers a thread) instead of 4,
  the grid every block the SMs then hold (one a row group where N needs
  fewer).
- `bwd_one_reducer`: the backward's partials added by the last block alone
  (the last 8 blocks, each a slice of the outputs, as is).
- `bwd_loop_only`: the backward returns after its row loop: no block sums,
  no ticket, no final sum (dscale and dbias are not written). The loop's
  own time; the difference to `as_is` is the tail.
- `bwd_two_launches`: the backward's blocks write their partial rows and
  return, and a second kernel (one block, the same `sum_partials`) adds
  them: a route the ticket replaced.

Each is timed as a CUDA graph's replay (chip_smoke.py's `graph_ms`: device
ms per call, inputs hot in L2) at the five norm shapes of the 64x64 step
at batch 64 (x [64 * res^2, C] bf16), and its outputs are checked against
the plain twins to chip_smoke.py's limits. Run from the repository root on a
machine with nvcc and a CUDA device:
    python3 scripts/torch_layernorm_ablate.py
It prints the card's name and power limit, one JSON line per shape and a
last line with the sums over the five shapes.
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

FINISH = """
__global__ void __launch_bounds__(kThreads) ablate_finish_kernel(
    const float* part, int blocks, int C, float* dscale, float* dbias) {
  __shared__ float tmp[4 * kThreads];
  sum_partials(part, blocks, C, 0, 1, dscale, dbias, tmp);
}
extern "C" int ablate_finish(const void* part, int blocks, int C, void* dscale, void* dbias,
                             void* stream) {
  ablate_finish_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), blocks, C, static_cast<float*>(dscale),
      static_cast<float*>(dbias));
  return static_cast<int>(cudaGetLastError());
}
"""
TICKET = "  // The ticket: after the block's barrier, one thread's acquire-release"
VARIANTS = {
    "as_is": [],
    "fwd_8_blocks_an_sm": [("return cols <= 8 ? 4 : 2;", "return cols <= 8 ? 8 : 4;")],
    "bwd_one_reducer": [("constexpr int kReducers = 8;", "constexpr int kReducers = 1;")],
    "bwd_loop_only": [("  // The warp's row groups hold the same columns",
                       "  return;\n  // The warp's row groups hold the same columns")],
    "bwd_two_launches": [(TICKET, "  return;\n" + TICKET),
                         ('}  // extern "C"', '}  // extern "C"\n' + FINISH)],
}


def build(tmp: str) -> dict:
    """Each variant's library, built in parallel."""
    from moegan_tpu_torch.ops import _build

    src = (_build.CSRC / "layer_norm.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                sys.exit(f"{name}: anchor not found in layer_norm.cu: {old!r}")
            text = text.replace(old, new, 1)
        cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke as cs
    from moegan_tpu_torch.ops import layernorm as tln

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
    fns = {}
    for name, lib in libs.items():
        fwd, bwd = lib.moegan_layer_norm_fwd, lib.moegan_layer_norm_bwd
        fwd.restype = bwd.restype = ctypes.c_int
        fwd.argtypes, bwd.argtypes = list(tln._FWD_ARGS), list(tln._BWD_ARGS)
        fns[name] = (fwd, bwd)
    finish = libs["bwd_two_launches"].ablate_finish
    finish.restype, finish.argtypes = ctypes.c_int, [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                     ctypes.c_void_p, ctypes.c_void_p,
                                                     ctypes.c_void_p]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    sums: dict[str, float] = {}
    for res, C in cs.TRAIN_MOE:
        N = cs.B_TRAIN * res * res
        g = torch.Generator(device=dev).manual_seed(500 + res)
        x = (torch.randn((N, C), generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn(C, generator=g, device=dev)
        bias = 0.1 * torch.randn(C, generator=g, device=dev)
        dy = (torch.randn((N, C), generator=g, device=dev) * 0.1).to(torch.bfloat16)
        y, dx = torch.empty_like(x), torch.empty_like(x)
        grads = torch.zeros((2, C), device=dev)
        plan = tln.layer_norm_plan(N, C, torch.bfloat16, True, sms)
        part = torch.empty((plan.bwd_blocks, 2, C), device=dev)
        want_y = tln.layer_norm(x, scale, bias)
        want = tln.layer_norm_bwd_reference(x, scale, dy)

        def stream():
            return torch.cuda.current_stream().cuda_stream

        def fwd(name, blocks):
            rc = fns[name][0](x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), N, C,
                              1, 1e-5, *plan[:4], blocks, stream())
            cs.check(rc == 0, f"{name}: forward returned {rc}")

        def bwd(name):
            rc = fns[name][1](x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                              part.data_ptr(), grads[0].data_ptr(), grads[1].data_ptr(),
                              ticket.data_ptr(), N, C, 1, 1e-5, *plan[:4], plan.bwd_blocks,
                              stream())
            cs.check(rc == 0, f"{name}: backward returned {rc}")
            if name == "bwd_two_launches":
                rc = finish(part.data_ptr(), plan.bwd_blocks, C, grads[0].data_ptr(),
                            grads[1].data_ptr(), stream())
                cs.check(rc == 0, f"{name}: finish returned {rc}")

        def close(name, got, ref, lim):
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            cs.check(err <= lim * ref.float().abs().max().item(), f"{name} res {res}: {err}")

        row = {"res": res, "N": N, "C": C}
        per_sm = 8 if plan.vec * plan.vectors <= 8 else 4
        for name, blocks in (("as_is", plan.fwd_blocks),
                             ("fwd_8_blocks_an_sm", min(-(-N // plan.rows), per_sm * sms))):
            row[f"fwd_{name}"] = cs.graph_ms(lambda: fwd(name, blocks), 20)
            close(name, y, want_y, 2.0 ** -8)
        for name in ("as_is", "bwd_one_reducer", "bwd_loop_only", "bwd_two_launches"):
            grads.zero_()
            row[f"bwd_{name}"] = cs.graph_ms(lambda: bwd(name), 20)
            close(name, dx, want[0], 2 * 2.0 ** -8)
            if name != "bwd_loop_only":
                close(name, grads[0], want[1], 1e-3)
                close(name, grads[1], want[2], 1e-3)
        for key, val in row.items():
            if key.startswith(("fwd_", "bwd_")):
                sums[key] = sums.get(key, 0.0) + val
        print(json.dumps(row), flush=True)
        del x, dy, y, dx, part
        torch.cuda.empty_cache()
    print(json.dumps({"sums_over_five_shapes_ms": sums, "device": smi}), flush=True)


if __name__ == "__main__":
    main()
