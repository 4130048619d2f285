"""The precision the reference computes its products in.

`FP32` leaves every operand as it is: float32, with TF32 switched off
inside `strict_fp32()`, which every use of the reference runs under.
`FP8` is the benchmark's control: every operand of a matrix product,
convolution or attention product is rounded to float8 e4m3 under a
per-tensor scale (its largest magnitude onto 448) in the forward, and
every cotangent that flows back through that operand is rounded the same
way. That is the step below the bfloat16 the
configurations state, so a comparison that passes the program and fails
this control separates bf16 arithmetic from fp8 arithmetic.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def strict_fp32():
    """Float32 products in float32 inside the block: no TF32 in matmuls or cuDNN
    convolutions. The settings are restored after it, so the program runs
    under its own."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _round_e4m3(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _FP8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return _round_e4m3(g)


class Precision:
    """`q(x)` is applied to each operand of each product."""

    name = "fp32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x


class FP8(Precision):
    name = "fp8"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _FP8Round.apply(x)


FP32 = Precision()
PRECISIONS = {"fp32": FP32, "fp8": FP8()}
