"""The LayerNorm kernels' launch plan (`ops/layernorm.py::layer_norm_plan`),
which is pure Python: the C entry points check the plan they are given, so
these hold it at every norm shape of the 64x64 step and of a served call, at
ragged widths and at unaligned pointers, on the H100's 132 SMs."""

import re
from pathlib import Path

import pytest
import torch

from moegan_tpu_torch.ops import layernorm as tln

SMS = 132
NORMS = ((4, 512), (8, 256), (16, 128), (32, 64), (64, 32))  # (res, C) of the five blocks
BF16, FP32 = torch.bfloat16, torch.float32


def _holds(N, C, dtype, aligned, sms=SMS):
    """The plan's invariants; returns it."""
    plan = tln.layer_norm_plan(N, C, dtype, aligned, sms)
    full = 8 if dtype == BF16 else 4
    # 16-byte vectors only where C is whole vectors and the rows are aligned
    assert plan.vec == (full if aligned and C % full == 0 else 1), (N, C, dtype, aligned, plan)
    assert 32 % plan.group == 0 and plan.vectors & (plan.vectors - 1) == 0, plan
    # lane j of a group holds vectors v at columns (v * G + j) * vec ...: every
    # column below G * vectors * vec once, those past C masked
    cols = sorted((v * plan.group + j) * plan.vec + e for v in range(plan.vectors)
                  for j in range(plan.group) for e in range(plan.vec))
    assert cols == list(range(plan.group * plan.vectors * plan.vec))
    assert C <= len(cols) < 2 * C or len(cols) == plan.vec, (C, plan)
    assert plan.vectors == 1 or plan.group == 32, plan
    assert plan.rows == 8 * (32 // plan.group)
    # the forward: two rows a warp where N allows, at most the blocks the SMs
    # hold at once (4 an SM at <= 8 columns a thread, else 2), at least a
    # block on every SM that N fills
    per_sm = 4 if plan.vec * plan.vectors <= 8 else 2
    rows = -(-N // plan.rows)  # one a warp
    assert min(rows, sms) <= plan.fwd_blocks <= min(rows, per_sm * sms), plan
    assert plan.fwd_blocks >= min(-(-rows // 2), per_sm * sms), plan
    # the backward: N and the SM count alone decide its blocks (its sums'
    # order): 2 an SM, all resident at once, and a row a warp at least
    assert plan.bwd_blocks == min(-(-N // 8), 2 * sms), plan
    for other in ((7, BF16, False), (512, FP32, True), (C, dtype, not aligned)):
        assert tln.layer_norm_plan(N, *other, sms).bwd_blocks == plan.bwd_blocks
    return plan


@pytest.mark.parametrize("batch", [64, 16])
def test_plan_at_every_norm_shape(batch):
    """The step's (batch 64) and a served call's (batch 16) five norms take
    16-byte vectors: C = 32 on 4 lanes (8 rows a warp) up to C = 512 on 32
    lanes with two vectors each; at batch 64 the backward runs 2 blocks on
    every SM from res 8 on."""
    want = {32: (4, 1), 64: (8, 1), 128: (16, 1), 256: (32, 1), 512: (32, 2)}
    for res, C in NORMS:
        N = batch * res * res
        plan = _holds(N, C, BF16, True)
        assert (plan.vec, plan.group, plan.vectors) == (8, *want[C]), (res, plan)
        if batch == 64 and res >= 8:
            assert plan.bwd_blocks == 2 * SMS
    assert _holds(1, 32, BF16, True).bwd_blocks == _holds(1, 32, BF16, True).fwd_blocks == 1
    # the kernel source's block shapes are the plan's
    src = (Path(tln.__file__).resolve().parent / "csrc" / "layer_norm.cu").read_text()
    assert re.search(r"kWarps = (\d+);", src).group(1) == "8"
    assert "cols <= 8 ? 4 : 2" in src


def test_plan_at_ragged_and_unaligned_rows():
    """C = 7 and C = 100 in bf16 are not whole vectors and take single
    elements; C = 96 in fp32 and C = 512 take vectors; an unaligned pointer
    takes single elements at every width."""
    for N, C, dtype, vec in ((1000, 7, BF16, 1), (1000, 100, BF16, 1), (300, 96, FP32, 4),
                             (257, 512, BF16, 8), (257, 512, FP32, 4), (1, 8, BF16, 8)):
        assert _holds(N, C, dtype, True).vec == vec, (N, C, dtype)
        assert _holds(N, C, dtype, False).vec == 1, (N, C, dtype)
    assert _holds(1000, 7, BF16, True)[1:3] == (8, 1)  # 8 lanes, 4 rows a warp
    assert _holds(1000, 100, BF16, True)[1:3] == (32, 4)
    assert _holds(257, 512, BF16, False)[1:3] == (32, 16)
    # fewer SMs, fewer backward blocks; the same N and SMs, the same blocks
    assert _holds(64 * 4096, 32, BF16, True, sms=114).bwd_blocks == 228
    # 16 columns a thread: 2 forward blocks an SM (128 registers), else 4
    assert _holds(1 << 16, 512, BF16, True).fwd_blocks == 2 * SMS
    assert _holds(1 << 16, 64, BF16, True).fwd_blocks == 4 * SMS
