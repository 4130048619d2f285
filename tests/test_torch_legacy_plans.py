"""The launch plans of the legacy MoE backward's kernels
(`MOEGAN_PALLAS_MOE_BWD=3`), which are pure Python: each C entry point checks
the plan it is given, so these hold them at every shape the 64x64 training
step gives them, on the H100's 132 SMs, and at ragged token counts. Also the
kernel sources' GELU, which no card is needed to read."""

import re
from pathlib import Path

import pytest

from moegan_tpu_torch.ops import fused_moe as tfm

SMS = 132
BLOCKS = ((4, 512), (8, 256), (16, 128), (32, 64), (64, 32))  # (res, C), F = 4C, E = 4


@pytest.mark.parametrize("B,ragged", [(4, (77, 48)), (64, (1000, 512))])
@pytest.mark.parametrize("which", ["dx", "dw1", "dw2"])
def test_legacy_plans_fit_every_shape(which, B, ragged):
    E = 4
    for T, C in [(B * res * res, C) for res, C in BLOCKS] + [ragged]:
        F = 4 * C
        plan = tfm.legacy_plan(which, T, C, F, E, SMS)
        tiles, chunks = -(-T // plan.block_t), E * -(-F // 64)
        assert plan.block_t == (32 if C > 256 else 64), (T, C, plan)
        assert 1 <= plan.splits <= chunks, (T, C, plan)
        if which == "dx" or (which == "dw1" and plan.scratch):
            # at least a block per SM wherever the tiles and chunks allow it
            assert tiles * plan.splits >= min(SMS, tiles * chunks), (T, C, plan)
        else:
            assert plan.splits == 1
        if which == "dx":
            assert plan.t_ranges == 1 and not plan.scratch
            continue
        # The route by width: recompute up to C = 256, the scratch above.
        assert plan.scratch == (C > 256), (T, C, plan)
        if not plan.scratch:
            grid = E * -(-F // 64)  # one block a (expert, 64 hidden units)
        elif which == "dw1":
            grid = -(-E * F // 128) * -(-C // 128)  # 128 x 128 tiles of dW1^T [E*F, C]
        else:
            grid = E * -(-F // 128) * -(-C // 128)  # and of each expert's dW2 [F, C]
        step = 32 if plan.scratch else tfm._recompute_step(C)  # tokens a kernel step
        assert plan.t_range % step == 0
        assert grid * plan.t_ranges >= min(SMS, grid * -(-T // step)), (T, C, plan)
        # the T ranges [s * t_range, (s + 1) * t_range) cover T exactly once
        assert plan.t_ranges * plan.t_range >= T > (plan.t_ranges - 1) * plan.t_range, (T, C, plan)


def test_no_kernel_source_calls_cuda_erf():
    """Every kernel takes the GELU's erf from moe_tiles.cuh's `gelu_cdf`, the
    TPU kernels' Abramowitz-Stegun polynomial (moegan_tpu/ops/fused_moe.py::
    _erf_poly), never from CUDA's erf functions, whose h can differ from the
    polynomial's by one bf16 ulp."""
    csrc = Path(tfm.__file__).resolve().parent / "csrc"
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    assert len(sources) >= 6
    for src in sources:
        code = re.sub(r"/\*.*?\*/", "", src.read_text(), flags=re.S)
        code = re.sub(r"//[^\n]*", "", code)  # comments name erf(...) in prose
        calls = re.findall(r"\b(?:erff?|erfcf?|erfinvf?|normcdff?)\s*\(", code)
        assert not calls, f"{src.name} calls {calls}"
    assert "gelu_cdf(" in (csrc / "fused_moe_legacy.cu").read_text()
