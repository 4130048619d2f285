"""The port's plain expert-parallel combine against the JAX package's four
probs-as-input TPU kernels, run in interpret mode as tests/test_fused_moe.py
runs them: `_combine_fwd_pallas` (v1), `_combine_fwd_pallas_v2`,
`_combine_bwd_pallas` (v1) and `_combine_bwd_pallas_v2`, at a local expert
count of 1 and 2 (a rank's share of 4 experts), float32 on both sides.

On the CPU the port's `moe_ffn_combine` and `MoECombineFunction` take their
plain versions (`moe_ffn_combine_reference`, `moe_ffn_combine_bwd_reference`):
the functions that chip_smoke.py and tests/test_torch_cuda.py hold the
CUDA kernels against.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import moegan_tpu.ops.fused_moe as fm
from moegan_tpu_torch.ops import fused_moe as tfm
from tests.torch_helpers import randn, t

T, C, F, BT = 64, 16, 64, 32  # two token tiles of the TPU kernels' grid
NAMES = ("dx", "dprobs", "dw1", "db1", "dw2", "db2")


def _case(E, onehot, seed):
    """A rank's view: E local experts of 4, probs = the local columns of a
    softmax (or one-hot) over 4."""
    logits = randn(seed, T, 4, scale=2.0)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if onehot:
        probs = np.eye(4, dtype=np.float32)[probs.argmax(-1)]
    return (randn(seed + 1, T, C), np.ascontiguousarray(probs[:, :E]).astype(np.float32),
            randn(seed + 2, E, C, F, scale=0.2), randn(seed + 3, E, F, scale=0.1),
            randn(seed + 4, E, F, C, scale=0.1), randn(seed + 5, E, C, scale=0.1),
            randn(seed + 6, T, C))


CASES = {(E, onehot): _case(E, onehot, 10 * E + onehot) for E in (1, 2) for onehot in (0, 1)}


@pytest.fixture(scope="module")
def jax_kernels():
    """Every case through the four kernels in interpret mode, in one jit."""
    real_call = fm.pl.pallas_call

    def interp_call(*a, **kw):
        kw["interpret"] = True
        return real_call(*a, **kw)

    def run(cases):
        out = {}
        for key, (x, p, w1, b1, w2, b2, dout) in cases.items():
            out[key] = (fm._combine_fwd_pallas(x, p, w1, b1, w2, b2, BT),
                        fm._combine_fwd_pallas_v2(x, p, w1, b1, w2, b2, BT),
                        fm._combine_bwd_pallas((x, p, w1, b1, w2, b2), dout, BT),
                        fm._combine_bwd_pallas_v2((x, p, w1, b1, w2, b2), dout, BT))
        return out

    with mock.patch.object(fm.pl, "pallas_call", interp_call):
        got = jax.jit(run)({f"{E}-{o}": c for (E, o), c in CASES.items()})
    return {tuple(int(v) for v in k.split("-")): v for k, v in got.items()}


@pytest.mark.parametrize("E,onehot", sorted(CASES))
def test_combine_forward_matches_jax_kernels(jax_kernels, E, onehot):
    x, p, w1, b1, w2, b2, _ = CASES[(E, onehot)]
    got = tfm.moe_ffn_combine(*(t(a) for a in (x, p, w1, b1, w2, b2))).numpy()
    v1, v2 = jax_kernels[(E, onehot)][:2]
    # float32 throughout; v1 sums the experts in the output's dtype, v2 and
    # the port in one fp32 contraction
    for name, want in (("v1", v1), ("v2", v2)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("E", [1, 2])
def test_combine_backward_matches_jax_kernels(jax_kernels, E):
    x, p, w1, b1, w2, b2, dout = CASES[(E, 0)]
    leaves = [t(a).requires_grad_(True) for a in (x, p, w1, b1, w2, b2)]
    out = tfm.MoECombineFunction.apply(*leaves)
    got = torch.autograd.grad(out, leaves, t(dout))
    plain = tfm.moe_ffn_combine_bwd(*(t(a) for a in (x, p, w1, b1, w2, b2, dout)))
    v1, v2 = jax_kernels[(E, 0)][2:]
    for name, a, b, want1, want2 in zip(NAMES, got, plain, v1, v2):
        np.testing.assert_array_equal(a.numpy(), b.numpy())  # the autograd function's backward
        for kernel, want in (("v1", want1), ("v2", want2)):
            want = np.asarray(want, np.float32)
            # float32 sums over 64 tokens or 64-128 hidden units in other
            # orders: 1e-5 of the gradient's largest |value|
            np.testing.assert_allclose(a.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"{kernel} {name}")


def test_kernel_input_checks():
    """The checks the CUDA wrappers make before a launch (dtype, shape,
    layout), run here on CPU tensors of the kernels' types."""
    bf = torch.bfloat16
    x, p, w1, b1, w2, b2, _ = (t(a) for a in CASES[(2, 0)])
    good = [x.to(bf), p, w1.to(bf), b1, w2.to(bf), b2]
    tfm._check_combine_inputs(*good)
    for i, bad in ((1, p.double()), (1, p[:, :1].contiguous()), (2, w1.to(bf).transpose(1, 2)),
                   (0, x)):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError):
            tfm._check_combine_inputs(*args)
    fused = [x.to(bf), torch.zeros(C, 8, dtype=bf), torch.zeros(8, 2), torch.zeros(T, 2),
             torch.ones(1), *good[2:]]
    tfm._check_cuda_inputs(*fused)
    fused[3] = torch.zeros(T, 3)
    with pytest.raises(ValueError):
        tfm._check_cuda_inputs(*fused)
