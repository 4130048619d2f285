"""The port's legacy three-kernel MoE backward (`MOEGAN_PALLAS_MOE_BWD=3`)
against the JAX package's, and the backward's dispatch.

JAX `_fused_moe_bwd_pallas` runs its three TPU kernels `_bwd_dx_kernel`,
`_bwd_dw2_kernel` and `_bwd_dw1_kernel` in interpret mode, as
tests/test_fused_moe.py runs them; the patched `pallas_call` records each
kernel's outputs under its name, so each plain twin of the port
(`moe_bwd_dx_reference`, `moe_bwd_dw2_reference`, `moe_bwd_dw1_reference`:
the functions chip_smoke.py and tests/test_torch_cuda.py hold the CUDA
entry points against) is held against its own kernel. float32 on both
sides, so the bf16 roundings of the kernels are no-ops here; the TPU
kernels' erf is a polynomial within 1.5e-7 of the port's `torch.erf`.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import moegan_tpu.ops.fused_moe as fm
from moegan_tpu_torch.ops import fused_moe as tfm
from tests.torch_helpers import MOE_ORDER, moe_inputs, randn, t

T, C, E, BT = 64, 32, 4, 32  # two token tiles of the TPU kernels' grid
KERNELS = ("_bwd_dx_kernel", "_bwd_dw2_kernel", "_bwd_dw1_kernel")
GRADS = ("dx", "dfw", "dcw_f", "dtext_logits", "dinv_temp", "dw1", "db1", "dw2", "db2")


def _inputs():
    a = moe_inputs(seed=5, T=T, C=C, F=4 * C, E=E, h=8)
    return [a[k] for k in MOE_ORDER], randn(20, T, C), randn(21, T, E, scale=0.1)


def _close(got, want, name, rtol=1e-4):
    """float32 on both sides, in other summation orders: within rtol of the
    largest |value| of the tensor."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32).reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-6),
                               err_msg=name)


@pytest.fixture(scope="module")
def jax_legacy():
    """(the nine gradients of `_fused_moe_bwd_pallas`, {kernel name: its outputs})."""
    args, dout, dprobs = _inputs()
    real = fm.pl.pallas_call
    outputs = {}

    def recording(kernel, *a, **kw):
        kw["interpret"] = True
        call = real(kernel, *a, **kw)

        def run(*operands):
            out = call(*operands)
            outputs[kernel.__name__] = [np.asarray(o) for o in out]
            return out

        return run

    with mock.patch.object(fm.pl, "pallas_call", recording):
        grads = fm._fused_moe_bwd_pallas(tuple(np.float32(a) if k == "inv_temp" else a
                                               for k, a in zip(MOE_ORDER, args)),
                                         dout, dprobs, block_t=BT)
    assert sorted(outputs) == sorted(KERNELS)
    return [np.asarray(g) for g in grads], outputs


def _port_args():
    args, dout, dprobs = _inputs()
    return ([t(a) if k != "inv_temp" else torch.full((1,), a) for k, a in zip(MOE_ORDER, args)],
            t(dout), t(dprobs))


def test_dx_twin_matches_jax_kernel(jax_legacy):
    args, dout, _ = _port_args()
    dx, dp = tfm.moe_bwd_dx_reference(*args, dout)
    want_dx, want_dp = jax_legacy[1]["_bwd_dx_kernel"]
    _close(dx.numpy(), want_dx, "dx_ffn")
    _close(dp.numpy(), want_dp, "dp")


def test_dw2_twin_matches_jax_kernel(jax_legacy):
    args, dout, _ = _port_args()
    x, fw, cw, tl, it, w1, b1, _, _ = args
    dw2, db2 = tfm.moe_bwd_dw2_reference(x, fw, cw, tl, it, w1, b1, dout)
    want_dw2, want_db2 = jax_legacy[1]["_bwd_dw2_kernel"]
    _close(dw2.numpy(), want_dw2, "dw2")
    _close(db2.numpy(), want_db2, "db2")


def test_dw1_twin_matches_jax_kernel(jax_legacy):
    args, dout, _ = _port_args()
    x, fw, cw, tl, it, w1, b1, w2, _ = args
    dw1, db1 = tfm.moe_bwd_dw1_reference(x, fw, cw, tl, it, w1, b1, w2, dout)
    want_dw1, want_db1 = jax_legacy[1]["_bwd_dw1_kernel"]
    _close(dw1.numpy(), want_dw1, "dw1")
    _close(db1.numpy(), want_db1, "db1")


def _function_grads(monkeypatch, mode):
    """The nine gradients of `FusedMoEFunction` under MOEGAN_PALLAS_MOE_BWD=mode."""
    if mode is None:
        monkeypatch.delenv("MOEGAN_PALLAS_MOE_BWD", raising=False)
    else:
        monkeypatch.setenv("MOEGAN_PALLAS_MOE_BWD", mode)
    args, dout, dprobs = _port_args()
    leaves = [a.detach().requires_grad_(True) for a in args]
    out, probs = tfm.FusedMoEFunction.apply(*leaves)
    return torch.autograd.grad((out, probs), leaves, (dout, dprobs))


def test_function_under_mode_3_matches_jax(jax_legacy, monkeypatch):
    """The whole backward under "3": the three entry points (here their twins)
    plus the router chain, against the tuple `_fused_moe_bwd_pallas` returns."""
    got = _function_grads(monkeypatch, "3")
    for name, g, w in zip(GRADS, got, jax_legacy[0]):
        _close(g.detach().numpy(), w, name)


def _counts():
    return [f.launches for f in (tfm.fused_moe_bwd, tfm.moe_bwd_dx, tfm.moe_bwd_dw2,
                                 tfm.moe_bwd_dw1, tfm.moe_ffn_combine_bwd)]


@pytest.mark.parametrize("mode", ["0", "3"])
def test_backward_modes_agree(monkeypatch, mode):
    """Unset ("1": the backward kernel's twin), "0" (autograd recompute) and "3"
    (the legacy twins) give the same gradients on the CPU, and move no
    launch counter."""
    before = _counts()
    want = _function_grads(monkeypatch, None)
    got = _function_grads(monkeypatch, mode)
    assert _counts() == before
    for name, g, w in zip(GRADS, got, want):
        # float32, the same gradient by other routes
        _close(g.numpy(), w.numpy(), name, rtol=1e-5)


def test_combine_backward_honours_mode_0(monkeypatch):
    x, probs = t(randn(30, T, C)), torch.softmax(t(randn(31, T, E)), -1)[:, :2].contiguous()
    args = [x, probs, t(randn(32, 2, C, 4 * C, scale=0.1)), t(randn(33, 2, 4 * C, scale=0.1)),
            t(randn(34, 2, 4 * C, C, scale=0.1)), t(randn(35, 2, C, scale=0.1))]
    dout = t(randn(36, T, C))
    grads = {}
    for mode in ("1", "0", "3"):
        monkeypatch.setenv("MOEGAN_PALLAS_MOE_BWD", mode)
        leaves = [a.detach().requires_grad_(True) for a in args]
        grads[mode] = torch.autograd.grad(tfm.MoECombineFunction.apply(*leaves), leaves, dout)
    for mode in ("0", "3"):
        for name, g, w in zip(("dx", "dprobs", "dw1", "db1", "dw2", "db2"), grads[mode],
                              grads["1"]):
            _close(g.numpy(), w.numpy(), f"{mode} {name}", rtol=1e-5)


def test_unknown_mode_raises(monkeypatch):
    with pytest.raises(ValueError, match="MOEGAN_PALLAS_MOE_BWD"):
        _function_grads(monkeypatch, "2")


def test_entry_points_check_their_inputs():
    """The checks the legacy wrappers make before a launch, on CPU tensors of
    the kernels' types: the weights an entry point does not read may be None."""
    bf = torch.bfloat16
    args, _, _ = _port_args()
    x, fw, cw, tl, it, w1, b1, w2, b2 = args
    good = [x.to(bf), fw.to(bf), cw, tl, it, w1.to(bf), b1, None, None]
    tfm._check_cuda_inputs(*good)
    good[7] = w2.to(bf)
    tfm._check_cuda_inputs(*good)
    good[7] = w2  # float32 where the kernel takes bf16
    with pytest.raises(ValueError, match="w2"):
        tfm._check_cuda_inputs(*good)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfm.moe_bwd_dw1(*(a.to("meta") for a in (x, fw, cw, tl, it, w1, b1, w2)),
                        torch.empty(T, C, device="meta"))

