"""The port's differentiable kernels on the CPU against the JAX package's gradients.

On the CPU `FlashAttentionFunction` and `FusedMoEFunction` take the plain
versions of both kernels (`flash_attention_bwd_reference`,
`moe_ffn_bwd_reference`). JAX runs its own CPU paths, eagerly: the
chunked attention for `flash_attention` and `moe_ffn_reference` for
`fused_moe_ffn`, each under its custom VJP. The CUDA kernels are held
against the plain versions on the card in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moegan_tpu.ops import flash_attention as jfa
from moegan_tpu.ops import fused_moe as jfm
from moegan_tpu_torch.ops import flash_attention as tfa
from moegan_tpu_torch.ops import fused_moe as tfm
from tests.torch_helpers import MOE_ORDER, moe_inputs, randn, t


@pytest.mark.parametrize("D", [16, 32])
def test_flash_gradients_match_jax(D):
    q, k, v = (randn(3 * D + i, 2, 256, 2, D) for i in range(3))
    do = randn(5 * D, 2, 256, 2, D)
    o, vjp = jax.vjp(jfa.flash_attention, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [t(x).requires_grad_(True) for x in (q, k, v)]
    before = tfa.flash_attention_bwd.launches
    got_o = tfa.FlashAttentionFunction.apply(*leaves)
    got = torch.autograd.grad(got_o, leaves, t(do))
    assert tfa.flash_attention_bwd.launches == before  # the CPU takes the plain version
    # float32: the online (port) and chunked (JAX) softmax differ in
    # summation order only.
    np.testing.assert_allclose(got_o.detach().numpy(), np.asarray(o), rtol=1e-5, atol=1e-5)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5,
                                   err_msg=f"d{name}")


def test_moe_gradients_match_jax():
    a = moe_inputs()
    dout, dprobs = randn(60, 96, 32), randn(61, 96, 4, scale=0.5)
    jargs = [jnp.asarray(a[k]) if k != "inv_temp" else jnp.float32(a[k]) for k in MOE_ORDER]
    (out, probs), vjp = jax.vjp(lambda *x: jfm.fused_moe_ffn(*x, False), *jargs)
    want = vjp((jnp.asarray(dout), jnp.asarray(dprobs)))
    leaves = [t(a[k]) if k != "inv_temp" else torch.tensor([a[k]]) for k in MOE_ORDER]
    leaves = [x.requires_grad_(True) for x in leaves]
    before = tfm.fused_moe_bwd.launches
    got_out, got_p = tfm.FusedMoEFunction.apply(*leaves)
    got = torch.autograd.grad((got_out, got_p), leaves, (t(dout), t(dprobs)))
    assert tfm.fused_moe_bwd.launches == before
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_p.detach().numpy(), np.asarray(probs), rtol=1e-5, atol=1e-6)
    # float32: the FFN part and the router chain are added in another order.
    for name, g, w in zip(MOE_ORDER, got, want):
        w = np.asarray(w).reshape(g.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"d{name}")
