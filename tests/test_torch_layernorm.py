"""The port's LayerNorm twins against the JAX package's Pallas LayerNorm.

JAX `fused_layer_norm` runs its TPU kernels `_fwd_kernel` and `_bwd_kernel`
in interpret mode, as tests/test_fused_layernorm.py runs them (`pallas_call`
patched to `interpret=True`, `_supported` patched to True). The port's
plain forward `layer_norm` and backward `layer_norm_bwd_reference` are the
functions that chip_smoke.py and tests/test_torch_cuda.py hold the CUDA
kernels against; on the CPU the wrappers, `FusedLayerNormFunction` and
`FusedLayerNorm` take them.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moegan_tpu.ops import fused_layernorm as fln
from moegan_tpu_torch.config import GeneratorConfig
from moegan_tpu_torch.models.generator import AuroraGenerator
from moegan_tpu_torch.ops import layernorm as tln
from tests.torch_helpers import TINY_KW, randn, t

EPS = 1e-5
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _case(dtype, C, lead=(4, 16), seed=0):
    """(x, scale, bias, dy) as numpy float32; x with a non-zero mean per row."""
    x = randn(seed, *lead, C, scale=2.0) + randn(seed + 1, *lead, 1)
    return (x, 1.0 + randn(seed + 2, C, scale=0.1), randn(seed + 3, C, scale=0.1),
            randn(seed + 4, *lead, C))


def _jax_ln(x, scale, bias, dy, jdt, kernel: bool):
    """JAX fused_layer_norm's output and (dx, dscale, dbias), through the TPU
    kernels in interpret mode when `kernel`, else through its own dispatch."""
    real = fln.pl.pallas_call

    def interpret(*a, **kw):
        kw["interpret"] = True
        return real(*a, **kw)

    patches = [mock.patch.object(fln.pl, "pallas_call", interpret)]
    if kernel:
        patches.append(mock.patch.object(fln, "_supported", lambda *a: True))
    for p in patches:
        p.start()
    try:
        y, vjp = jax.vjp(lambda a, s, b: fln.fused_layer_norm(a, s, b, EPS),
                         jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias))
        grads = vjp(jnp.asarray(dy, jdt))
    finally:
        for p in patches:
            p.stop()
    return [np.asarray(a, np.float32) for a in (y, *grads)]


CASES = [(name, C) for name in DTYPES for C in (32, 128)]


@pytest.fixture(scope="module")
def jax_kernels():
    """Every (dtype, C) case through the two TPU kernels (N = 64 rows, 8 per
    block), and the ragged cases (N = 15) through JAX's XLA fallback."""
    out = {}
    for name, C in CASES:
        out[(name, C)] = _jax_ln(*_case(name, C, seed=C), DTYPES[name][1], kernel=True)
    for name in DTYPES:
        out[(name, "ragged")] = _jax_ln(*_case(name, 32, lead=(3, 5), seed=7), DTYPES[name][1],
                                        kernel=False)
    return out


def _port(x, scale, bias, dy, tdt):
    xt, dyt = t(x).to(tdt), t(dy).to(tdt)
    y = tln.layer_norm(xt, t(scale), t(bias), EPS)
    dx, ds, db = tln.layer_norm_bwd_reference(xt, t(scale), dyt, EPS)
    assert y.dtype == dx.dtype == tdt and ds.dtype == db.dtype == torch.float32
    return [a.float().numpy() for a in (y, dx, ds, db)]


def _assert_matches(got, want, bf16: bool):
    for name, g, w in zip(("y", "dx", "dscale", "dbias"), got, want):
        top = float(np.abs(w).max())
        if bf16 and name in ("y", "dx"):
            # both sides compute in fp32 and round once to bf16: one bf16 ulp
            # of the largest value
            atol = 2.0 ** (np.floor(np.log2(top)) - 7)
        else:
            # fp32 on both sides, summed in other orders
            atol = 1e-5 * max(top, 1.0)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("name,C", CASES)
def test_twins_match_jax_kernels(jax_kernels, name, C):
    got = _port(*_case(name, C, seed=C), DTYPES[name][0])
    _assert_matches(got, jax_kernels[(name, C)], name == "bfloat16")


@pytest.mark.parametrize("name", list(DTYPES))
def test_twins_match_jax_on_ragged_rows(jax_kernels, name):
    # 15 rows: no row block divides them, so JAX takes `_xla_ln` and its vjp
    got = _port(*_case(name, 32, lead=(3, 5), seed=7), DTYPES[name][0])
    _assert_matches(got, jax_kernels[(name, "ragged")], name == "bfloat16")


def test_fused_module_matches_plain_under_either_flag(monkeypatch):
    """`FusedLayerNorm` under MOEGAN_FUSED_LN=1 (the autograd function, whose
    CPU path is the twins) and without it (plain autograd) gives the same
    output and gradients, and launches no kernel on the CPU."""
    x, scale, bias, dy = _case("float32", 24, lead=(2, 9), seed=3)
    results = []
    for flag in (None, "1"):
        if flag is None:
            monkeypatch.delenv("MOEGAN_FUSED_LN", raising=False)
        else:
            monkeypatch.setenv("MOEGAN_FUSED_LN", flag)
        mod = tln.FusedLayerNorm(24)
        with torch.no_grad():
            mod.weight.copy_(t(scale))
            mod.bias.copy_(t(bias))
        xt = t(x).requires_grad_(True)
        y = mod(xt)
        y.backward(t(dy))
        results.append([a.detach().numpy() for a in (y, xt.grad, mod.weight.grad, mod.bias.grad)])
    assert tln.layer_norm_fwd.launches == 0 and tln.layer_norm_bwd.launches == 0
    for name, a, b in zip(("y", "dx", "dscale", "dbias"), *results):
        # float32, the same formula differentiated by hand and by autograd
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)


def test_norms_are_fused_where_jax_fuses_them():
    """norm1-3 of every attention block are `FusedLayerNorm`, as in the JAX
    block; the generator's text projection keeps the plain LayerNorm, as the
    JAX generator keeps `nn.LayerNorm` there."""
    gen = AuroraGenerator(GeneratorConfig(**TINY_KW))
    fused = sorted(n for n, m in gen.named_modules() if isinstance(m, tln.FusedLayerNorm))
    want = sorted(f"gen_block_{r}.attn_block.norm{i}" for r in TINY_KW["channels"]
                  for i in (1, 2, 3))
    assert fused == want
    assert type(gen.text_proj_ln) is tln.LayerNorm


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks run before any launch (no card needed: a meta tensor is
    neither cpu nor cuda, and the shape checks raise first)."""
    with pytest.raises(ValueError, match="cpu or cuda"):
        tln.layer_norm_fwd(torch.empty(4, 8, device="meta"), torch.ones(8), torch.zeros(8))
    x = torch.empty(4, tln.MAX_C + 8)
    with pytest.raises(ValueError, match="C="):
        tln._check(x, torch.ones(tln.MAX_C + 8))
    with pytest.raises(ValueError, match="scale"):
        tln._check(torch.empty(4, 8), torch.ones(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="dy"):
        tln._check(torch.empty(4, 8), torch.ones(8), dy=torch.empty(4, 9))
