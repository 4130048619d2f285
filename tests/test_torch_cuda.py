"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where torch sees no CUDA device.
The file imports neither JAX nor the JAX package, so it runs on the card's
machine with `python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`
(`--noconftest` skips tests/conftest.py, which sets up JAX).
"""

import math

import pytest
import torch

from moegan_tpu_torch.ops import flash_attention as tfa
from moegan_tpu_torch.ops import fused_moe as tfm
from moegan_tpu_torch.ops import layernorm as tln
from moegan_tpu_torch.ops import upsample as tup
from torch_helpers import MOE_ORDER, moe_inputs, t  # tests/ is on sys.path under pytest


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# T below one 64-key tile (40), ragged (200, 1000), the res-64 length (4096);
# every head dim the kernel takes; (4096, 5, 32), (1000, 9, 16) and
# (200, 40, 32) make flash_plan pick 128-row q tiles (two 16-row strips a
# warp), the others 64-row tiles.
@pytest.mark.cuda
@pytest.mark.parametrize("T,H,D", [(256, 8, 16), (1024, 2, 32), (200, 1, 32), (40, 4, 16),
                                   (200, 3, 48), (1000, 17, 64), (1000, 2, 48),
                                   (4096, 5, 32), (4096, 1, 64), (1000, 9, 16), (200, 40, 32)])
def test_flash_kernel_matches_plain_on_card(cuda_device, T, H, D):
    # q|k|v as last-axis slices of one [B, T, 3HD] tensor (the strided path).
    g = torch.Generator(device=cuda_device).manual_seed(T)
    y = torch.randn((2, T, 3 * H * D), generator=g, device=cuda_device).to(torch.bfloat16)
    q, k, v = (y[..., i * H * D:(i + 1) * H * D].unflatten(-1, (H, D)) for i in range(3))
    o, lse = tfa.flash_attention(q, k, v, with_lse=True)
    o_again = tfa.flash_attention(q, k, v)
    o_twice = tfa.flash_attention(q, k, v)
    want_o, want_lse = tfa.flash_attention_reference(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o_again), "the no-lse call differs from the lse call"
    assert torch.equal(o_again, o_twice), "two calls differ"
    # A few bf16 ulps of the largest |o| (std(o) ~ sqrt(e/T) for N(0, 1)
    # inputs): the final rounding of o plus p rounded against different maxima.
    atol = 4 * 2.0 ** -8 * want_o.float().abs().max().item()
    torch.testing.assert_close(o.float(), want_o.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-2, rtol=0)


def moe_out_emulated(x, w1, b1, w2, b2, probs):
    """The MoE output with the kernel's specified roundings and nothing else:
    float64 products, h = bf16(gelu(z)) and ph = bf16(p_e h) before the second
    product, out unrounded. Returns (out, the rounding envelope 2^-8 (|out| +
    |ph| @ |W2|): one half-ulp rounding of out and of every term of the second
    product), both [T, C] float64."""
    z = torch.einsum("tc,ecf->etf", x.double(), w1.double()) + b1.double()[:, None, :]
    h = (0.5 * z * (1 + torch.erf(z / math.sqrt(2.0)))).to(torch.bfloat16).double()
    ph = (probs.double().t()[:, :, None] * h).to(torch.bfloat16).double()
    out = torch.einsum("etf,efc->tc", ph, w2.double()) + probs.double() @ b2.double()
    terms = torch.einsum("etf,efc->tc", ph.abs(), w2.double().abs())
    return out, 2.0 ** -8 * (out.abs() + terms)


# T below one token tile (5), C split over 2 and 4 warps (256, 512), C and F
# padded to the compiled widths (48, F = 80), and with `skew` experts 2 and 3
# far below the others: under hard routing never picked, so tiles skip
# experts; under soft routing p near 1e-6 on them and two experts sharing
# each token.
@pytest.mark.cuda
@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("C,T,F,skew", [(512, 100, 2048, 0), (128, 300, 512, 0),
                                        (32, 1000, 128, 0), (256, 5, 1024, 0),
                                        (256, 333, 1024, 1), (512, 77, 2048, 1), (48, 130, 80, 1)])
def test_moe_kernel_matches_plain_on_card(cuda_device, C, T, F, skew, hard):
    a = moe_inputs(seed=C, T=T, C=C, F=F, h=128, tie_row=min(5, T - 1))
    a["text_logits"][:, 2:] -= 40.0 * skew  # below the others by 20 after inv_temp
    bf = {"x", "fw", "w1", "w2"}
    args = [t(a[k]).to(cuda_device, torch.bfloat16 if k in bf else torch.float32)
            if k != "inv_temp" else a[k] for k in MOE_ORDER]
    out, p = tfm.fused_moe_ffn(*args, hard=hard)
    want_out, want_p = tfm.moe_ffn_reference(*args, hard=hard)
    out2, _ = tfm.fused_moe_ffn(*args, hard=hard)
    x, _, _, _, _, w1, b1, w2, b2 = args
    emu, envelope = moe_out_emulated(x, w1, b1, w2, b2, want_p)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)  # split partials are summed in a fixed order
    torch.testing.assert_close(p, want_p, atol=1e-5, rtol=0)
    err = (out.double() - emu).abs()
    ref_err = (want_out.double() - emu).abs()
    print(f"kernel - emulated: max {err.max().item():.4g}, max / envelope "
          f"{(err / envelope).max().item():.4g}; plain - emulated: max {ref_err.max().item():.4g}, "
          f"max / envelope {(ref_err / envelope).max().item():.4g}")
    assert (err <= envelope).all(), f"max |out - emulated| {err.max().item()}"
    if skew and not hard:
        # The plain version does not round p*h: near p = 0.5 on two experts
        # its sums drift from the specified roundings by more than the
        # comparison below allows at small |out|; both are held to those.
        assert (ref_err <= envelope).all(), f"max |plain - emulated| {ref_err.max().item()}"
    else:
        torch.testing.assert_close(out.float(), want_out.float(), atol=3e-2, rtol=2e-2)


# Ragged T at every head dim, below one tile (77) and across many (1000).
@pytest.mark.cuda
@pytest.mark.parametrize("T,H,D", [(256, 8, 16), (1024, 2, 32), (200, 1, 32), (136, 2, 64),
                                   (77, 3, 16), (333, 2, 48), (1000, 17, 16), (520, 33, 64)])
def test_flash_bwd_kernel_matches_plain_on_card(cuda_device, T, H, D):
    g = torch.Generator(device=cuda_device).manual_seed(T + 1)
    y = torch.randn((2, T, 3 * H * D), generator=g, device=cuda_device).to(torch.bfloat16)
    q, k, v = (y[..., i * H * D:(i + 1) * H * D].unflatten(-1, (H, D)) for i in range(3))
    do = torch.randn((2, T, H, D), generator=g, device=cuda_device).to(torch.bfloat16)
    o, lse = tfa.flash_attention(q, k, v, with_lse=True)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    again = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    want = tfa.flash_attention_bwd_reference(q, k, v, do)
    torch.cuda.synchronize()
    for name, a, b, c in zip("qkv", got, again, want):
        assert torch.equal(a, b), f"d{name}: two calls differ"
        # bf16 outputs with p and ds rounded to bf16 before their products:
        # a few bf16 ulps of the largest gradient.
        atol = 8 * 2.0 ** -8 * c.float().abs().max().item()
        torch.testing.assert_close(a.float(), c.float(), atol=atol, rtol=0, msg=f"d{name}")


# As the forward's cases, plus T not a multiple of the weight-gradient
# kernel's token tile or T ranges (77, 333, 200); the routing given (`probs=`,
# as FusedMoEFunction calls it), or computed by the forward kernel inside
# the call.
@pytest.mark.cuda
@pytest.mark.parametrize("given_probs", [False, True])
@pytest.mark.parametrize("C,T,F", [(512, 100, 2048), (128, 300, 512), (32, 1000, 128),
                                   (16, 77, 64), (256, 5, 1024), (256, 333, 1024),
                                   (48, 200, 80)])
def test_moe_bwd_kernel_matches_plain_on_card(cuda_device, C, T, F, given_probs):
    a = moe_inputs(seed=C + 1, T=T, C=C, F=F, h=128, tie_row=min(5, T - 1))
    bf = {"x", "fw", "w1", "w2"}
    args = [t(a[k]).to(cuda_device, torch.bfloat16 if k in bf else torch.float32)
            if k != "inv_temp" else torch.full((1,), a[k], device=cuda_device) for k in MOE_ORDER]
    g = torch.Generator(device=cuda_device).manual_seed(C)
    dout = torch.randn((T, C), generator=g, device=cuda_device).to(torch.bfloat16)
    probs = tfm.fused_moe_ffn(*args)[1] if given_probs else None
    got = tfm.fused_moe_bwd(*args, dout, probs=probs)
    again = tfm.fused_moe_bwd(*args, dout, probs=probs)
    want = tfm.moe_ffn_bwd_reference(*args, dout)
    torch.cuda.synchronize()
    for name, x, y, z in zip(("dx", "dp", "dw1", "db1", "dw2", "db2"), got, again, want):
        assert torch.equal(x, y), f"{name}: two calls differ"
        # dz and p*h are rounded to bf16 before the products (2^-9 relative
        # each); sums over up to 4C hidden units or T tokens.
        scale = z.abs().max().item()
        torch.testing.assert_close(x, z, atol=3e-2 * scale, rtol=0, msg=name)


def _combine_args(dev, E, C, T, onehot, seed):
    """A rank's view: E local experts of 4, probs = the local columns of a
    softmax over 4 (or of a one-hot), weights at the init scales."""
    g = torch.Generator(device=dev).manual_seed(seed)
    F_ = 4 * C
    probs = torch.softmax(torch.randn((T, 4), generator=g, device=dev) * 2, dim=-1)
    if onehot:
        probs = torch.nn.functional.one_hot(probs.argmax(-1), 4).float()
    probs = probs[:, :E].contiguous()

    def ru(*shape, bound):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * bound

    return [torch.randn((T, C), generator=g, device=dev).to(torch.bfloat16), probs,
            ru(E, C, F_, bound=C ** -0.5).to(torch.bfloat16), ru(E, F_, bound=C ** -0.5),
            ru(E, F_, C, bound=F_ ** -0.5).to(torch.bfloat16), ru(E, C, bound=F_ ** -0.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("onehot", [False, True])
@pytest.mark.parametrize("E,C,T", [(2, 32, 77), (1, 128, 300), (2, 512, 1024), (1, 256, 5),
                                   (2, 48, 333)])
def test_moe_combine_kernel_matches_plain_on_card(cuda_device, E, C, T, onehot):
    args = _combine_args(cuda_device, E, C, T, onehot, seed=C + T)
    out = tfm.moe_ffn_combine(*args)
    again = tfm.moe_ffn_combine(*args)
    want = tfm.moe_ffn_combine_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)  # split partials are summed in a fixed order
    # bf16 output, and p*h rounded to bf16 before the second product: a few
    # bf16 ulps of the largest |out|.
    atol = 4 * 2.0 ** -8 * want.float().abs().max().item()
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,T", [(2, 32, 77), (1, 128, 300), (2, 512, 1024), (1, 256, 5),
                                   (2, 48, 333)])
def test_moe_combine_bwd_kernel_matches_plain_on_card(cuda_device, E, C, T):
    args = _combine_args(cuda_device, E, C, T, False, seed=C + T + 1)
    g = torch.Generator(device=cuda_device).manual_seed(T)
    dout = torch.randn((T, C), generator=g, device=cuda_device).to(torch.bfloat16)
    got = tfm.moe_ffn_combine_bwd(*args, dout)
    again = tfm.moe_ffn_combine_bwd(*args, dout)
    want = tfm.moe_ffn_combine_bwd_reference(*args, dout)
    torch.cuda.synchronize()
    for name, x, y, z in zip(("dx", "dp", "dw1", "db1", "dw2", "db2"), got, again, want):
        assert torch.equal(x, y), f"{name}: two calls differ"
        # dz and p*h are rounded to bf16 before the products, as in the
        # fused MoE backward: within 2e-2 of the largest |grad|.
        scale = z.abs().max().item()
        torch.testing.assert_close(x, z, atol=2e-2 * scale, rtol=0, msg=name)


# Ragged N; the five norm shapes of a served batch-16 call (16-byte vectors
# on 4-32 lanes a row); C = 100 and C = 7, not whole vectors (single
# elements); one row; x 2 bytes past a 16-byte boundary (single elements).
@pytest.mark.cuda
@pytest.mark.parametrize("N,C,dtype,offset", [
    (1000, 32, torch.bfloat16, 0), (257, 512, torch.bfloat16, 0), (300, 96, torch.float32, 0),
    *[(16 * res * res, C, torch.bfloat16, 0)
      for res, C in ((4, 512), (8, 256), (16, 128), (32, 64), (64, 32))],
    (1000, 100, torch.bfloat16, 0), (777, 7, torch.bfloat16, 0), (1, 64, torch.bfloat16, 0),
    (1000, 64, torch.bfloat16, 1)])
def test_layer_norm_kernels_match_plain_on_card(cuda_device, N, C, dtype, offset):
    g = torch.Generator(device=cuda_device).manual_seed(N + C)
    x = torch.empty(N * C + offset, dtype=dtype, device=cuda_device)[offset:].view(N, C)
    x.copy_(torch.randn((N, C), generator=g, device=cuda_device) * 2 + 0.5)
    if offset:
        assert x.data_ptr() % 16 == 2
        assert tln.layer_norm_plan(N, C, dtype, False, 132).vec == 1
    scale = 1 + 0.1 * torch.randn(C, generator=g, device=cuda_device)
    bias = 0.1 * torch.randn(C, generator=g, device=cuda_device)
    dy = torch.randn((N, C), generator=g, device=cuda_device).to(dtype)
    y, y2 = tln.layer_norm_fwd(x, scale, bias), tln.layer_norm_fwd(x, scale, bias)
    got, again = tln.layer_norm_bwd(x, scale, dy), tln.layer_norm_bwd(x, scale, dy)
    want_y = tln.layer_norm(x, scale, bias)
    want = tln.layer_norm_bwd_reference(x, scale, dy)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    # one rounding to x's type, fp32 statistics summed in other orders
    atol = 2.0 ** -8 * want_y.float().abs().max().item()
    torch.testing.assert_close(y.float(), want_y.float(), atol=atol, rtol=0)
    for name, a, b, c, lim in zip(("dx", "dscale", "dbias"), got, again, want,
                                  (2 * 2.0 ** -8, 1e-3, 1e-3)):
        assert torch.equal(a, b), f"{name}: two calls differ"
        torch.testing.assert_close(a.float(), c.float(), rtol=0,
                                   atol=lim * c.float().abs().max().item(), msg=name)


@pytest.mark.cuda
def test_layer_norm_bwd_is_deterministic_at_res64(cuda_device):
    """Three backward calls at the res-64 shape (262,144 rows, 132 blocks on
    an H100): dscale and dbias bit-identical, so the blocks' partials are
    summed in a fixed order and the ticket counter is back at 0 after each
    call."""
    N, C = 64 * 64 * 64, 32
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = (torch.randn((N, C), generator=g, device=cuda_device) * 2 + 0.5).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(C, generator=g, device=cuda_device)
    dy = (torch.randn((N, C), generator=g, device=cuda_device) * 0.1).to(torch.bfloat16)
    runs = [tln.layer_norm_bwd(x, scale, dy) for _ in range(3)]
    torch.cuda.synchronize()
    for name, i in (("dx", 0), ("dscale", 1), ("dbias", 2)):
        assert all(torch.equal(runs[0][i], r[i]) for r in runs[1:]), name
    want = tln.layer_norm_bwd_reference(x, scale, dy)
    for name, a, c in zip(("dscale", "dbias"), runs[0][1:], want[1:]):
        # fp32 sums over N rows in other orders
        torch.testing.assert_close(a, c, rtol=0, atol=1e-3 * c.abs().max().item(), msg=name)


def ulp(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One unit in the last place of dtype (bf16 or float32) at |v|, in float32."""
    bits = 7 if dtype == torch.bfloat16 else 23
    return torch.exp2(torch.floor(torch.log2(v.float().abs().clamp_min(2.0 ** -100))) - bits)


# The generator's rungs at batch 4 (aurora64's four inputs, flagship's r16
# input 8x8x512), a ragged C with odd H != W (single elements), and x one
# element past a 16-byte boundary (single elements).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,W,C,offset", [(4, 4, 512, 0), (8, 8, 256, 0), (16, 16, 128, 0),
                                          (32, 32, 64, 0), (8, 8, 512, 0), (5, 7, 20, 0),
                                          (8, 8, 256, 1)])
def test_upsample_kernels_match_plain_on_card(cuda_device, H, W, C, offset, dtype):
    B = 4
    g = torch.Generator(device=cuda_device).manual_seed(H * W + C + offset)
    n = B * H * W * C
    x = torch.empty(n + offset, dtype=dtype, device=cuda_device)[offset:].view(B, H, W, C)
    x.copy_(torch.randn((B, H, W, C), generator=g, device=cuda_device) * 2 + 0.5)
    dy = torch.randn((B, 2 * H, 2 * W, C), generator=g, device=cuda_device).to(dtype)
    if offset:
        assert x.data_ptr() % 16 == x.element_size()
    fwd0, bwd0 = tup.upsample2x_fwd.launches, tup.upsample2x_bwd.launches
    leaf = x.detach().requires_grad_(True)
    y = tup.Upsample2xFunction.apply(leaf)
    (dx,) = torch.autograd.grad(y, leaf, dy)
    again = tup.upsample2x_bwd(dy)
    assert (tup.upsample2x_fwd.launches - fwd0, tup.upsample2x_bwd.launches - bwd0) == (1, 2)
    with torch.enable_grad():
        ref_leaf = x.detach().requires_grad_(True)
        want_y = tup.upsample2x_reference(ref_leaf)  # F.interpolate on the card
        (want_dx,) = torch.autograd.grad(want_y, ref_leaf, dy)
    # The terms' magnitudes, which bound the float32 roundings of a sum of them.
    fwd_terms = tup.upsample2x_reference(x.float().abs())
    bwd_terms = tup.upsample2x_bwd_reference(dy.float().abs())
    torch.cuda.synchronize()
    assert y.dtype == dx.dtype == dtype and y.shape == (B, 2 * H, 2 * W, C)
    assert torch.equal(dx, again), "two backward calls differ"
    # Forward: PyTorch's fp32 formula in its order (4 terms), rounded once;
    # FMA contraction may round the terms' sums apart by 4 float32 roundings
    # of their magnitude (2^-22), and the result's rounding then by one ulp.
    err = (y.float() - want_y.float()).abs()
    lim = ulp(want_y, dtype) + 2.0 ** -22 * fwd_terms
    assert (err <= lim).all(), f"forward: max |diff| {err.max().item()}"
    if dtype == torch.bfloat16:  # the products are exact on bf16 inputs
        equal = (y == want_y).float().mean().item()
        assert equal >= 0.99, f"forward: only {equal:.4f} of the elements equal"
    # Backward: PyTorch adds its terms with atomics in fp32, the kernel in a
    # fixed order; at most 16 terms, so within 16 float32 roundings of their
    # magnitude (2^-20), plus one ulp of the result's rounding.
    err = (dx.float() - want_dx.float()).abs()
    lim = ulp(want_dx, dtype) + 2.0 ** -20 * bwd_terms
    assert (err <= lim).all(), f"backward: max |diff| {err.max().item()}"


@pytest.mark.cuda
def test_upsample_dispatch_takes_the_generators_layout_on_card(cuda_device):
    """`core/upsample.py` on an NHWC view of NCHW memory, as rungs 8-32 of the
    generator hand it over: the kernels on the contiguous copy, with grad."""
    from moegan_tpu_torch.core.upsample import upsample2x_bilinear

    g = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn((4, 256, 8, 8), generator=g, device=cuda_device).to(torch.bfloat16)
    x = x.permute(0, 2, 3, 1).requires_grad_(True)
    dy = torch.randn((4, 16, 16, 256), generator=g, device=cuda_device).to(torch.bfloat16)
    assert not x.is_contiguous()
    fwd0, bwd0 = tup.upsample2x_fwd.launches, tup.upsample2x_bwd.launches
    y = upsample2x_bilinear(x)
    (dx,) = torch.autograd.grad(y, x, dy)
    assert (tup.upsample2x_fwd.launches - fwd0, tup.upsample2x_bwd.launches - bwd0) == (1, 1)
    assert torch.equal(y, tup.upsample2x_fwd(x.detach().contiguous()))
    assert torch.equal(dx, tup.upsample2x_bwd(dy))


# Every padded width (C = 32-512 and C = 48, padded to 64, and C = 16,
# padded to 32), each with the dW1 route its width takes (recompute up to
# C = 256, scratch above); T ragged against the token tiles (32 at C = 512,
# else 64) and the 32- and 128-token steps; F = 80 leaves a partial 64-unit
# chunk.
@pytest.mark.cuda
@pytest.mark.parametrize("C,T,F", [(512, 100, 2048), (256, 333, 1024), (128, 1000, 512),
                                   (64, 777, 256), (48, 130, 80), (32, 1000, 128),
                                   (16, 77, 64)])
def test_legacy_moe_bwd_kernels_match_plain_on_card(cuda_device, C, T, F):
    a = moe_inputs(seed=C + 2, T=T, C=C, F=F, h=128)
    bf = {"x", "fw", "w1", "w2"}
    args = [t(a[k]).to(cuda_device, torch.bfloat16 if k in bf else torch.float32)
            if k != "inv_temp" else torch.full((1,), a[k], device=cuda_device) for k in MOE_ORDER]
    x, fw, cw, tl, it, w1, b1, w2, b2 = args
    g = torch.Generator(device=cuda_device).manual_seed(C + 1)
    dout = torch.randn((T, C), generator=g, device=cuda_device).to(torch.bfloat16)
    # the forward's routing, as FusedMoEFunction hands it to the three
    probs = tfm.fused_moe_ffn(*args, hard=False)[1]
    for which in ("dw1", "dw2"):
        assert tfm.legacy_kernel_plan(which, T, C, F, 4, cuda_device).scratch == (C > 256)
    for name, fn, ref, inputs in (
            ("dx", tfm.moe_bwd_dx, tfm.moe_bwd_dx_reference, args),
            ("dw2", tfm.moe_bwd_dw2, tfm.moe_bwd_dw2_reference, args[:7]),
            ("dw1", tfm.moe_bwd_dw1, tfm.moe_bwd_dw1_reference, args[:8])):
        # without probs, the entry point takes the same routing from the forward kernel
        for u, v in zip(fn(*inputs, dout), fn(*inputs, dout, probs=probs)):
            assert torch.equal(u, v), f"{name}: the call without probs differs"
        got, again = fn(*inputs, dout, probs=probs), fn(*inputs, dout, probs=probs)
        want = ref(*inputs, dout)
        torch.cuda.synchronize()
        for i, (u, v, w) in enumerate(zip(got, again, want)):
            assert torch.equal(u, v), f"{name}[{i}]: two calls differ"
            # bf16 dz (and bf16 p*dout) before sums over T tokens or 4C hidden
            # units, summed in other orders: within 2e-2 of the largest |grad|
            torch.testing.assert_close(u, w, rtol=0, atol=2e-2 * w.abs().max().item(),
                                       msg=f"{name}[{i}]")


# Fault 3.1, closed: dW2's h is the TPU kernels' erf polynomial (moe_tiles.cuh's
# gelu_cdf), as the forward kernel's, bit for bit. W1 = 0, so z = b1, a grid of
# 4096 values in [-6, 6] over the hidden units; the text logits saturate the
# routing on expert 0, so bf16(p_0 * 1) = 1, and dout is one-hot at one token
# and channel, so dW2[0, :, channel] is h itself. The hard forward kernel gives
# the same h through W2 selecting one hidden unit per output channel, C units a
# call. (Kernel against kernel: in fp32, 1 - poly * exp(-x^2) cancels at
# z = -3..-6 by as much as the polynomial differs from erf, so no float64 or
# CPU polynomial decides these bits.) The call takes no `probs`: dW2 routes as
# the forward kernel does. C = 64 takes dW2's recompute route, C = 512 its scratch.
@pytest.mark.cuda
@pytest.mark.parametrize("C", [64, 512])
def test_legacy_dw2_gelu_matches_forward_kernel_bits(cuda_device, C):
    dev, bf = cuda_device, torch.bfloat16
    E, F, T, hid, tok, chan = 4, 4096, 16, 128, 3, 5
    g = torch.Generator(device=dev).manual_seed(C)
    x = torch.randn((T, C), generator=g, device=dev).to(bf)
    fw, cw = torch.zeros((C, hid), dtype=bf, device=dev), torch.zeros((hid, E), device=dev)
    tl = torch.zeros((T, E), device=dev)
    tl[:, 0] = 100.0  # clipped to 20: p_0 = 1 - 3e-6 after the 1e-6 floors
    it = torch.ones(1, device=dev)
    w1 = torch.zeros((E, C, F), dtype=bf, device=dev)
    b1 = torch.linspace(-6.0, 6.0, F, device=dev).expand(E, F).contiguous()
    dout = torch.zeros((T, C), dtype=bf, device=dev)
    dout[tok, chan] = 1.0
    h_dw2 = tfm.moe_bwd_dw2(x, fw, cw, tl, it, w1, b1, dout)[0][0, :, chan]
    h_fwd = torch.empty(F, device=dev)
    cols = torch.arange(C, device=dev)
    for k in range(F // C):
        w2 = torch.zeros((E, F, C), dtype=bf, device=dev)
        w2[:, k * C + cols, cols] = 1.0
        out, p = tfm.fused_moe_ffn(x, fw, cw, tl, it, w1, b1, w2,
                                   torch.zeros((E, C), device=dev), hard=True)
        assert (p[:, 0] == 1).all()
        h_fwd[k * C:(k + 1) * C] = out[tok].float()
    torch.cuda.synchronize()
    differ = h_dw2 != h_fwd
    assert not differ.any(), (
        f"{int(differ.sum())} of {F} z in [-6, 6] give dW2 another h than the forward kernel, "
        f"first at z = {b1[0][differ][:4].tolist()}")


@pytest.mark.cuda
def test_legacy_entry_points_take_no_tokens(cuda_device):
    """T = 0: zero gradients from all three legacy entry points, no launch."""
    a = moe_inputs(seed=3, T=8, C=32, F=128, h=128)
    bf = {"x", "fw", "w1", "w2"}
    args = [t(a[k]).to(cuda_device, torch.bfloat16 if k in bf else torch.float32)
            if k != "inv_temp" else torch.full((1,), a[k], device=cuda_device) for k in MOE_ORDER]
    args[0], args[3] = args[0][:0], args[3][:0]  # x [0, C], text_logits [0, E]
    dout = torch.zeros((0, 32), dtype=torch.bfloat16, device=cuda_device)
    before = [f.launches for f in (tfm.moe_bwd_dx, tfm.moe_bwd_dw2, tfm.moe_bwd_dw1)]
    dx, dp = tfm.moe_bwd_dx(*args, dout)
    dw2, db2 = tfm.moe_bwd_dw2(*args[:7], dout)
    dw1, db1 = tfm.moe_bwd_dw1(*args[:8], dout)
    torch.cuda.synchronize()
    assert [f.launches for f in (tfm.moe_bwd_dx, tfm.moe_bwd_dw2, tfm.moe_bwd_dw1)] == before
    for got, shape in ((dx, (0, 32)), (dp, (0, 4)), (dw2, (4, 128, 32)), (db2, (4, 32)),
                       (dw1, (4, 32, 128)), (db1, (4, 128))):
        assert got.shape == shape and got.dtype == torch.float32
        assert not got.any()
