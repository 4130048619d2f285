"""Plain float32 Aurora generator and text-conditional discriminator.

A frozen copy of the model's arithmetic, written from its description, with
no kernel, no cache and no batching trick, over a flat dict of parameters
{name: tensor} whose names and layouts are the benchmark's weight files'
(nn.Linear weights [out, in]; attention, router and expert weights [in,
out]; convolutions OIHW; activations NHWC). It imports nothing of the
program. Configurations are the plain dicts of `perfbench/configs/*.json`
(`train_config.generator` and `train_config.discriminator`).

Generator (eval and training forward):
  text_seq = Linear -> LayerNorm(1e-5) -> LeakyReLU(0.2) -> Linear of the text;
  w = mapping MLP of [z || text] (LeakyReLU between layers), moved toward
  mapping(0) by a per-sample psi at eval; x = the learned 4x4 constant; per
  resolution r: x2 bilinear upsample (r > 4, half-pixel centres), two
  modulated-transformation modules (a grid-sampled offset field at r <=
  offset_max_resolution, then a demodulated 3x3 conv and LeakyReLU) plus a
  1x1 modulated skip when the width changes, then the attention block:
  1x1 modulated proj_in, LayerNorm + multi-head self-attention (softmax over
  all keys), text cross-attention, LayerNorm + the sparse MoE FFN behind
  the Bayesian router, 1x1 modulated proj_out; RGB taps (1x1 modulated conv
  to 3 channels) at r >= rgb_min_resolution.

Departures from the program's arithmetic, each exact in real arithmetic:
  - everything is float32 (the program runs its products in bfloat16);
  - the cross-attention attends to one text token, whose softmax weight is
    exactly 1, so it is computed as the value projection of that token
    through the output projection, broadcast over the queries;
  - the hard (eval) routing takes the one-hot of the largest probability,
    split evenly between exactly tied experts, computed densely over all
    experts with the one-hot as the mixture weights;
  - self-attention runs in blocks of queries, each recomputed in the
    backward (`torch.utils.checkpoint`), and a training forward with grad
    recomputes each generative block in the backward: the same values, in
    less memory.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.precision import FP32, Precision

# Elements of one block of attention probabilities [B, H, Tq, T] (fp32: 1 GiB).
ATTN_BLOCK_ELEMENTS = 1 << 28
# Tokens of one block of the eval MoE's dense [E, tokens, 4C] hidden activations.
MOE_BLOCK_ELEMENTS = 1 << 28


def resolutions(g: dict) -> list[int]:
    out, r = [], 4
    while r <= g["max_resolution"]:
        out.append(r)
        r *= 2
    return out


def channels(g: dict) -> dict[int, int]:
    return {int(k): int(v) for k, v in g["channels"].items()}


def heads_for(g: dict, dim: int) -> int:
    """8 heads at width >= 128; narrower blocks halve the heads until head_dim >= 32."""
    h = g["attn_heads"]
    if dim >= 128:
        return h
    while h > 1 and dim // h < 32:
        h //= 2
    return max(h, 1)


def channel_plan(d: dict) -> list[int]:
    """Output widths of the discriminator's stride-2 convolutions down to 4x4."""
    if d["max_resolution"] == 16:
        return [128, 256]
    ch, plan = d["base_channels"], []
    for _ in range(int(math.log2(d["max_resolution"] // 4))):
        ch = min(ch * 2, d["max_channels"])
        plan.append(ch)
    return plan


def leaky(x):
    return F.leaky_relu(x, 0.2)


def layer_norm(x, weight, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * weight + bias


def linear(P, name, x, pc: Precision):
    return pc.q(x) @ pc.q(P[f"{name}.weight"]).t() + P[f"{name}.bias"]


def modconv(P, name, x, w, pc: Precision):
    """Demodulated convolution: conv(x * style, W) * rsqrt(sum W^2 style^2 + 1e-8)."""
    W = P[f"{name}.weight"]
    style = pc.q(w) @ pc.q(P[f"{name}.mod_kernel"]) + P[f"{name}.mod_bias"]
    xs = (x * style[:, None, None, :]).permute(0, 3, 1, 2)
    out = F.conv2d(pc.q(xs), pc.q(W), padding=W.shape[-1] // 2).permute(0, 2, 3, 1)
    demod = torch.rsqrt(style.square() @ W.square().sum(dim=(2, 3)).t() + 1e-8)
    return out * demod[:, None, None, :]


def mtm(P, name, x, w, use_offset: bool, pc: Precision):
    if use_offset:
        B, H, W_, _ = x.shape
        c1, c2 = f"{name}.offset_conv1", f"{name}.offset_conv2"
        h = leaky(F.conv2d(pc.q(x.permute(0, 3, 1, 2)), pc.q(P[f"{c1}.weight"]),
                           P[f"{c1}.bias"], padding=1))
        offsets = F.conv2d(pc.q(h), pc.q(P[f"{c2}.weight"]), P[f"{c2}.bias"],
                           padding=1).permute(0, 2, 3, 1)
        ys = torch.linspace(-1.0, 1.0, H, device=x.device)
        xs = torch.linspace(-1.0, 1.0, W_, device=x.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        grid = torch.clamp(torch.stack([gx, gy], dim=-1)[None] + offsets * 0.05, -1.0, 1.0)
        x = F.grid_sample(x.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False).permute(0, 2, 3, 1)
    return leaky(modconv(P, f"{name}.modulated_conv", x, w, pc))


def _attend(q, k, v):
    """softmax(q k^T / sqrt(d)) v over [B, Tq, H, d] queries and [B, T, H, d] keys."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def attention(q, k, v, pc: Precision):
    B, T, H, _ = q.shape
    q, k, v = pc.q(q), pc.q(k), pc.q(v)
    block = max(1, min(T, ATTN_BLOCK_ELEMENTS // max(1, B * H * T)))
    outs = []
    for i in range(0, T, block):
        qi = q[:, i:i + block]
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attend, qi, k, v, use_reentrant=False))
        else:
            outs.append(_attend(qi, k, v))
    return torch.cat(outs, dim=1)


def reparameterize(mu, rho, eps):
    mu = torch.clamp(mu, -10.0, 10.0)
    rho = torch.clamp(rho, -8.0, 4.0)
    sigma = torch.clamp(torch.log1p(torch.exp(rho)), 1e-6, 10.0)
    return mu + sigma * torch.clamp(eps, -2.0, 2.0)


def gaussian_kl(mu, rho):
    sigma = torch.log1p(torch.exp(rho))
    log_var = 2.0 * torch.log(sigma)
    return 0.5 * torch.sum(torch.exp(log_var) + mu.square() - 1.0 - log_var)


def router_kl(P, name):
    kl = sum(gaussian_kl(P[f"{name}.{k}_mu"], P[f"{name}.{k}_rho"])
             for k in ("feature", "text", "combined"))
    kl = torch.nan_to_num(kl, nan=0.0, posinf=200.0, neginf=0.0)
    return torch.clamp(kl, 0.0, 120.0)


def moe(P, name, x, w, training: bool, annealing, eps, pc: Precision, route=None):
    """x [B, T, C] normalised tokens, w [B, latent] -> (out [B, T, C], kl, probs [B, T, E],
    gap [B, T]).

    At eval `route` [B, T, E], when given, is a judged program's hard routing:
    the mixture follows it, and gap is, per token, how far the largest of
    this router's logits lies above the logit of the best expert `route`
    selects (0 where the selection is this router's own top expert)."""
    r = f"{name}.router"
    kinds = ("feature", "text", "combined")
    if training:
        fw, tw, cw = (reparameterize(P[f"{r}.{k}_mu"], P[f"{r}.{k}_rho"], e)
                      for k, e in zip(kinds, eps))
    else:
        fw, tw, cw = (P[f"{r}.{k}_mu"] for k in kinds)
    h = fw.shape[1]
    logits = (pc.q(x) @ pc.q(fw)) @ pc.q(cw[:h]) + ((pc.q(w) @ pc.q(tw)) @ pc.q(cw[h:]))[:, None]
    temp = torch.clamp(P[f"{r}.temperature"][0] * annealing, 0.5, 5.0)
    probs = torch.softmax(torch.clamp(logits / temp, -20.0, 20.0), dim=-1)
    probs = torch.clamp(probs, 1e-6, 1.0)
    probs = probs / probs.sum(dim=-1, keepdim=True)
    gap = None
    if not training:
        onehot = (probs == probs.amax(dim=-1, keepdim=True)).to(probs.dtype)
        probs = onehot / onehot.sum(dim=-1, keepdim=True)
        if route is not None:
            scaled = logits / temp
            chosen = torch.where(route > 0, scaled, torch.full_like(scaled, -torch.inf))
            gap = scaled.amax(dim=-1) - chosen.amax(dim=-1)
            probs = route.to(probs.dtype)
    w1, b1, w2, b2 = (P[f"{name}.{k}"] for k in ("w1", "b1", "w2", "b2"))
    B, T, C = x.shape
    E, _, Fh = w1.shape
    xf, pf = x.reshape(B * T, C), probs.reshape(B * T, E)
    block = B * T if training else max(1, MOE_BLOCK_ELEMENTS // (E * Fh))
    outs = []
    for i in range(0, B * T, block):
        xi = pc.q(xf[i:i + block])
        hid = F.gelu(torch.einsum("tc,ecf->etf", xi, pc.q(w1)) + b1[:, None], approximate="none")
        y = torch.einsum("etf,efc->etc", pc.q(hid), pc.q(w2)) + b2[:, None]
        outs.append(torch.einsum("te,etc->tc", pf[i:i + block], y))
    out = torch.cat(outs).reshape(B, T, C)
    kl = router_kl(P, r) if training else x.new_zeros(())
    return out, kl, probs, gap


def self_attention(P, name, x, heads: int, pc: Precision):
    B, T, D = x.shape
    hd = D // heads
    xq = pc.q(x)

    def proj(k):
        return (xq @ pc.q(P[f"{name}.w{k}"]) + P[f"{name}.b{k}"]).unflatten(-1, (heads, hd))

    out = attention(proj("q"), proj("k"), proj("v"), pc).reshape(B, T, D)
    return pc.q(out) @ pc.q(P[f"{name}.wo"]) + P[f"{name}.bo"]


def cross_attention_one_token(P, name, tproj, pc: Precision):
    """Attention over one key/value token: its value through the output projection [B, 1, D]."""
    v = pc.q(tproj) @ pc.q(P[f"{name}.wv"]) + P[f"{name}.bv"]
    return pc.q(v) @ pc.q(P[f"{name}.wo"]) + P[f"{name}.bo"]


def attention_block(P, name, x, w, text_seq, heads, training, annealing, eps, pc: Precision,
                    route=None):
    B, H, W_, C = x.shape
    tokens = modconv(P, f"{name}.proj_in", x, w, pc).reshape(B, H * W_, C)
    n1 = layer_norm(tokens, P[f"{name}.norm1.weight"], P[f"{name}.norm1.bias"])
    tokens = tokens + self_attention(P, f"{name}.self_attn", n1, heads, pc)
    tproj = linear(P, f"{name}.text_proj", text_seq, pc)
    tokens = tokens + cross_attention_one_token(P, f"{name}.cross_attn", tproj, pc)
    n3 = layer_norm(tokens, P[f"{name}.norm3.weight"], P[f"{name}.norm3.bias"])
    out, kl, probs, gap = moe(P, f"{name}.moe", n3, w, training, annealing, eps, pc, route)
    tokens = tokens + out
    return modconv(P, f"{name}.proj_out", tokens.reshape(B, H, W_, C), w, pc), kl, probs, gap


def generative_block(P, g: dict, r: int, x, w, text_seq, training, annealing, eps,
                     pc: Precision, route=None):
    name = f"gen_block_{r}"
    if r > 4:
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
    use_offset = r <= g["offset_max_resolution"]
    cb = f"{name}.conv_block"
    out = mtm(P, f"{cb}.mtm2", mtm(P, f"{cb}.mtm1", x, w, use_offset, pc), w, use_offset, pc)
    identity = modconv(P, f"{cb}.skip_proj", x, w, pc) if f"{cb}.skip_proj.weight" in P else x
    x = out + identity
    return attention_block(P, f"{name}.attn_block", x, w, text_seq,
                           heads_for(g, channels(g)[r]), training, annealing, eps, pc, route)


def mapping(P, g: dict, v, pc: Precision):
    n = g["mapping_layers"]
    for i in range(n):
        v = linear(P, f"mapping_{i}", v, pc)
        if i < n - 1:
            v = leaky(v)
    return v


def generator(P, g: dict, z, text, psi=None, training=False, annealing=1.0, router_eps=None,
              pc: Precision = FP32, remat: bool = True, routes=None):
    """-> (image [B, R, R, 3], {r: RGB tap}, summed router KL, [per-block probs [B, T, E]],
    [per-block routing gaps [B, T] or None]).

    psi: None (no truncation) or a per-sample [B] tensor. In training each
    block's router weights are sampled with `router_eps[r]` = (eps_f, eps_t, eps_c)
    and the routing is soft; at eval the posterior means route hard. `remat`
    recomputes each block in the backward of a training forward with grad.
    `routes` (eval only): a judged program's per-block hard routing, which the
    mixtures follow (see `moe`); the gaps say how far each choice lies below
    this router's best.
    """
    B = z.shape[0]
    te = text.expand(B, text.shape[-1]) if text.shape[0] == 1 else text
    h1 = linear(P, "text_proj_1", te, pc)
    h1 = leaky(layer_norm(h1, P["text_proj_ln.weight"], P["text_proj_ln.bias"]))
    text_seq = linear(P, "text_proj_2", h1, pc)[:, None, :]
    w = mapping(P, g, torch.cat([z, te], dim=-1), pc)
    if psi is not None:
        mean_latent = mapping(P, g, z.new_zeros((1, z.shape[1] + te.shape[1])), pc).detach()
        w = mean_latent + psi[:, None] * (w - mean_latent)
    ch = channels(g)
    x = P["constant"].expand(B, 4, 4, ch[4])
    remat = remat and training and torch.is_grad_enabled()
    kls, routing, gaps, rgbs = [], [], [], {}
    for i, r in enumerate(resolutions(g)):
        eps = router_eps[r] if training else None
        args = (x, w, text_seq, training, annealing, eps, pc,
                None if routes is None else routes[i])
        if remat:
            x, kl, probs, gap = checkpoint(generative_block, P, g, r, *args, use_reentrant=False)
        else:
            x, kl, probs, gap = generative_block(P, g, r, *args)
        kls.append(kl)
        routing.append(probs)
        gaps.append(gap)
        if r >= g["rgb_min_resolution"]:
            rgbs[r] = modconv(P, f"to_rgb_{r}", x, w, pc)
    return rgbs[g["max_resolution"]], rgbs, torch.stack(kls).sum(), routing, gaps


def wn_conv(P, name, x, stride: int, padding: int, pc: Precision):
    v = P[f"{name}.v"]
    W = P[f"{name}.g"][:, None, None, None] / torch.sqrt(
        v.square().sum(dim=(1, 2, 3), keepdim=True) + 1e-12) * v
    out = F.conv2d(pc.q(x.permute(0, 3, 1, 2)), pc.q(W), stride=stride, padding=padding)
    return out.permute(0, 2, 3, 1) + P[f"{name}.b"]


def discriminator(P, d: dict, img, text, pc: Precision = FP32):
    """img [B, R, R, 3], text [B, text_dim] -> logits [B]."""
    x = img
    for i in range(len(channel_plan(d))):
        x = leaky(wn_conv(P, f"conv_{i}", x, 2, 1, pc))
    v = P["text_projection.v"]
    norm = torch.sqrt(v.square().sum(dim=0, keepdim=True) + 1e-12)
    Wt = P["text_projection.g"][None, :] / norm * v
    tfeat = leaky(pc.q(text) @ pc.q(Wt) + P["text_projection.b"])
    B, h = x.shape[0], x.shape[1]
    tmap = tfeat[:, None, None, :].expand(B, h, h, tfeat.shape[-1])
    out = wn_conv(P, "output_conv", torch.cat([x, tmap], dim=-1), 1, 0, pc)
    return out.reshape(B)
