"""Model FLOPs of the generator, the discriminator and the training step,
counted from a configuration's shapes (the dicts of `perfbench/configs`).

Counted: every matrix product and convolution of the algorithm, at two
operations a multiply-add (mapping and text MLPs, the modulation styles,
demodulation and convolutions, the offset fields, attention's projections
and its q k^T and p v, the cross-attention's value path, the router, the
experts and their combine, the RGB taps, the discriminator's convolutions
and text projection). Not counted: elementwise work, norms, softmax,
resampling. The soft training mixture counts every expert on every token;
the hard eval forward counts the experts a token selects. A backward counts
twice its forward where it needs the weights' and the inputs' gradients,
and once where it needs the inputs' alone; recomputation is never counted.

The work of one training step (nonsaturating loss, no shared fake):
  D phase: D(real) with R1 = forward, input gradient, and the backward of
  both graphs (2 + 2): 6 D forwards; the no-grad generator forward for the
  fake: 1 G; D(fake) and D(real, shuffled text) forward and backward: 3 + 3.
  G phase: G forward and backward: 3 G; D forward and its input gradient: 2.
  In all 4 G (soft) + 14 D forwards.
`tests/test_perfbench_counts.py` holds these to torch's FlopCounterMode run
over the reference.
"""

from __future__ import annotations

from perfbench.reference.model import channel_plan, channels, heads_for, resolutions

FLASH_MIN_T = 256  # the port's self-attention takes the flash kernels from T = 256 on


def attention_shapes(g: dict, batch: int) -> list[tuple[int, int, int, int, int]]:
    """[(resolution, B, H, T, head_dim)] of every block's self-attention."""
    ch = channels(g)
    out = []
    for r in resolutions(g):
        H = heads_for(g, ch[r])
        out.append((r, batch, H, r * r, ch[r] // H))
    return out


def flash_shapes(g: dict, batch: int):
    """The self-attentions the flash kernels compute: T >= FLASH_MIN_T."""
    return [s for s in attention_shapes(g, batch) if s[3] >= FLASH_MIN_T]


def moe_shapes(g: dict, batch: int) -> list[tuple[int, int, int, int, int, int]]:
    """[(resolution, T tokens, C, F, E, router hidden)] of every block's MoE."""
    ch = channels(g)
    return [(r, batch * r * r, ch[r], 4 * ch[r], g["num_experts"], g["router_hidden"])
            for r in resolutions(g)]


def _modconv(B, r, k, cin, cout, latent):
    return 2.0 * B * (latent * cin + r * r * k * k * cin * cout + cin * cout)


def generator_forward(g: dict, batch: int, experts_per_token: float | None = None) -> float:
    """FLOPs of one generator forward over `batch` images; soft routing (every
    expert) unless `experts_per_token` is given (1 for hard routing)."""
    B, ch, lat, td = batch, channels(g), g["latent_dim"], g["text_embedding_dim"]
    mw, E, h = g["mapping_width"], g["num_experts"], g["router_hidden"]
    k_sel = E if experts_per_token is None else experts_per_token
    flops = 2.0 * B * 2 * td * td
    flops += 2.0 * B * ((lat + td) * mw + (g["mapping_layers"] - 1) * mw * mw)
    cin = ch[4]
    for r in resolutions(g):
        c = ch[r]
        T = r * r
        if r <= g["offset_max_resolution"]:
            flops += 2.0 * B * T * 9 * (cin * 32 + 32 * 2) + 2.0 * B * T * 9 * (c * 32 + 32 * 2)
        flops += _modconv(B, r, 3, cin, c, lat) + _modconv(B, r, 3, c, c, lat)
        if cin != c:
            flops += _modconv(B, r, 1, cin, c, lat)
        flops += 2 * _modconv(B, r, 1, c, c, lat)  # proj_in, proj_out
        flops += 2.0 * B * T * 4 * c * c + 4.0 * B * T * T * c  # qkv, wo; q k^T, p v
        flops += 2.0 * B * (td * c + 2 * c * c)  # text projection, value path
        flops += 2.0 * B * (T * c * h + T * h * E + lat * h + h * E)  # router
        flops += 2.0 * B * T * k_sel * (2 * c * 4 * c + c)  # experts and combine
        if r >= g["rgb_min_resolution"]:
            flops += _modconv(B, r, 1, c, 3, lat)
        cin = c
    return flops


def truncation(g: dict) -> float:
    """FLOPs of the eval forward's mapping of the zero input (once a call)."""
    lat, td, mw = g["latent_dim"], g["text_embedding_dim"], g["mapping_width"]
    return 2.0 * ((lat + td) * mw + (g["mapping_layers"] - 1) * mw * mw)


def discriminator_forward(d: dict, batch: int) -> float:
    """FLOPs of one discriminator forward over `batch` images."""
    res, cin, flops = d["max_resolution"], 3, 0.0
    for c in channel_plan(d):
        res //= 2
        flops += 2.0 * batch * res * res * 16 * cin * c
        cin = c
    tf = d["text_features"]
    flops += 2.0 * batch * d["text_embedding_dim"] * tf
    flops += 2.0 * batch * res * res * (cin + tf)
    return flops


def train_step(config: dict, batch: int) -> float:
    """Model FLOPs of one training step (see the module docstring)."""
    tc = config["train_config"]
    return (4 * generator_forward(tc["generator"], batch)
            + 14 * discriminator_forward(tc["discriminator"], batch))


def generate_call(config: dict, batch: int) -> float:
    """Model FLOPs of one eval generator call: hard routing, one expert a token."""
    g = config["train_config"]["generator"]
    return generator_forward(g, batch, experts_per_token=1) + truncation(g)
