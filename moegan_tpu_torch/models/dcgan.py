"""Baseline text-conditional DCGAN (counterpart of moegan_tpu/models/dcgan.py).

Generator: [z (100) || relu(text_proj (128))] as a 1x1 map, a 4x4 stride-4
transposed conv to 4x4, three 4x4 stride-2 transposed convs to 32x32, each
with BatchNorm and ReLU, and a last transposed conv with bias to 64x64x3
under tanh. Discriminator: four 4x4 stride-2 convs to 4x4 (GroupNorm with 8
groups after all but the first), LeakyReLU(0.2), a 128-wide text projection
tiled onto the 4x4 grid, a 4x4 valid conv to one logit and a sigmoid: D
returns probabilities. Images are NHWC in [-1, 1] at the module boundary.
Training: BCE on probabilities clipped to [1e-7, 1 - 1e-7], Adam(2e-4,
beta1 0.5), D then G each step.

What follows flax, not torch's defaults:
- `nn.ConvTranspose(padding="SAME")` correlates the stride-dilated input
  with its kernel unflipped; `nn.ConvTranspose2d` (k = 4, s = 2, padding 1;
  s = 4, padding 0 from 1x1) is the true transposed convolution, so the
  converter (`convert.dcgan_to_jax` / `dcgan_from_jax`) flips the kernel
  spatially. The output sizes and alignment are the same.
- BatchNorm (`_BatchNorm`): batch statistics E[x^2] - E[x]^2 over (N, H,
  W) in training, the biased variance kept in the running average with
  momentum 0.99 (flax), eps 1e-5; GroupNorm eps 1e-6.
- JAX's step runs G twice on the same z and weights (its D phase's output
  is detached and its batch statistics are dropped, dcgan.py:123-126); here
  one training forward serves both phases, so the running statistics move
  once a step, as JAX's do.
- Weights are drawn from flax's default distributions (lecun-normal
  kernels, zero biases) with a `torch.Generator`, and z from a
  `torch.Generator`: seeded runs differ from `jax.random`'s. Tests carry the
  weights and z across.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from moegan_tpu_torch.core import inits

Z_DIM = 100
TEXT_PROJ = 128
BN_MOMENTUM = 0.99
BN_EPS = 1e-5
GN_EPS = 1e-6


def _fast_stats(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) over `dims` in float32 as flax computes them: E[x^2] - E[x]^2, >= 0."""
    x = x.float()
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.clamp((x * x).mean(dim=dims, keepdim=True) - mean * mean, min=0.0)
    return mean, var


def _dense(in_dim: int, out_dim: int, gen: torch.Generator) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        layer.weight.copy_(inits.lecun_normal((in_dim, out_dim), gen).t())
        layer.bias.zero_()
    return layer


def _convt(in_ch: int, out_ch: int, stride: int, bias: bool,
           gen: torch.Generator) -> nn.ConvTranspose2d:
    layer = nn.ConvTranspose2d(in_ch, out_ch, 4, stride, padding=1 if stride == 2 else 0,
                               bias=bias)
    with torch.no_grad():  # flax's kernel [4, 4, in, out], flipped: [in, out, 4, 4]
        k = inits.lecun_normal((4, 4, in_ch, out_ch), gen)
        layer.weight.copy_(k.flip(0, 1).permute(2, 3, 0, 1))
        if bias:
            layer.bias.zero_()
    return layer


def _conv(in_ch: int, out_ch: int, stride: int, padding: int, bias: bool,
          gen: torch.Generator) -> nn.Conv2d:
    layer = nn.Conv2d(in_ch, out_ch, 4, stride, padding=padding, bias=bias)
    with torch.no_grad():
        layer.weight.copy_(inits.hwio_to_oihw(inits.lecun_normal((4, 4, in_ch, out_ch), gen)))
        if bias:
            layer.bias.zero_()
    return layer


class _BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over NCHW channels: `weight`/`bias` are flax's
    scale/bias, the buffers `mean`/`var` its batch_stats."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))

    def forward(self, x: torch.Tensor, training: bool) -> torch.Tensor:
        if training:
            mean, var = _fast_stats(x, (0, 2, 3))
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean.flatten())
                self.var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var.flatten())
        else:
            mean, var = self.mean[None, :, None, None], self.var[None, :, None, None]
        mul = torch.rsqrt(var + BN_EPS) * self.weight[None, :, None, None]
        return (x - mean) * mul + self.bias[None, :, None, None]


class _GroupNorm(nn.Module):
    """flax `nn.GroupNorm(num_groups=8)` (eps 1e-6) over NCHW channels."""

    def __init__(self, ch: int, groups: int = 8):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        g = x.reshape(B, self.groups, C // self.groups, H, W)
        mean, var = _fast_stats(g, (2, 3, 4))
        y = ((g - mean) * torch.rsqrt(var + GN_EPS)).reshape(B, C, H, W)
        return y * self.weight[None, :, None, None] + self.bias[None, :, None, None]


class DCGANGenerator(nn.Module):
    def __init__(self, base_features: int = 64, text_dim: int = 512,
                 gen: torch.Generator | None = None):
        super().__init__()
        gen = inits.default_generator(gen)
        f = base_features
        self.text_proj = _dense(text_dim, TEXT_PROJ, gen)
        self.convt_in = _convt(Z_DIM + TEXT_PROJ, f * 8, 4, False, gen)
        self.bn_in = _BatchNorm(f * 8)
        for name, cin, cout in (("8", f * 8, f * 4), ("16", f * 4, f * 2), ("32", f * 2, f)):
            self.add_module(f"convt_{name}", _convt(cin, cout, 2, False, gen))
            self.add_module(f"bn_{name}", _BatchNorm(cout))
        self.convt_out = _convt(f, 3, 2, True, gen)

    def forward(self, z: torch.Tensor, text_emb: torch.Tensor,
                training: bool = True) -> torch.Tensor:
        """z [B, 100], text_emb [B, text_dim] -> images [B, 64, 64, 3] in [-1, 1].
        `training` normalises with the batch statistics and updates the running ones."""
        t = F.relu(self.text_proj(text_emb.float()))
        x = torch.cat([z.float(), t], dim=-1)[:, :, None, None]
        x = F.relu(self.bn_in(self.convt_in(x), training))
        for name in ("8", "16", "32"):
            x = getattr(self, f"convt_{name}")(x)
            x = F.relu(getattr(self, f"bn_{name}")(x, training))
        return torch.tanh(self.convt_out(x)).permute(0, 2, 3, 1)


class DCGANDiscriminator(nn.Module):
    def __init__(self, base_features: int = 64, text_dim: int = 512,
                 gen: torch.Generator | None = None):
        super().__init__()
        gen = inits.default_generator(gen)
        f = base_features
        self.conv_32 = _conv(3, f, 2, 1, False, gen)
        for name, cin, cout in (("16", f, f * 2), ("8", f * 2, f * 4), ("4", f * 4, f * 8)):
            self.add_module(f"conv_{name}", _conv(cin, cout, 2, 1, False, gen))
            self.add_module(f"gn_{name}", _GroupNorm(cout))
        self.text_proj = _dense(text_dim, TEXT_PROJ, gen)
        self.conv_out = _conv(f * 8 + TEXT_PROJ, 1, 1, 0, True, gen)

    def forward(self, img: torch.Tensor, text_emb: torch.Tensor) -> torch.Tensor:
        """img [B, 64, 64, 3], text_emb [B, text_dim] -> probabilities [B]."""
        x = F.leaky_relu(self.conv_32(img.float().permute(0, 3, 1, 2)), 0.2)
        for name in ("16", "8", "4"):
            x = getattr(self, f"conv_{name}")(x)
            x = F.leaky_relu(getattr(self, f"gn_{name}")(x), 0.2)
        t = F.leaky_relu(self.text_proj(text_emb.float()), 0.2)
        x = torch.cat([x, t[:, :, None, None].expand(-1, -1, 4, 4)], dim=1)
        return torch.sigmoid(self.conv_out(x).reshape(img.shape[0]))


@dataclass
class DCGANState:
    """The two Adam optimizers over the modules' parameters and the step count."""

    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int = 0


def create_dcgan_state(text_dim: int = 512, lr: float = 2e-4, *, seed: int = 0,
                       device="cuda", base_features: int = 64):
    """(generator, discriminator, state) on `device` (raises without a card
    unless device="cpu"): weights from `seed`, Adam(lr, beta1 0.5) for both."""
    from moegan_tpu_torch import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    g = DCGANGenerator(base_features, text_dim, gen).to(dev)
    d = DCGANDiscriminator(base_features, text_dim, gen).to(dev)
    state = DCGANState(torch.optim.Adam(g.parameters(), lr, betas=(0.5, 0.999)),
                       torch.optim.Adam(d.parameters(), lr, betas=(0.5, 0.999)))
    return g, d, state


def bce(p: torch.Tensor, target: float) -> torch.Tensor:
    """Binary cross-entropy of probabilities clipped to [1e-7, 1 - 1e-7] (dcgan.py:111-113)."""
    p = torch.clamp(p, 1e-7, 1 - 1e-7)
    return -(target * torch.log(p) + (1 - target) * torch.log(1 - p)).mean()


def _apply(opt: torch.optim.Optimizer, params, loss) -> None:
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    opt.step()


def make_dcgan_train_step(gen: DCGANGenerator, disc: DCGANDiscriminator):
    """step(state, batch, z=None, generator=None) -> (state, {"d_loss", "g_loss"}).

    batch = {"image": [B, 64, 64, 3] in [-1, 1], "text": [B, text_dim]}; z [B,
    100] is given or drawn from `generator`. D trains on the real images
    (target 1) and the detached fake (target 0), then G on D(fake) against the
    updated D (target 1), as the JAX step (dcgan.py:105-153)."""

    def step(state: DCGANState, batch, z=None, generator=None):
        dev = gen.text_proj.weight.device
        real = torch.as_tensor(batch["image"]).to(dev, torch.float32)
        text = torch.as_tensor(batch["text"]).to(dev, torch.float32)
        if z is None:
            z = torch.randn((real.shape[0], Z_DIM), generator=generator, device=dev)
        fake = gen(torch.as_tensor(z).to(dev, torch.float32), text, training=True)
        d_loss = bce(disc(real, text), 1.0) + bce(disc(fake.detach(), text), 0.0)
        _apply(state.d_opt, list(disc.parameters()), d_loss)
        g_loss = bce(disc(fake, text), 1.0)
        _apply(state.g_opt, list(gen.parameters()), g_loss)
        state.step += 1
        return state, {"d_loss": d_loss.detach(), "g_loss": g_loss.detach()}

    return step


def train_with_limited_resources(dataset, *, epochs: int = 5, batch_size: int = 32,
                                 lr: float = 2e-4, subset: int | None = None, seed: int = 0,
                                 checkpoint_dir: str | None = None, device="cuda"):
    """Train on at most `subset` samples for `epochs` epochs (dcgan.py:156-190);
    with `checkpoint_dir` write the generator after every epoch as
    `dcgan_epoch_<n>.msgpack` (flax's layout, {"generator": params}). Returns
    ((generator, discriminator), state, history): history has each epoch's
    last d_loss and g_loss."""
    from moegan_tpu_torch.convert import dcgan_to_jax
    from moegan_tpu_torch.data.datasets import ImageTextDataset
    from moegan_tpu_torch.data.loader import BatchLoader
    from moegan_tpu_torch.utils.checkpoint import save_jax_params

    gen, disc, state = create_dcgan_state(dataset.text_embeddings.shape[-1], lr, seed=seed,
                                          device=device)
    step = make_dcgan_train_step(gen, disc)
    if subset and subset < len(dataset):
        dataset = ImageTextDataset(dataset.images[:subset], dataset.text_embeddings[:subset])
    loader = BatchLoader(dataset, batch_size, seed=seed)
    noise = torch.Generator(device=gen.text_proj.weight.device).manual_seed(seed)
    history = {"d_loss": [], "g_loss": []}
    for epoch in range(epochs):
        for batch in loader.epoch(epoch):
            state, m = step(state, batch, generator=noise)
        history["d_loss"].append(float(m["d_loss"]))
        history["g_loss"].append(float(m["g_loss"]))
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
            params = dcgan_to_jax(gen.state_dict(), disc.state_dict())["g_params"]
            save_jax_params(os.path.join(checkpoint_dir, f"dcgan_epoch_{epoch + 1}.msgpack"),
                            {f"generator/{k}": v for k, v in params.items()})
    return (gen, disc), state, history


@torch.no_grad()
def generate_image_from_text(gen: DCGANGenerator, text_emb, num_samples: int = 4,
                             seed: int = 0) -> torch.Tensor:
    """A prompt embedding [text_dim] or [1 or N, text_dim] -> [N, 64, 64, 3] in
    [-1, 1] from the eval forward (running statistics), z drawn from `seed`."""
    dev = gen.text_proj.weight.device
    z = torch.randn((num_samples, Z_DIM), generator=torch.Generator().manual_seed(seed))
    text = torch.as_tensor(text_emb, dtype=torch.float32)
    if text.dim() == 1:
        text = text[None]
    if text.shape[0] == 1:
        text = text.expand(num_samples, -1)
    return torch.clamp(gen(z.to(dev), text.to(dev), training=False), -1, 1)
