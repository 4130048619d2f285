"""InceptionV3 pool-2048 features for FID (counterpart of
moegan_tpu/models/inception_jax.py).

The network is torchvision's InceptionV3 up to the 2048-d global average
pool, with every BatchNorm folded into its convolution, so each of the 94
`BasicConv2d` layers is conv + bias + ReLU. The parameter file is the JAX
package's `.npz` (`{name}/w` HWIO, `{name}/b`), as
`scripts/convert_inception.py` writes it; `inception_state_dict` carries
it into the module's state dict (OIHW). Without a file on disk the random
init (`init_inception_params`) draws the JAX package's numbers bit for bit.

Roundings follow the JAX package's `_conv`: x and w in `compute_dtype`
(bf16 by default), products accumulated in float32; bias, ReLU, pools and
the final mean in float32. cuDNN returns a bf16 conv's output in bf16, one
rounding (2^-9 relative) before the bias that the JAX package does not
make.

- `variant="torchvision"` (default): average-pool branches count the
  padding, and the input passes through torchvision's `transform_input`.
- `variant="pytorch_fid"`: average pools exclude the padding, Mixed_7c's
  pool branch is a max pool, and [0, 1] inputs map to [-1, 1].
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from moegan_tpu_torch.models.clip import _dtype, resize_nhwc

INCEPTION_WEIGHTS_ENV = "INCEPTION_WEIGHTS_PATH"
FEATURE_DIM = 2048
INPUT_RESOLUTION = 299
BN_EPS = 0.001  # torchvision BasicConv2d BatchNorm eps


def _conv_specs() -> list[tuple]:
    """Every BasicConv2d as (name, kh, kw, cin, cout, stride, (pad_h, pad_w)),
    in the JAX package's order (inception_jax.py:47-131)."""
    specs: list[tuple] = [
        ("Conv2d_1a_3x3", 3, 3, 3, 32, 2, (0, 0)),
        ("Conv2d_2a_3x3", 3, 3, 32, 32, 1, (0, 0)),
        ("Conv2d_2b_3x3", 3, 3, 32, 64, 1, (1, 1)),
        ("Conv2d_3b_1x1", 1, 1, 64, 80, 1, (0, 0)),
        ("Conv2d_4a_3x3", 3, 3, 80, 192, 1, (0, 0)),
    ]

    def inception_a(prefix, cin, pool_features):
        specs.extend([
            (f"{prefix}.branch1x1", 1, 1, cin, 64, 1, (0, 0)),
            (f"{prefix}.branch5x5_1", 1, 1, cin, 48, 1, (0, 0)),
            (f"{prefix}.branch5x5_2", 5, 5, 48, 64, 1, (2, 2)),
            (f"{prefix}.branch3x3dbl_1", 1, 1, cin, 64, 1, (0, 0)),
            (f"{prefix}.branch3x3dbl_2", 3, 3, 64, 96, 1, (1, 1)),
            (f"{prefix}.branch3x3dbl_3", 3, 3, 96, 96, 1, (1, 1)),
            (f"{prefix}.branch_pool", 1, 1, cin, pool_features, 1, (0, 0)),
        ])
        return 64 + 64 + 96 + pool_features

    def inception_b(prefix, cin):
        specs.extend([
            (f"{prefix}.branch3x3", 3, 3, cin, 384, 2, (0, 0)),
            (f"{prefix}.branch3x3dbl_1", 1, 1, cin, 64, 1, (0, 0)),
            (f"{prefix}.branch3x3dbl_2", 3, 3, 64, 96, 1, (1, 1)),
            (f"{prefix}.branch3x3dbl_3", 3, 3, 96, 96, 2, (0, 0)),
        ])
        return 384 + 96 + cin

    def inception_c(prefix, cin, c7):
        specs.extend([
            (f"{prefix}.branch1x1", 1, 1, cin, 192, 1, (0, 0)),
            (f"{prefix}.branch7x7_1", 1, 1, cin, c7, 1, (0, 0)),
            (f"{prefix}.branch7x7_2", 1, 7, c7, c7, 1, (0, 3)),
            (f"{prefix}.branch7x7_3", 7, 1, c7, 192, 1, (3, 0)),
            (f"{prefix}.branch7x7dbl_1", 1, 1, cin, c7, 1, (0, 0)),
            (f"{prefix}.branch7x7dbl_2", 7, 1, c7, c7, 1, (3, 0)),
            (f"{prefix}.branch7x7dbl_3", 1, 7, c7, c7, 1, (0, 3)),
            (f"{prefix}.branch7x7dbl_4", 7, 1, c7, c7, 1, (3, 0)),
            (f"{prefix}.branch7x7dbl_5", 1, 7, c7, 192, 1, (0, 3)),
            (f"{prefix}.branch_pool", 1, 1, cin, 192, 1, (0, 0)),
        ])
        return 192 * 4

    def inception_d(prefix, cin):
        specs.extend([
            (f"{prefix}.branch3x3_1", 1, 1, cin, 192, 1, (0, 0)),
            (f"{prefix}.branch3x3_2", 3, 3, 192, 320, 2, (0, 0)),
            (f"{prefix}.branch7x7x3_1", 1, 1, cin, 192, 1, (0, 0)),
            (f"{prefix}.branch7x7x3_2", 1, 7, 192, 192, 1, (0, 3)),
            (f"{prefix}.branch7x7x3_3", 7, 1, 192, 192, 1, (3, 0)),
            (f"{prefix}.branch7x7x3_4", 3, 3, 192, 192, 2, (0, 0)),
        ])
        return 320 + 192 + cin

    def inception_e(prefix, cin):
        specs.extend([
            (f"{prefix}.branch1x1", 1, 1, cin, 320, 1, (0, 0)),
            (f"{prefix}.branch3x3_1", 1, 1, cin, 384, 1, (0, 0)),
            (f"{prefix}.branch3x3_2a", 1, 3, 384, 384, 1, (0, 1)),
            (f"{prefix}.branch3x3_2b", 3, 1, 384, 384, 1, (1, 0)),
            (f"{prefix}.branch3x3dbl_1", 1, 1, cin, 448, 1, (0, 0)),
            (f"{prefix}.branch3x3dbl_2", 3, 3, 448, 384, 1, (1, 1)),
            (f"{prefix}.branch3x3dbl_3a", 1, 3, 384, 384, 1, (0, 1)),
            (f"{prefix}.branch3x3dbl_3b", 3, 1, 384, 384, 1, (1, 0)),
            (f"{prefix}.branch_pool", 1, 1, cin, 192, 1, (0, 0)),
        ])
        return 320 + 2 * 384 + 2 * 384 + 192

    c = inception_a("Mixed_5b", 192, 32)
    c = inception_a("Mixed_5c", c, 64)
    c = inception_a("Mixed_5d", c, 64)
    c = inception_b("Mixed_6a", c)
    c = inception_c("Mixed_6b", c, 128)
    c = inception_c("Mixed_6c", c, 160)
    c = inception_c("Mixed_6d", c, 160)
    c = inception_c("Mixed_6e", c, 192)
    c = inception_d("Mixed_7a", c)
    c = inception_e("Mixed_7b", c)
    c = inception_e("Mixed_7c", c)
    if c != FEATURE_DIM:
        raise AssertionError(f"the table ends at {c} channels, not {FEATURE_DIM}")
    return specs


CONV_SPECS = _conv_specs()


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2, pad: int = 0) -> torch.Tensor:
    """NCHW max pool, padding with -inf (JAX `_max_pool`)."""
    return F.max_pool2d(x, window, stride, pad)


def avg_pool_3x3_s1_p1(x: torch.Tensor, count_include_pad: bool) -> torch.Tensor:
    """The branch_pool average of blocks A, C and E: divide by 9 everywhere
    (`count_include_pad`, torchvision) or by the in-bounds taps (pytorch-fid)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=count_include_pad)


def transform_input(x01: torch.Tensor) -> torch.Tensor:
    """torchvision's `transform_input` remap of [0, 1] NCHW images."""
    scale = x01.new_tensor([0.229 / 0.5, 0.224 / 0.5, 0.225 / 0.5]).view(1, 3, 1, 1)
    shift = x01.new_tensor([(0.485 - 0.5) / 0.5, (0.456 - 0.5) / 0.5,
                            (0.406 - 0.5) / 0.5]).view(1, 3, 1, 1)
    return x01 * scale + shift


class InceptionV3(nn.Module):
    """The folded network: one `nn.Conv2d` with bias per BasicConv2d, named as
    the JAX parameter tree (`Mixed_5b.branch1x1.weight` is `Mixed_5b.branch1x1/w`).
    Weights stay float32; each call casts them to `compute_dtype` (float32
    makes the whole network float32, as the JAX package's features(...,
    compute_dtype=float32))."""

    def __init__(self, compute_dtype="bfloat16"):
        super().__init__()
        self.compute_dtype = _dtype(compute_dtype)
        for name, kh, kw, cin, cout, stride, pad in CONV_SPECS:
            *scope, leaf = name.split(".")
            parent = self
            for s in scope:
                if not hasattr(parent, s):
                    parent.add_module(s, nn.Module())
                parent = getattr(parent, s)
            parent.add_module(leaf, nn.Conv2d(cin, cout, (kh, kw), stride, pad))

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        conv, cd = self.get_submodule(name), self.compute_dtype
        out = F.conv2d(x.to(cd), conv.weight.to(cd), None, conv.stride, conv.padding)
        return torch.relu(out.float() + conv.bias[:, None, None])

    def _block_a(self, p, x, fid):
        c = self._conv
        b1 = c(f"{p}.branch1x1", x)
        b5 = c(f"{p}.branch5x5_2", c(f"{p}.branch5x5_1", x))
        b3 = c(f"{p}.branch3x3dbl_1", x)
        b3 = c(f"{p}.branch3x3dbl_3", c(f"{p}.branch3x3dbl_2", b3))
        bp = c(f"{p}.branch_pool", avg_pool_3x3_s1_p1(x, not fid))
        return torch.cat([b1, b5, b3, bp], 1)

    def _block_b(self, p, x):
        c = self._conv
        b3 = c(f"{p}.branch3x3", x)
        bd = c(f"{p}.branch3x3dbl_1", x)
        bd = c(f"{p}.branch3x3dbl_3", c(f"{p}.branch3x3dbl_2", bd))
        return torch.cat([b3, bd, max_pool(x)], 1)

    def _block_c(self, p, x, fid):
        c = self._conv
        b1 = c(f"{p}.branch1x1", x)
        b7 = c(f"{p}.branch7x7_1", x)
        b7 = c(f"{p}.branch7x7_3", c(f"{p}.branch7x7_2", b7))
        bd = c(f"{p}.branch7x7dbl_1", x)
        for i in (2, 3, 4, 5):
            bd = c(f"{p}.branch7x7dbl_{i}", bd)
        bp = c(f"{p}.branch_pool", avg_pool_3x3_s1_p1(x, not fid))
        return torch.cat([b1, b7, bd, bp], 1)

    def _block_d(self, p, x):
        c = self._conv
        b3 = c(f"{p}.branch3x3_2", c(f"{p}.branch3x3_1", x))
        b7 = c(f"{p}.branch7x7x3_1", x)
        for i in (2, 3, 4):
            b7 = c(f"{p}.branch7x7x3_{i}", b7)
        return torch.cat([b3, b7, max_pool(x)], 1)

    def _block_e(self, p, x, fid, max_pool_branch):
        c = self._conv
        b1 = c(f"{p}.branch1x1", x)
        b3 = c(f"{p}.branch3x3_1", x)
        b3 = torch.cat([c(f"{p}.branch3x3_2a", b3), c(f"{p}.branch3x3_2b", b3)], 1)
        bd = c(f"{p}.branch3x3dbl_2", c(f"{p}.branch3x3dbl_1", x))
        bd = torch.cat([c(f"{p}.branch3x3dbl_3a", bd), c(f"{p}.branch3x3dbl_3b", bd)], 1)
        if max_pool_branch:  # pytorch-fid's Mixed_7c: the TF network max-pools here
            bp = max_pool(x, window=3, stride=1, pad=1)
        else:
            bp = avg_pool_3x3_s1_p1(x, not fid)
        bp = c(f"{p}.branch_pool", bp)
        return torch.cat([b1, b3, bd, bp], 1)

    def features(self, images_m11: torch.Tensor, variant: str = "torchvision") -> torch.Tensor:
        """[-1, 1] NHWC images (any square size) -> pool-2048 features [B, 2048],
        float32: clamp to [0, 1], bilinear resize to 299 (`resize_nhwc`, as
        `jax.image.resize`), the variant's remap, the network, the mean over H, W."""
        if variant not in ("torchvision", "pytorch_fid"):
            raise ValueError(f"unknown variant {variant!r}")
        fid = variant == "pytorch_fid"
        x01 = ((images_m11.float() + 1.0) * 0.5).clamp(0.0, 1.0)
        x01 = resize_nhwc(x01, INPUT_RESOLUTION).permute(0, 3, 1, 2)
        x = (2.0 * x01 - 1.0) if fid else transform_input(x01)
        x = x.contiguous(memory_format=torch.channels_last)

        c = self._conv
        x = c("Conv2d_2b_3x3", c("Conv2d_2a_3x3", c("Conv2d_1a_3x3", x)))
        x = max_pool(x)
        x = c("Conv2d_4a_3x3", c("Conv2d_3b_1x1", x))
        x = max_pool(x)
        for p in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self._block_a(p, x, fid)
        x = self._block_b("Mixed_6a", x)
        for p in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self._block_c(p, x, fid)
        x = self._block_d("Mixed_7a", x)
        x = self._block_e("Mixed_7b", x, fid, max_pool_branch=False)
        x = self._block_e("Mixed_7c", x, fid, max_pool_branch=fid)
        return x.mean((2, 3))


# ---------------------------------------------------------------------------
# Parameters: the JAX package's flat numpy layout, {name}/w HWIO and {name}/b
# ---------------------------------------------------------------------------

def fold_batchnorm(conv_w_oihw: np.ndarray, bn_gamma: np.ndarray, bn_beta: np.ndarray,
                   bn_mean: np.ndarray, bn_var: np.ndarray,
                   eps: float = BN_EPS) -> tuple[np.ndarray, np.ndarray]:
    """Fold an inference BatchNorm into the preceding bias-free conv:
    w' = w * s per output channel, b' = beta - mean * s, s = gamma / sqrt(var + eps).
    Returns (w_hwio, bias), float32."""
    s = bn_gamma / np.sqrt(bn_var + eps)
    w = conv_w_oihw * s[:, None, None, None]
    return w.transpose(2, 3, 1, 0).astype(np.float32), (bn_beta - bn_mean * s).astype(np.float32)


def init_inception_params(seed: int = 0) -> dict[str, np.ndarray]:
    """Deterministic random init, {name}/w ~ N(0, 2/fan_in) HWIO and zero {name}/b,
    drawn in CONV_SPECS order from `np.random.default_rng(seed)` as the JAX
    package draws them: the same numbers. It keeps the FID protocol runnable;
    semantic FID values need converted weights."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, kh, kw, cin, cout, _, _ in CONV_SPECS:
        fan_in = kh * kw * cin
        params[f"{name}/w"] = rng.normal(0.0, np.sqrt(2.0 / fan_in),
                                         (kh, kw, cin, cout)).astype(np.float32)
        params[f"{name}/b"] = np.zeros((cout,), np.float32)
    return params


def load_inception_params(path: Optional[str] = None, seed: int = 0) -> dict[str, np.ndarray]:
    """The converted parameters at `path` or INCEPTION_WEIGHTS_PATH (the `.npz`
    of scripts/convert_inception.py), else the random init of `seed`."""
    path = path or os.environ.get(INCEPTION_WEIGHTS_ENV)
    if path and os.path.exists(path):
        with np.load(path) as flat:
            params = {k: flat[k] for k in flat.files}
        missing = [s[0] for s in CONV_SPECS if f"{s[0]}/w" not in params]
        if missing:
            raise ValueError(f"inception weights at {path} missing layers: {missing[:5]}")
        return params
    return init_inception_params(seed)


def save_inception_params(params: Mapping[str, np.ndarray], path: str) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def inception_state_dict(params: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """{name}/w (HWIO) and {name}/b -> InceptionV3's state dict ({name}.weight OIHW)."""
    out = {}
    for name, *_ in CONV_SPECS:
        w = np.asarray(params[f"{name}/w"], np.float32).transpose(3, 2, 0, 1)
        out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        out[f"{name}.bias"] = torch.from_numpy(np.array(params[f"{name}/b"], np.float32))
    return out


def inception_model(params: Optional[Mapping[str, np.ndarray]] = None, device="cuda",
                    compute_dtype="bfloat16") -> InceptionV3:
    """InceptionV3 holding `params` (default `load_inception_params()`), in eval
    mode and frozen, on `device` (raises without a card unless device="cpu")."""
    from moegan_tpu_torch import resolve_device

    dev = resolve_device(device)
    model = InceptionV3(compute_dtype)
    model.load_state_dict(inception_state_dict(
        load_inception_params() if params is None else params))
    return model.requires_grad_(False).eval().to(dev)
