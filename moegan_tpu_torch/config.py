"""Configuration (counterpart of moegan_tpu/config.py).

`GeneratorConfig`, `DiscriminatorConfig`, `LossConfig`, `MeshConfig` and
`TrainConfig` keep the JAX package's fields and defaults. The TPU-only
fields (`use_pallas`, `remat_blocks`) are left out; `from_dict` skips them,
and any other unknown key, in a JAX-written JSON. `tpu_flagship_config` is
the JAX package's wider preset and `coerce_hyperparameters` its
string-to-type coercion of a hyperparameter dict, under the same names.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

LATENT_DIM = 512
TEXT_EMBEDDING_DIM = 512
NUM_EXPERTS = 4


class _JsonMixin:
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]):
        return _from_dict(cls, d)


def _from_dict(cls, d: Mapping[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


@dataclass(frozen=True)
class GeneratorConfig(_JsonMixin):
    """Aurora generator architecture; defaults are the 64x64 flagship."""

    latent_dim: int = LATENT_DIM
    text_embedding_dim: int = TEXT_EMBEDDING_DIM
    max_resolution: int = 64
    channels: Mapping[int, int] = field(
        default_factory=lambda: {4: 512, 8: 256, 16: 128, 32: 64, 64: 32}
    )
    num_experts: int = NUM_EXPERTS
    router_hidden: int = 128
    attn_heads: int = 8
    offset_max_resolution: int = 16
    rgb_min_resolution: int = 8
    mapping_layers: int = 4
    mapping_width: int = 512
    compute_dtype: str = "bfloat16"

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "GeneratorConfig":
        d = dict(d)
        if isinstance(d.get("channels"), Mapping):
            d["channels"] = {int(k): int(v) for k, v in d["channels"].items()}
        return _from_dict(cls, d)

    def resolutions(self) -> Sequence[int]:
        res, r = [], 4
        while r <= self.max_resolution:
            res.append(r)
            r *= 2
        return tuple(res)

    def heads_for(self, dim: int) -> int:
        """8 heads at dim >= 128; narrower blocks halve heads until head_dim >= 32."""
        h = self.attn_heads
        if dim >= 128:
            return h
        while h > 1 and dim // h < 32:
            h //= 2
        return max(h, 1)


@dataclass(frozen=True)
class DiscriminatorConfig(_JsonMixin):
    """Text-conditional discriminator (moegan_tpu/config.py:124-151)."""

    text_embedding_dim: int = TEXT_EMBEDDING_DIM
    max_resolution: int = 64
    base_channels: int = 32
    max_channels: int = 256
    text_features: int = 128
    compute_dtype: str = "bfloat16"

    def channel_plan(self) -> Sequence[int]:
        """Output channels of each stride-2 conv from max_resolution down to 4."""
        if self.max_resolution == 16:
            return (128, 256)
        n_down = int(math.log2(self.max_resolution // 4))
        ch, plan = self.base_channels, []
        for _ in range(n_down):
            ch = min(ch * 2, self.max_channels)
            plan.append(ch)
        return tuple(plan)


@dataclass(frozen=True)
class LossConfig(_JsonMixin):
    """Loss weights (moegan_tpu/config.py:154-192). `gan_loss` is
    "nonsaturating" or "hinge" (any other string trains the nonsaturating
    loss, as in the JAX package); `balance_kind` "cv" or "switch", over the
    last block or, with `balance_all_blocks`, averaged over every block.
    `clip_weights` weighs the multi-level CLIP loss of
    each RGB tap by its resolution (JSON's string keys become ints);
    `clip_stop_gradient` computes the CLIP image features without gradient,
    as the reference does, so the loss is monitored but moves no weight."""

    gan_loss: str = "nonsaturating"
    r1_gamma: float = 10.0
    kl_weight: float = 1e-3
    kl_annealing_epochs: int = 5
    balance_weight: float = 0.01
    clip_weights: Mapping[int, float] = field(
        default_factory=lambda: {64: 0.1, 32: 0.05, 16: 0.025, 8: 0.0125}
    )
    clip_stop_gradient: bool = True
    kl_clamp: float = 50.0
    balance_all_blocks: bool = False
    balance_kind: str = "cv"

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "LossConfig":
        d = dict(d)
        if isinstance(d.get("clip_weights"), Mapping):
            d["clip_weights"] = {int(k): float(v) for k, v in d["clip_weights"].items()}
        return _from_dict(cls, d)


@dataclass(frozen=True)
class MeshConfig(_JsonMixin):
    """The (data x expert) layout of the ranks (moegan_tpu/config.py:194-201).
    expert_parallelism 1 is pure data parallelism; a value <= 0 means the
    largest size that divides both the world size and num_experts."""

    data_axis: str = "data"
    expert_axis: str = "expert"
    expert_parallelism: int = 1


@dataclass(frozen=True)
class TrainConfig(_JsonMixin):
    """Training hyperparameters (moegan_tpu/config.py:204-249), 64x64 at batch 64.
    `truncation_psi` (never used in training) is left out."""

    num_epochs: int = 50
    batch_size: int = 64
    lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    weight_decay: float = 0.01
    lr_warmup_epochs: int = 3
    lr_min_fraction: float = 0.05
    grad_clip_g: float = 0.8
    grad_clip_d: float = 0.7
    gradient_accumulation_steps: int = 1
    log_interval: int = 10
    seed: int = 0
    steps_per_epoch: int | None = None
    shared_fake: bool = False
    loss: LossConfig = field(default_factory=LossConfig)
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    discriminator: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TrainConfig":
        d = dict(d)
        for key, sub in (("loss", LossConfig), ("generator", GeneratorConfig),
                         ("discriminator", DiscriminatorConfig), ("mesh", MeshConfig)):
            if isinstance(d.get(key), Mapping):
                d[key] = sub.from_dict(d[key])
        return _from_dict(cls, d)


def tpu_flagship_config(batch_size: int = 64) -> TrainConfig:
    """The JAX package's wider preset (moegan_tpu/config.py:252-275): every rung
    above 8 twice the default width, so every rung is at least 64 wide, and D
    from base width 64. Not the parity configuration: other parameter shapes
    and about 4x the work at the top rung."""
    return TrainConfig(
        batch_size=batch_size,
        generator=GeneratorConfig(max_resolution=64,
                                  channels={4: 512, 8: 512, 16: 256, 32: 128, 64: 64}),
        discriminator=DiscriminatorConfig(max_resolution=64, base_channels=64),
    )


def coerce_hyperparameters(raw: Mapping[str, str]) -> dict:
    """A hyperparameter dict whose values arrive as strings, typed by key
    (moegan_tpu/config.py:278-304): integer keys through float, float keys,
    "true"/"false" in any case to bools, everything else unchanged."""
    int_keys = {
        "epochs", "num_epochs", "batch_size", "kl_annealing_epochs",
        "lr_warmup_epochs", "gradient_accumulation_steps", "seed",
        "max_resolution", "log_interval",
    }
    float_keys = {
        "learning_rate", "lr", "beta1", "beta2", "r1_gamma", "kl_weight",
        "balance_weight", "clip_weight_64", "clip_weight_32",
        "clip_weight_16", "clip_weight_8", "truncation_psi",
    }
    out: dict[str, Any] = {}
    for k, v in raw.items():
        if k in int_keys:
            out[k] = int(float(v))
        elif k in float_keys:
            out[k] = float(v)
        elif isinstance(v, str) and v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            out[k] = v
    return out
