"""Generator configuration (counterpart of moegan_tpu/config.py:54-121).

Only `GeneratorConfig` is ported: the serving path needs nothing else. The
TPU-only fields `use_pallas` and `remat_blocks` are dropped; `from_dict`
skips them (and any other unknown key) in a JAX-written
`generator_config.json`.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

LATENT_DIM = 512
TEXT_EMBEDDING_DIM = 512
NUM_EXPERTS = 4


@dataclass(frozen=True)
class GeneratorConfig:
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
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in names}
        if isinstance(kwargs.get("channels"), Mapping):
            kwargs["channels"] = {int(k): int(v) for k, v in kwargs["channels"].items()}
        return cls(**kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def replace(self, **kw) -> "GeneratorConfig":
        return dataclasses.replace(self, **kw)

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
