"""Generator checkpoints (counterpart of moegan_tpu/utils/checkpoint.py:118-209).

Reads the `.npz` layout the JAX package writes: "/"-joined flax paths,
optionally wrapped under `generator/`, loaded with numpy. The msgpack and
orbax formats need packages the card's machine does not have; they wait for
a later slice and raise here.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np

from moegan_tpu_torch.config import GeneratorConfig
from moegan_tpu_torch.convert import flatten_params


def load_generator_params(path: str) -> dict[str, np.ndarray]:
    """Flat {"a/b/c": ndarray} generator params from an `.npz` (wrapped or bare)."""
    if os.path.isdir(path) or not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: only .npz checkpoints are read by the port; msgpack and orbax "
            "checkpoints wait for a later slice"
        )
    with np.load(path) as data:
        return flatten_params({k: data[k] for k in data.files})


def infer_generator_config(flat: Mapping[str, np.ndarray]) -> GeneratorConfig:
    """Recover the architecture from param shapes (head count and dtype keep their defaults)."""
    keys = set(flat)
    blocks = sorted({int(k.split("/")[0].rsplit("_", 1)[1])
                     for k in keys if k.startswith("gen_block_")})
    if not blocks:
        raise ValueError("param tree has no gen_block_* scopes")
    channels = {r: int(flat[f"gen_block_{r}/attn_block/norm1/scale"].shape[0]) for r in blocks}
    rgb = sorted({int(k.split("/")[0].rsplit("_", 1)[1]) for k in keys if k.startswith("to_rgb_")})
    offsets = [r for r in blocks if f"gen_block_{r}/conv_block/mtm1/offset_conv1/kernel" in keys]
    w1 = flat[f"gen_block_{blocks[0]}/attn_block/moe/w1"]
    feature_mu = flat[f"gen_block_{blocks[0]}/attn_block/moe/router/feature_mu"]
    mapping_layers = len({k.split("/")[0] for k in keys if k.startswith("mapping_")})
    return GeneratorConfig(
        latent_dim=int(flat["mapping_0/kernel"].shape[0]) - int(flat["text_proj_2/kernel"].shape[1]),
        text_embedding_dim=int(flat["text_proj_1/kernel"].shape[0]),
        max_resolution=blocks[-1],
        channels=channels,
        num_experts=int(w1.shape[0]),
        router_hidden=int(feature_mu.shape[1]),
        offset_max_resolution=offsets[-1] if offsets else 0,
        rgb_min_resolution=rgb[0] if rgb else blocks[-1],
        mapping_layers=mapping_layers,
        mapping_width=int(flat["mapping_0/kernel"].shape[1]),
    )
