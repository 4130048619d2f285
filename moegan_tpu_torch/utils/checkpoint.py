"""Checkpoints (counterpart of moegan_tpu/utils/checkpoint.py).

Training checkpoints: every epoch the loop saves the whole training state,
G and D, both AdamW states and the step and epoch, as
`checkpoint_<step>.pt` (`torch.save` of tensors by parameter name) and keeps
the newest three, as the JAX package's orbax manager does
(`_manager(max_to_keep=3)`). The format is the port's own: the card's
machine has no orbax. Parameters and AdamW's moments are stored whole
(unsharded) and per parameter, so a checkpoint does not depend on the
(data x expert) layout that wrote it (`train.state.state_payload`). A
`model_math_version.txt` sidecar carries the JAX package's
MODEL_MATH_VERSION; restoring from a directory whose sidecar differs warns.

Generator files: `save_generator_params` writes the JAX package's layout, a
nested parameter tree (under {"generator": ...} unless `wrapped=False`), as
flax msgpack (`.msgpack`, through the port's own codec, `utils/msgpack.py`)
or as "/"-joined keys in an `.npz`. `load_generator_params` reads both,
wrapped or bare. Orbax directories are not read: the card's machine has no
orbax package.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from moegan_tpu_torch.config import GeneratorConfig
from moegan_tpu_torch.convert import flatten_params, torch_to_jax, unflatten_params
from moegan_tpu_torch.utils import msgpack

# The JAX package's model-math version (moegan_tpu/utils/checkpoint.py:20-33):
# bumped whenever outputs change without a change of parameter shapes.
MODEL_MATH_VERSION = 2
_VERSION_FILE = "model_math_version.txt"
_CKPT_RE = re.compile(r"^checkpoint_(\d+)\.pt$")


def _warn_if_math_mismatch(ckpt_dir: str) -> None:
    found = None
    try:
        with open(os.path.join(ckpt_dir, _VERSION_FILE)) as f:
            found = int(f.read().strip())
    except (FileNotFoundError, ValueError):
        pass
    if found != MODEL_MATH_VERSION:
        warnings.warn(
            f"checkpoint at {ckpt_dir} was written with model-math version {found} "
            f"(current: {MODEL_MATH_VERSION}); param shapes match but outputs/metrics are "
            "not comparable across versions")


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"checkpoint_{step}.pt")


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir) if (m := _CKPT_RE.match(f)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The step of the newest checkpoint in ckpt_dir, or None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(ckpt_dir: str, state, epoch: int, *, max_to_keep: int = 3) -> None:
    """Save the whole training state after `epoch`; keep the newest `max_to_keep`.

    Under torch.distributed every rank calls it (the expert-sharded tensors
    are gathered), rank 0 writes, and all ranks leave together.
    """
    from moegan_tpu_torch.train.state import state_payload

    payload = state_payload(state, epoch)
    if not _distributed() or dist.get_rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        _atomic_write(_path(ckpt_dir, state.step), lambda p: torch.save(payload, p))
        for old in _steps(ckpt_dir)[:-max_to_keep]:
            os.remove(_path(ckpt_dir, old))

        def write_version(p):
            with open(p, "w") as f:
                f.write(f"{MODEL_MATH_VERSION}\n")

        _atomic_write(os.path.join(ckpt_dir, _VERSION_FILE), write_version)
    if _distributed():
        dist.barrier()


def restore_checkpoint(ckpt_dir: str, state):
    """Load the newest checkpoint into `state` (its layout: every rank keeps its
    expert slice). Returns (state, the epoch to start from); (state, 0) when
    nothing is saved."""
    from moegan_tpu_torch.train.state import load_state_payload

    step = latest_step(ckpt_dir)
    if step is None:
        return state, 0
    _warn_if_math_mismatch(ckpt_dir)
    payload = torch.load(_path(ckpt_dir, step), map_location="cpu", weights_only=True)
    load_state_payload(state, payload)
    return state, int(payload["epoch"]) + 1


def save_generator_params(path: str, state_dict: Mapping[str, torch.Tensor], *,
                          wrapped: bool = True) -> None:
    """The generator's weights in the JAX layout: flax msgpack for `.msgpack`,
    "/"-joined keys for `.npz`; under {"generator": ...} when `wrapped`."""
    flat = torch_to_jax(state_dict)
    if wrapped:
        flat = {f"generator/{k}": v for k, v in flat.items()}
    save_jax_params(path, flat)


def save_jax_params(path: str, flat: Mapping[str, np.ndarray]) -> None:
    """A flat {"a/b/c": ndarray} tree in the JAX layout: the nested tree as flax
    msgpack for `.msgpack`, the "/"-joined keys for `.npz`."""
    if path.endswith(".npz"):
        np.savez(path, **flat)
    elif path.endswith(".msgpack"):
        data = msgpack.packb(unflatten_params(flat))

        def write(p):
            with open(p, "wb") as f:
                f.write(data)

        _atomic_write(path, write)
    else:
        raise ValueError(f"{path}: generator files are .msgpack or .npz")


def load_generator_params(path: str) -> dict[str, np.ndarray]:
    """Flat {"a/b/c": ndarray} generator params from a `.msgpack` or `.npz`
    (wrapped under `generator` or bare)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: orbax checkpoint directories are not read by the port (it has no "
            "orbax); export the generator with save_generator_params as .msgpack or .npz")
    if path.endswith(".npz"):
        with np.load(path) as data:
            return flatten_params({k: data[k] for k in data.files})
    if path.endswith(".msgpack"):
        with open(path, "rb") as f:
            return flatten_params(msgpack.unpackb(f.read()))
    raise ValueError(f"{path}: generator files are .msgpack or .npz")


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
