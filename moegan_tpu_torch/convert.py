"""Parameters between the JAX package's layout and the port's `state_dict`.

The port names its modules after the flax scopes, so a flax path
`gen_block_4/attn_block/norm1/scale` is the torch name
`gen_block_4.attn_block.norm1.weight`. What changes on the way:

- conv kernels, HWIO -> OIHW (flax `nn.Conv` `kernel` and the modulated
  conv's `weight`); `kernel` becomes `weight`;
- dense kernels [in, out] -> `nn.Linear` weights [out, in];
- LayerNorm `scale` -> `weight`;
- the discriminator's weight-normalised conv kernels `v`, HWIO -> OIHW
  (its dense `v` stays [in, out]).

Everything else keeps its name, shape and meaning: the stacked MoE
w1/b1/w2/b2 [E, ...], the router mu/rho/temperature, the attention
wq..bo ([in, out], used as `x @ w`), `constant` and `mod_kernel`/`mod_bias`.

The same two functions carry the CLIP towers (`models/clip.py`, a tree
{"image": ..., "text": ...}) and the toy towers (`models/toy_clip.py`):
their dense kernels are transposed, the patch embedding's and the toy
convs' HWIO kernels become OIHW, and the fused `qkv` projection stays fused
([in, 3W] -> [3W, in]); embeddings, `proj`, `text_projection` and
`logit_scale` keep their layout. They also carry the prototype's gating
network (`prototype/gating.py`): its BayesianLinear mu/rho keep the JAX
[in, out] layout and names, and its `text_projection` is a dense layer.

The DCGAN baseline (`models/dcgan.py`) has its own pair, `dcgan_to_jax` and
`dcgan_from_jax`, for its transposed-conv kernels and BatchNorm statistics.
"""

from __future__ import annotations

from typing import Any, Mapping

import re

import numpy as np
import torch

# Scopes whose 4-D `weight` is a flax `nn.Conv` kernel (`kernel` in the JAX
# tree); the modulated convs and 1x1 projections call theirs `weight` there too.
_FLAX_CONV = re.compile(r"^(offset_conv\d*|patch_embed|conv_\d+)$")


def flatten_params(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """A nested or "/"-joined dict of arrays -> {"a/b/c": ndarray}, `generator/` unwrapped."""
    flat: dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(params, "")
    if flat and all(k.startswith("generator/") for k in flat):
        flat = {k[len("generator/"):]: v for k, v in flat.items()}
    return flat


def unflatten_params(flat: Mapping[str, Any]) -> dict:
    """{"a/b/c": v} -> the nested tree {"a": {"b": {"c": v}}}."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *scope, leaf = key.split("/")
        for s in scope:
            node = node.setdefault(s, {})
        node[leaf] = v
    return tree


def jax_to_torch(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX-layout generator or discriminator params -> the port's `state_dict`."""
    out = {}
    for key, a in flatten_params(params).items():
        *scope, leaf = key.split("/")
        if leaf == "kernel" and a.ndim == 4:
            leaf, a = "weight", a.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and a.ndim == 2:
            leaf, a = "weight", a.T
        elif leaf in ("weight", "v") and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            leaf = "weight"
        out[".".join([*scope, leaf])] = torch.from_numpy(np.array(a, copy=True, order="C"))
    return out


def torch_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's `state_dict` -> flat {"a/b/c": ndarray} in the JAX layout."""
    out = {}
    for name, t in state_dict.items():
        *scope, leaf = name.split(".")
        a = t.detach().float().cpu().numpy()
        if leaf == "weight" and a.ndim == 1:
            leaf = "scale"
        elif leaf == "weight" and a.ndim == 2:
            leaf, a = "kernel", a.T
        elif leaf == "weight" and a.ndim == 4:
            if scope and _FLAX_CONV.match(scope[-1]):
                leaf = "kernel"
            a = a.transpose(2, 3, 1, 0)
        elif leaf == "v" and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        out["/".join([*scope, leaf])] = np.ascontiguousarray(a)
    return out



# --- the DCGAN baseline (models/dcgan.py) --------------------------------------------------
# Its transposed convs carry flax's kernel [kh, kw, in, out], which flax applies
# unflipped, as nn.ConvTranspose2d's [in, out, kh, kw] flipped in both spatial axes.


def dcgan_to_jax(g_state_dict: Mapping[str, torch.Tensor],
                 d_state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The DCGAN's state dicts -> {"g_params", "g_batch_stats", "d_params"}, each a
    flat {"a/b": ndarray} in the JAX layout (moegan_tpu/models/dcgan.py)."""
    out = {"g_params": {}, "g_batch_stats": {}, "d_params": {}}
    for net, sd in (("g", g_state_dict), ("d", d_state_dict)):
        for name, t in sd.items():
            scope, leaf = name.split(".")
            a = t.detach().float().cpu().numpy()
            tree = "params"
            if leaf in ("mean", "var"):
                tree = "batch_stats"
            elif leaf == "weight" and scope.startswith("convt"):
                leaf, a = "kernel", a.transpose(2, 3, 0, 1)[::-1, ::-1]
            elif leaf == "weight" and a.ndim == 4:
                leaf, a = "kernel", a.transpose(2, 3, 1, 0)
            elif leaf == "weight" and a.ndim == 2:
                leaf, a = "kernel", a.T
            elif leaf == "weight":
                leaf = "scale"
            out[f"{net}_{tree}"][f"{scope}/{leaf}"] = np.ascontiguousarray(a)
    return out


def dcgan_from_jax(g_params: Mapping[str, Any], g_batch_stats: Mapping[str, Any],
                   d_params: Mapping[str, Any]) -> tuple[dict, dict]:
    """JAX DCGAN variables (nested or flat) -> (generator, discriminator) state dicts."""
    out = ({}, {})
    for i, tree in ((0, g_params), (0, g_batch_stats), (1, d_params)):
        for key, a in flatten_params(tree).items():
            scope, leaf = key.split("/")
            if leaf == "kernel" and scope.startswith("convt"):
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            elif leaf == "kernel" and a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif leaf == "kernel":
                a = a.T
            leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
            out[i][f"{scope}.{leaf}"] = torch.from_numpy(np.array(a, np.float32, order="C"))
    return out
