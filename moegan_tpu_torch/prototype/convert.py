"""The reference's trained Bayesian router checkpoint onto the port's gating
network (counterpart of moegan_tpu/prototype/convert.py).

The reference saved its `MixtureOfExperts` state dict, whose only
parameters are its `gating_network` (a 512 -> 256 x 5 -> 9
`BayesianMoEGatingNetwork`). Its names map onto the port's
`prototype.gating.BayesianMoEGatingNetwork`:

    gating_network.bayesian_layer<k>.weight_mu  [out, in] -> layer<k>.w_mu  [in, out]
    gating_network.bayesian_layer<k>.weight_rho [out, in] -> layer<k>.w_rho [in, out]
    gating_network.bayesian_layer<k>.bias_mu    [out]     -> layer<k>.b_mu
    gating_network.bayesian_layer<k>.bias_rho   [out]     -> layer<k>.b_rho
    gating_network.text_projection.{weight, bias}         -> text_projection.{weight, bias}

The port's names are the JAX package's, so `convert.torch_to_jax` /
`jax_to_torch` carry the result to and from the JAX layout. The checkpoint
itself is not in this repository: `load_reference_router` takes its path.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

from moegan_tpu_torch.prototype.gating import LAYERS


def convert_gating_state_dict(sd: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The reference's state dict (tensors or arrays, with or without the
    `gating_network.` prefix) -> the port gating network's state dict."""
    arrs = {}
    for k, v in sd.items():
        k = k.removeprefix("gating_network.")
        arrs[k] = np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v, np.float32)
    out = {}
    for name in LAYERS:
        ref = f"bayesian_{name}"
        out[f"{name}.w_mu"] = arrs[f"{ref}.weight_mu"].T
        out[f"{name}.w_rho"] = arrs[f"{ref}.weight_rho"].T
        out[f"{name}.b_mu"] = arrs[f"{ref}.bias_mu"]
        out[f"{name}.b_rho"] = arrs[f"{ref}.bias_rho"]
    if "text_projection.weight" in arrs:
        out["text_projection.weight"] = arrs["text_projection.weight"]
        out["text_projection.bias"] = arrs["text_projection.bias"]
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def load_reference_router(path: str):
    """(state dict for the port's gating network, meta) from the reference
    checkpoint at `path`; meta has the input, hidden and expert widths,
    `use_text`, and the cluster names of `cluster_descriptions.txt` beside the
    checkpoint (an empty list without it). Raises FileNotFoundError naming
    `path` when there is no such file."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reference router checkpoint at {path}")
    sd = convert_gating_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    meta = {"input_dim": sd["layer1.w_mu"].shape[0], "hidden_dim": sd["layer1.w_mu"].shape[1],
            "num_experts": sd["layer3.w_mu"].shape[1],
            "use_text": "text_projection.weight" in sd, "clusters": []}
    txt = os.path.join(os.path.dirname(path), "cluster_descriptions.txt")
    if os.path.exists(txt):
        with open(txt) as f:
            meta["clusters"] = [ln.strip() for ln in f if ln.strip()]
    return sd, meta
