"""A tiny configuration and cell for the CPU tests: the published layer
kinds at toy widths (res 16, three blocks, E = 4), and the harness's
pieces for it."""

from __future__ import annotations

import copy

from perfbench.harness import weights as W

TINY = {
    "train_config": {
        "batch_size": 4, "lr": 2e-4, "beta1": 0.5, "beta2": 0.999, "weight_decay": 0.01,
        "lr_warmup_epochs": 3, "lr_min_fraction": 0.05, "num_epochs": 50,
        "grad_clip_g": 0.8, "grad_clip_d": 0.7, "gradient_accumulation_steps": 1,
        "shared_fake": False,
        "generator": {"latent_dim": 32, "text_embedding_dim": 32, "max_resolution": 16,
                      "channels": {"4": 32, "8": 24, "16": 16}, "num_experts": 4,
                      "router_hidden": 8, "attn_heads": 8, "offset_max_resolution": 16,
                      "rgb_min_resolution": 8, "mapping_layers": 4, "mapping_width": 32,
                      "compute_dtype": "float32"},
        "discriminator": {"text_embedding_dim": 32, "max_resolution": 16, "base_channels": 32,
                          "max_channels": 256, "text_features": 16,
                          "compute_dtype": "float32"},
        "loss": {"gan_loss": "nonsaturating", "r1_gamma": 10.0, "kl_weight": 1e-3,
                 "kl_annealing_epochs": 5, "balance_weight": 0.01, "kl_clamp": 50.0,
                 "balance_all_blocks": False, "balance_kind": "cv"},
    },
    "router_scale": 100.0,
}
STEPS_PER_EPOCH = 8


def port_config(cfg=TINY):
    from moegan_tpu_torch.config import TrainConfig

    return TrainConfig.from_dict(copy.deepcopy(cfg["train_config"]))


def tiny_weights(seed, state):
    stats = W.template_stats(list(state.generator.named_parameters(prefix="G"))
                             + list(state.discriminator.named_parameters(prefix="D")))
    return W.make_weights(stats, seed, "cpu", TINY["router_scale"])


def split(weights, prefix):
    return {k[len(prefix) + 1:]: v.clone() for k, v in weights.items()
            if k.startswith(prefix + ".")}


# Set from CPU readings at this size (perfbench/controls/readings.py's
# kinds on the tiny cell): sound runs read loss <= 0.0027, grad_median <=
# 0.0143, change <= 0.073, route <= 0.0041, image <= 0.017; the fp8 control
# loss >= 0.0052, grad_median >= 0.027, route >= 0.034, image >= 0.20; half
# the batch loss >= 0.044, grad_median >= 0.040; a frozen or doubled
# update change >= 0.99; a stale, halved or altered answer image >= 0.88.
TINY_LIMITS = {"train_loop": {"loss": 0.004, "grad_median": 0.02, "change": 0.3},
               "generate_loop": {"route": 0.02, "image": 0.06}}


def bf16(cfg=TINY) -> dict:
    """The tiny configuration at the compute dtype the real ones state."""
    out = copy.deepcopy(cfg)
    for k in ("generator", "discriminator"):
        out["train_config"][k]["compute_dtype"] = "bfloat16"
    return out


def tiny_parts(bench: dict, workload: str) -> dict:
    """The cell's parts with the tiny configuration and a scaled-down mix."""
    from perfbench.harness import runner

    parts = runner.cell_parts(bench, workload)
    parts["config"] = bf16()
    parts["traffic"] = dict(parts["traffic"], batch=4, split=64, embedding_pool=16,
                            trace_steps=1, trace_calls=2, check_calls=3)
    parts["limits"] = TINY_LIMITS[parts["traffic"]["driver"]]
    return parts
