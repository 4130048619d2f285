"""Shared pieces of the tests that hold moegan_tpu_torch against moegan_tpu.

Weights come from the port's seeded initializers and are carried into the
JAX package's layout with `moegan_tpu_torch.convert`, so no test pays for a
flax `init`. Inputs are made with numpy from a seed and handed to both.
"""

import numpy as np
import torch

from moegan_tpu_torch.convert import torch_to_jax

# The tests run beside each other in several worker processes; tiny shapes
# gain nothing from a thread per core, and the workers would fight over them.
torch.set_num_threads(2)

# The tiny generator of the slice test: use_pallas=True is the JAX default,
# so JAX on the CPU goes through moe_ffn_reference and chunked attention
# (the kernels' math); float32 on both sides for tight tolerances.
TINY_KW = dict(max_resolution=16, channels={4: 32, 8: 24, 16: 16}, router_hidden=8)

# Router means are N(0, 0.01) at init, so the routing logits of a random
# model differ by ~1e-4 and some token's top two experts are equal to fp32
# rounding: the hard routing of such a token then depends on summation
# order, not on the algorithm. Scaling combined_mu makes every top-1
# decision clear of rounding in both packages.
ROUTER_SCALE = 30.0


def unflatten(flat: dict) -> dict:
    """{"a/b/c": v} -> nested dicts."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *scope, leaf = key.split("/")
        for s in scope:
            node = node.setdefault(s, {})
        node[leaf] = v
    return tree


def decisive_router(module: torch.nn.Module) -> torch.nn.Module:
    """Scale every router's combined_mu by ROUTER_SCALE, in place."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("combined_mu"):
                p.mul_(ROUTER_SCALE)
    return module


def jax_variables(module: torch.nn.Module) -> dict:
    """{"params": nested JAX-layout tree} holding the module's weights."""
    return {"params": unflatten(torch_to_jax(module.state_dict()))}


def randn(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def moe_inputs(seed=0, T=96, C=32, F=128, E=4, h=8, tie_row=5):
    """T=96 is not a multiple of 64. Row `tie_row` has x=0 and equal text
    logits for experts 0 and 1, so its logits tie exactly."""
    x = randn(seed, T, C)
    tl = randn(seed + 3, T, E, scale=0.3)
    x[tie_row] = 0.0
    tl[tie_row] = [1.0, 1.0, 0.0, 0.0]
    fw_scale = 0.3 * (32 * 8 / (C * h)) ** 0.5  # logits well inside the +-20 clip
    return dict(
        x=x, fw=randn(seed + 1, C, h, scale=fw_scale), cw_f=randn(seed + 2, h, E, scale=0.3),
        text_logits=tl, inv_temp=0.5,
        w1=randn(seed + 4, E, C, F, scale=0.1), b1=randn(seed + 5, E, F, scale=0.1),
        w2=randn(seed + 6, E, F, C, scale=0.1), b2=randn(seed + 7, E, C, scale=0.1),
    )


MOE_ORDER = ("x", "fw", "cw_f", "text_logits", "inv_temp", "w1", "b1", "w2", "b2")


def router_noise_interceptor(noise_by_call):
    """A `flax.linen.intercept_methods` interceptor that feeds the JAX routers
    the test's noise: the n-th call of a router's `sample_weights(True)`
    returns `reparameterize(mu, rho, eps)` with eps = noise_by_call[n][res]
    (eps_f, eps_t, eps_c), res read from the router's path
    (gen_block_{res}/attn_block/moe/router). Returns (interceptor, calls),
    calls counting the calls per router path. JAX is imported here, not at
    the top: tests/test_torch_cuda.py imports this module where there is none.
    """
    import jax.numpy as jnp

    from moegan_tpu.core.router import reparameterize

    calls = {}

    def intercept(next_fun, args, kwargs, context):
        sampling = args[0] if args else kwargs.get("sampling", False)
        if context.method_name != "sample_weights" or not sampling:
            return next_fun(*args, **kwargs)
        m = context.module
        res = int(m.path[0].rsplit("_", 1)[1])
        n = calls.get(m.path, 0)
        calls[m.path] = n + 1
        pairs = ((m.feature_mu, m.feature_rho), (m.text_mu, m.text_rho),
                 (m.combined_mu, m.combined_rho))
        return tuple(reparameterize(mu, rho, jnp.asarray(e))
                     for (mu, rho), e in zip(pairs, noise_by_call[n][res]))

    return intercept, calls
