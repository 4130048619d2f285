"""Operations and bytes of the hand kernels' work, and the least time for it.

Copied from chip_smoke.py's per-shape lines: `flash_phase` (forward),
`flash_bwd_phase` (backward), `moe_phase` (forward, hard routing: each
token's selected experts plus the router), `moe_bwd_phase` (soft forward
and backward), and `bound_ms` with its peaks. They are functions of shape,
batch and routing only, so a roofline reads the same work whatever kernel
computes it: the operations these shapes need, each input byte read once
and each output byte written once, in the dtypes the port's kernels take
(bf16 activations and weights, float32 routing, biases and statistics).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def bound_s(flops: float, nbytes: float) -> float:
    """Least seconds for the work: the larger of operations over the bf16 peak
    and bytes over the memory bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def flash_fwd(B: int, H: int, T: int, D: int) -> tuple[float, float]:
    """(flops, bytes) of non-causal attention over [B, T, H, D]: q k^T and p v;
    q, k, v read and o written once in bf16."""
    return 4.0 * B * H * T * T * D, 4.0 * B * T * H * D * 2


def flash_bwd(B: int, H: int, T: int, D: int) -> tuple[float, float]:
    """(flops, bytes) of its backward: q k^T recomputed, dv, dp, dq, dk; q, k,
    v, o, do read and dq, dk, dv written in bf16, lse read in float32."""
    return 10.0 * B * H * T * T * D, 8.0 * B * T * H * D * 2 + 4.0 * B * H * T


def moe_fwd(T: int, C: int, F: int, E: int, h: int, selections: float | None = None,
            used: int | None = None) -> tuple[float, float]:
    """(flops, bytes) of the router plus the expert FFNs over T tokens of width
    C (hidden F, E experts, router hidden h). Soft routing (selections=None)
    runs every expert on every token; hard routing runs `selections`
    (token, expert) pairs and reads the weights of the `used` experts."""
    sel = float(T * E) if selections is None else float(selections)
    n_used = E if used is None else used
    flops = sel * 4.0 * C * F + 2.0 * T * C * h + 2.0 * T * h * E
    nbytes = (T * C * 2 * 2 + T * E * 4 * 2 + C * h * 2 + h * E * 4
              + n_used * (2 * C * F * 2 + (F + C) * 4))
    return flops, float(nbytes)


def moe_bwd(T: int, C: int, F: int, E: int) -> tuple[float, float]:
    """(flops, bytes) of the soft MoE backward with the forward's routing given:
    dx, dW1, db1, dW2, db2 (x, dout, W1, W2 in bf16, probs and the weight
    gradients in float32)."""
    flops = 10.0 * T * C * F * E
    nbytes = (2.0 * T * C * 2 + 2 * E * C * F * 2 + T * C * 4 + T * E * 4
              + 2 * E * C * F * 4 + (E * F + E * C) * 4)
    return flops, nbytes
