"""The comparison that decides `correct`: what the timed path produced,
against the float32 reference on the same inputs.

Training (`reference_training`, `training_numbers`): the reference follows
the first three steps from the same weights, rows and noise. Read, as gaps
relative to the reference (`perfbench/limits/<cell>.json` says which are
compared):
  loss    the largest |program - reference| / |reference| over the three
          steps' D and G total losses (loss1.<term>: each term at step 1);
  grad    for step 1's clipped gradient, as the optimizer's first moment
          records it (m_1 = (1 - beta1) g), the worst leaf's gap between the
          program's norm and the reference's, over the larger of that
          leaf's reference norm and the median leaf's;
  change  the same for each leaf's change after three updates, over the
          leaves whose reference gradient is at least a thousandth of the
          median leaf's (a gradient that is zero to rounding, as of a bias
          under softmax, moves a leaf under Adam by round-off alone).

Generation (`generation_numbers`): for a sample of the window's calls, the
reference's eval forward on each call's z, embeddings and psi, all rows.
The program routes each token to one expert; where two experts' logits are
within rounding of each other either choice is right, so the reference
follows the program's choice and reads how far it lies below its own best:
  route   the largest gap, in logits (after the temperature), between the
          reference router's best expert and the best expert the program
          selected, over every token of every block of every sampled call;
  image   the largest mean |program - reference| of one sampled image over
          its pixels, both in [-1, 1] after the clamp. (A random model's
          pre-clamp outputs are tens wide, so most pixels sit at +-1 on
          both sides and a pixel's largest difference is set by the few
          near zero; the mean reads the error of the whole image.)
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train
from perfbench.reference.precision import FP32, Precision, strict_fp32


def leaf_gap(prog: dict[str, float], ref: dict[str, float], keep=None) -> tuple[float, str]:
    """(worst |prog - ref| / max(ref, median ref), its leaf) over `keep` (default all)."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in names]))
    worst, arg = 0.0, ""
    for k in names:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst:
            worst, arg = gap, k
    return worst, arg


def reference_training(config: dict, weights: dict, steps: list[dict], schedule: dict,
                       steps_per_epoch: int, device, pc: Precision = FP32) -> dict:
    """Run the reference through `steps` ({"batch", "noise"} each) from `weights`
    ({"G.<name>" | "D.<name>": tensor}); returns {"losses": [per step], "grad":
    {leaf: norm of step 1's clipped gradient}, "change": {leaf: norm of the
    change over all steps}, "grad_median": ...}."""
    tc = config["train_config"]
    G = {k[2:]: v.to(device).clone().requires_grad_(True) for k, v in weights.items()
         if k.startswith("G.")}
    D = {k[2:]: v.to(device).clone().requires_grad_(True) for k, v in weights.items()
         if k.startswith("D.")}
    start = {**{f"G.{k}": v.detach().clone() for k, v in G.items()},
             **{f"D.{k}": v.detach().clone() for k, v in D.items()}}
    g_opt = ref_train.AdamW(G, tc["grad_clip_g"], tc, steps_per_epoch)
    d_opt = ref_train.AdamW(D, tc["grad_clip_d"], tc, steps_per_epoch)
    losses = []
    with strict_fp32():
        for s in steps:
            batch = {k: v.to(device) for k, v in s["batch"].items()}
            losses.append(ref_train.train_step(G, D, g_opt, d_opt, tc, batch,
                                               to_device(s["noise"], device), schedule, pc))
    grad = {**{f"G.{k}": float(v.norm()) for k, v in g_opt.first_grad.items()},
            **{f"D.{k}": float(v.norm()) for k, v in d_opt.first_grad.items()}}
    now = {**{f"G.{k}": v for k, v in G.items()}, **{f"D.{k}": v for k, v in D.items()}}
    change = {k: float((now[k].detach() - start[k]).norm()) for k in now}
    return {"losses": losses, "grad": grad, "change": change}


def to_device(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


TERMS = ("d_total", "g_total", "d_loss", "r1_loss", "g_loss")


def training_numbers(candidate: dict, ref: dict) -> tuple[dict[str, float], dict]:
    """The numbers of a candidate run ({"losses", "grad", "change"}, as
    `reference_training` returns them) against the reference's, and notes:
    the worst leaves and the leaves left out of `change`.

    loss: the largest relative gap of the D and G totals over all steps;
    loss1: the same at step 1 alone, and loss1.<term> each term's there; grad and change as
    in the module docstring, and grad_median / change_median: the median
    leaf's gap."""
    def rel(c, r):
        return abs(c - r) / max(abs(r), 1e-30)

    numbers = {"loss": max(rel(c[k], r[k]) for c, r in zip(candidate["losses"], ref["losses"])
                           for k in ("d_total", "g_total"))}
    numbers["loss1"] = max(rel(candidate["losses"][0][k], ref["losses"][0][k])
                           for k in ("d_total", "g_total"))
    for k in TERMS:
        numbers[f"loss1.{k}"] = rel(candidate["losses"][0][k], ref["losses"][0][k])
    numbers["grad"], grad_leaf = leaf_gap(candidate["grad"], ref["grad"])
    numbers["grad_median"] = median_gap(candidate["grad"], ref["grad"])
    med = float(np.median(list(ref["grad"].values())))
    moving = {k for k, v in ref["grad"].items() if v >= 1e-3 * med}
    numbers["change"], change_leaf = leaf_gap(candidate["change"], ref["change"], moving)
    numbers["change_median"] = median_gap(candidate["change"], ref["change"], moving)
    notes = {"grad_leaf": grad_leaf, "change_leaf": change_leaf,
             "left_out": sorted(set(ref["grad"]) - moving)}
    return numbers, notes


def median_gap(prog: dict[str, float], ref: dict[str, float], keep=None) -> float:
    """The median over leaves of |prog - ref| / max(ref, median ref)."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in names]))
    return float(np.median([abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names]))


@torch.no_grad()
def generation_numbers(config: dict, weights: dict, calls: list[dict], device,
                       pc: Precision = FP32) -> dict[str, float]:
    """calls: [{"z", "text", "psi" (host arrays), "images" [N, R, R, 3] host
    array, "routing": [per block [N, T, E] host tensor]}] -> {"route", "image"}."""
    g = config["train_config"]["generator"]
    P = {k: v.to(device) for k, v in weights.items()}
    route, image = 0.0, 0.0
    for c in calls:
        z, text, psi = (torch.as_tensor(np.asarray(c[k], np.float32)).to(device)
                        for k in ("z", "text", "psi"))
        routes = [torch.as_tensor(r).to(device) for r in c["routing"]]
        with strict_fp32():
            out, _, _, _, gaps = ref_model.generator(P, g, z, text, psi=psi, pc=pc,
                                                     routes=routes)
        ref = out.clamp(-1.0, 1.0)
        got = torch.as_tensor(np.asarray(c["images"], np.float32)).to(device)
        if got.shape != ref.shape:
            return {"route": float("inf"), "image": float("inf")}
        route = max(route, max(float(gp.max()) for gp in gaps))
        image = max(image, float((got - ref).abs().flatten(1).mean(1).max()))
    return {"route": route, "image": image}


@torch.no_grad()
def reference_calls(config: dict, weights: dict, calls: list[dict], device,
                    pc: Precision) -> list[dict]:
    """The reference itself in place of the program (the control): each call's
    images and hard routing, computed at precision `pc`."""
    g = config["train_config"]["generator"]
    P = {k: v.to(device) for k, v in weights.items()}
    out = []
    for c in calls:
        z, text, psi = (torch.as_tensor(np.asarray(c[k], np.float32)).to(device)
                        for k in ("z", "text", "psi"))
        with strict_fp32():
            img, _, _, routing, _ = ref_model.generator(P, g, z, text, psi=psi, pc=pc)
        out.append({**c, "images": img.clamp(-1.0, 1.0).cpu().numpy(),
                    "routing": [r.cpu() for r in routing]})
    return out
