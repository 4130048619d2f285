"""Manual router harness (counterpart of moegan_tpu/prototype/testing.py).

Feeds canned prompts through the gating network, prints each expert's
probability with its HMC uncertainty, and saves a bar chart
(`expert_probabilities.png`). It asserts nothing; tests/test_torch_prototype.py
holds the pieces to the JAX package. Prompts are encoded by the port's CLIP
text tower (`models.clip.load_clip_params`: converted weights from
CLIP_WEIGHTS_PATH, else the random init). Run: `python -m
moegan_tpu_torch.prototype.testing [--device cpu]`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

CANNED_PROMPTS = [
    "a beautiful mountain landscape at sunset",
    "a portrait of a smiling woman",
    "a busy city street with tall buildings",
    "a dog playing in the park",
    "a plate of delicious pasta",
    "an abstract painting with vibrant colors",
    "a red sports car on the highway",
]


def run_harness(moe=None, prompts=CANNED_PROMPTS, output_png: str = "expert_probabilities.png",
                num_samples: int = 25, burn_in: int = 20, clip_params=None, seed: int = 0,
                device="cuda"):
    """Evaluate the router on `prompts`; save the probability chart when matplotlib
    is installed, else say why not. Returns one dict per prompt."""
    from moegan_tpu_torch.models.clip import load_clip_params
    from moegan_tpu_torch.prototype.moe_wrapper import MixtureOfExperts

    clip_params = clip_params or load_clip_params(device=device)
    if moe is None:
        moe = MixtureOfExperts(512, 128, 4, seed=seed, num_samples=num_samples,
                               burn_in=burn_in, device=device)
    results = []
    for prompt in prompts:
        with torch.no_grad():
            emb = clip_params.encode_text(prompt).float().cpu().numpy()
        _, selected, mean_probs, uncertainty = moe(emb)
        results.append(dict(prompt=prompt, probs=mean_probs[0].cpu().numpy(),
                            uncertainty=uncertainty[0].cpu().numpy(), selected=selected))
        print(f"\n{prompt!r}")
        print(moe.describe_selection(emb))

    try:
        import matplotlib
    except ImportError as e:
        print(f"skipping chart: {e}")
        return results
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(len(results), 1, figsize=(8, 2.2 * len(results)), squeeze=False)
    for ax, r in zip(axes[:, 0], results):
        x = np.arange(len(r["probs"]))
        ax.bar(x, r["probs"], yerr=r["uncertainty"], capsize=3)
        ax.set_title(r["prompt"], fontsize=8)
        ax.set_ylim(0, 1)
        ax.set_xticks(x)
    fig.tight_layout()
    fig.savefig(output_png, dpi=100)
    plt.close(fig)
    print(f"saved {output_png}")
    return results


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--output_png", default="expert_probabilities.png")
    args = parser.parse_args()
    run_harness(output_png=args.output_png, device=args.device)
