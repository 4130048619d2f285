"""PyTorch + CUDA port of moegan_tpu, for an NVIDIA H100.

`moegan_tpu/` (JAX, Pallas on a TPU) is the reference; this package is its
counterpart, slice by slice: the 64x64 serving path (`infer/`), the
training step (`train/step.py`, `train/state.py`), distributed training
through the loop (`train/loop.py`, `parallel/`, `data/`), the training
CLI's default run (`cli/train_model.py`: the CLIP loss of `models/clip.py`
and `losses/clip_loss.py`, checkpoints and msgpack generator files in
`utils/`), every training configuration (`train/progressive.py`,
`config.tpu_flagship_config`), and generation and evaluation (InceptionV3
in `models/inception.py`, FID in `infer/fid.py`, FID and CLIPScore in
`infer/evaluate.py`, `cli/evaluate.py`, `cli/generate_images.py`,
serving's `calculate_fid` and /image-metrics), with the hand-written CUDA
kernels they run (`ops/flash_attention.py`, `ops/fused_moe.py`,
`ops/layernorm.py`, sources in `ops/csrc/`).

Nothing here imports JAX or the JAX package. Entry points run on the card
(`device="cuda"`) unless the caller asks for the CPU; on a CPU tensor each
kernel wrapper takes its plain PyTorch version.

The root exports the JAX package's public names (`AuroraGenerator`,
`AuroraDiscriminator`, the configs, `__version__`) beside `resolve_device`.
"""

__version__ = "0.1.0"

__all__ = [
    "AuroraGenerator",
    "AuroraDiscriminator",
    "GeneratorConfig",
    "DiscriminatorConfig",
    "LossConfig",
    "TrainConfig",
    "MeshConfig",
    "__version__",
    "resolve_device",
]


def resolve_device(device="cuda"):
    """The torch.device for `device`; raises when CUDA is asked for and absent.

    There is no silent fallback: a caller that wants the CPU says so.
    """
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


# After resolve_device: modules under these import it from the package root.
from moegan_tpu_torch.config import (  # noqa: E402
    DiscriminatorConfig,
    GeneratorConfig,
    LossConfig,
    MeshConfig,
    TrainConfig,
)
from moegan_tpu_torch.models.discriminator import AuroraDiscriminator  # noqa: E402
from moegan_tpu_torch.models.generator import AuroraGenerator  # noqa: E402
