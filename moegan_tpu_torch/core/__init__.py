"""Building blocks of the generator (counterpart of moegan_tpu/core), with the
JAX package's nine exports."""

from moegan_tpu_torch.core.modconv import ModulatedConv
from moegan_tpu_torch.core.mtm import ModulatedTransformationModule
from moegan_tpu_torch.core.router import BayesianRouter
from moegan_tpu_torch.core.moe import SparseExpertFFN, SparseMoE
from moegan_tpu_torch.core.attention import AttentionBlock, MultiHeadAttention
from moegan_tpu_torch.core.blocks import ConvolutionBlock, GenerativeBlock

__all__ = [
    "ModulatedConv",
    "ModulatedTransformationModule",
    "BayesianRouter",
    "SparseMoE",
    "SparseExpertFFN",
    "AttentionBlock",
    "MultiHeadAttention",
    "ConvolutionBlock",
    "GenerativeBlock",
]
