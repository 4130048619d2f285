from moegan_tpu_torch.data.datasets import ProcessedMSCOCODataset, synthetic_dataset
from moegan_tpu_torch.data.loader import BatchLoader, prefetch_to_device

__all__ = [
    "ProcessedMSCOCODataset",
    "synthetic_dataset",
    "BatchLoader",
    "prefetch_to_device",
]
