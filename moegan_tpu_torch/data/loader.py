"""Batch feeding (counterpart of moegan_tpu/data/loader.py).

`BatchLoader` shuffles each epoch with `np.random.default_rng(seed +
epoch)`, as the JAX loader does, drops the last partial batch, and
assembles numpy batches on a background thread. It gathers rows with
numpy; the JAX package's native multithreaded batcher (`native/`, through
ctypes) is not ported yet. `prefetch_to_device` keeps the next batch on
its way to the device while the current one computes: pinned host memory,
a non-blocking copy, and, under a mesh, only this rank's data slice.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from moegan_tpu_torch.parallel.sharding import ShardedBatch, batch_sharding


class BatchLoader:
    """Epoch-shuffled numpy batch iterator with a background worker."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        n = len(dataset)
        self.steps_per_epoch = n // batch_size  # the last partial batch is dropped
        if self.steps_per_epoch == 0:
            raise ValueError(f"dataset of {n} samples too small for batch_size={batch_size}")

    def epoch(self, epoch_idx: int) -> Iterator[dict]:
        """Yield {"image", "text"} numpy batches for one epoch."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch_idx).shuffle(order)
        q: queue.Queue = queue.Queue(maxsize=4)
        stop = threading.Event()

        def worker():
            try:
                for s in range(self.steps_per_epoch):
                    if stop.is_set():
                        return
                    idx = order[s * self.batch_size:(s + 1) * self.batch_size]
                    q.put({"image": np.ascontiguousarray(self.dataset.images[idx]),
                           "text": np.ascontiguousarray(self.dataset.text_embeddings[idx])})
            finally:
                q.put(None)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while (item := q.get()) is not None:
                yield item
        finally:
            stop.set()


def prefetch_to_device(iterator, device, *, mesh=None):
    """Yield the batches of `iterator` on `device`, two copies in flight.

    With `mesh`, each batch is this rank's data slice (a `ShardedBatch`,
    which the training step takes as it is).
    """
    device = torch.device(device)
    local = batch_sharding(mesh) if mesh is not None else (lambda x: x)
    pin = device.type == "cuda"

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = local(torch.as_tensor(v))
            if pin:
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
        return ShardedBatch(out) if mesh is not None else out

    buf = []
    it = iter(iterator)
    for batch in it:
        buf.append(put(batch))
        if len(buf) == 2:
            break
    while buf:
        out = buf.pop(0)
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
        yield out
