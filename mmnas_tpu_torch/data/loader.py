"""Host-side batch loader feeding the TPU mesh.

Replaces the reference's torch DataLoader + worker processes
(train_vqa.py:496-503). Items are dicts of fixed-shape numpy arrays; a
batch is the stacked dict. Item assembly runs on a thread pool (the hot
per-item work — npz decompress, relation tensors — is numpy, which releases
the GIL) and finished batches are prefetched on a background thread so host
feed overlaps device compute.

The loader yields GLOBAL batches of `batch_size` items; callers shard the
leading axis over the mesh's data axis (parallel.shard_batch). `drop_last`
equivalents: the reference pads the last partial batch via the sampler's
divisibility padding; here `pad_to_full=True` repeats the first items of
the epoch, and `batch_pad_count` reports how many tail items of the last
batch are padding (the eval path marks them -1, train_vqa.py:388-394).

The port's own copy of mmnas_tpu/data/loader.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from mmnas_tpu_torch.data.sampler import SubsetShardSampler


def _stack(items) -> Dict[str, np.ndarray]:
    out = {}
    for k in items[0]:
        out[k] = np.stack([it[k] for it in items], axis=0)
    return out


class Loader:
    def __init__(self, dataset, batch_size: int,
                 sampler: Optional[SubsetShardSampler] = None,
                 shuffle: bool = False, num_workers: int = 4,
                 pad_to_full: bool = True, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or SubsetShardSampler(len(dataset), shuffle=shuffle)
        self.num_workers = max(1, num_workers)
        self.pad_to_full = pad_to_full
        self.prefetch = prefetch
        self.last_batch_pad = 0  # pad items in the final batch of last epoch

    def __len__(self) -> int:
        n = len(self.sampler)
        return (n + self.batch_size - 1) // self.batch_size

    def steps_per_epoch(self) -> int:
        return len(self)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = list(self.sampler)
        bs = self.batch_size
        self.last_batch_pad = 0
        n_batches = (len(indices) + bs - 1) // bs
        if self.pad_to_full and indices and len(indices) % bs != 0:
            pad = bs - len(indices) % bs
            self.last_batch_pad = pad
            # cycle the epoch's indices: pad can exceed len(indices) when
            # the (subset) dataset is smaller than one global batch
            reps = pad // len(indices) + 1
            indices = indices + (indices * reps)[:pad]

        stop = object()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        batch_mode = (hasattr(self.dataset, "supports_batch")
                      and self.dataset.supports_batch())

        def produce():
            try:
                if batch_mode:
                    # whole-batch vectorized assembly (dataset.get_batch —
                    # memmap gathers + batched numpy, no per-item python):
                    # one producer thread assembling inline is fastest —
                    # the hot ops release the GIL, and measured on this
                    # image a thread POOL only adds switch overhead
                    # (81-1229 items/s pooled vs ~7000 inline, 1-core
                    # host). The prefetch queue still overlaps assembly
                    # with the consumer's H2D + dispatch.
                    for b in range(n_batches):
                        chunk = np.asarray(indices[b * bs:(b + 1) * bs])
                        q.put(self.dataset.get_batch(chunk))
                else:
                    with ThreadPoolExecutor(self.num_workers) as pool:
                        for b in range(n_batches):
                            chunk = indices[b * bs:(b + 1) * bs]
                            items = list(pool.map(self.dataset.__getitem__,
                                                  chunk))
                            q.put(_stack(items))
            except BaseException as e:  # surface worker errors to consumer
                q.put(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
