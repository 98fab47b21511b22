"""Deterministic subset/shard sampler (rebuild of mmnas/utils/sampler.py).

`SubsetShardSampler` reproduces `SubsetDistributedSampler` semantics:
an arbitrary `subset_indices` list (enables the 80/20 bilevel search split
over one dataset, search_vqa.py:560-583), an epoch-seeded shuffle, padding
to a replica-divisible total, and rank-strided subsampling (sampler.py:29-48).

Under the single-controller JAX runtime there is normally ONE logical
"replica" per process feeding the whole device mesh (the mesh splits the
global batch), so num_replicas defaults to 1; the rank machinery is kept for
multi-host feeding and for order-parity tests against the reference.

The port's own copy of mmnas_tpu/data/sampler.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence

import numpy as np


class SubsetShardSampler:
    def __init__(self, data_size: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = False,
                 subset_indices: Optional[Sequence[int]] = None):
        # `is not None`: an explicitly EMPTY subset must stay empty (a tiny
        # dataset where the bilevel split rounds to zero should fail loudly
        # downstream, not silently train on the whole dataset)
        self.subset_indices: List[int] = (
            list(subset_indices) if subset_indices is not None
            else list(range(data_size)))
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.epoch = 0
        self.num_samples = int(math.ceil(len(self.subset_indices) / num_replicas))
        self.total_size = self.num_samples * num_replicas
        self.rest_data_num = self.total_size - len(self.subset_indices)

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            # epoch-seeded deterministic shuffle (sampler.py:31-34)
            g = np.random.RandomState(self.epoch)
            indices = g.permutation(len(self.subset_indices)).tolist()
        else:
            indices = list(range(len(self.subset_indices)))
        indices += indices[:self.rest_data_num]   # pad to divisible
        assert len(indices) == self.total_size
        indices = indices[self.rank:self.total_size:self.num_replicas]
        assert len(indices) == self.num_samples
        return (self.subset_indices[i] for i in indices)

    def __len__(self) -> int:
        return self.num_samples

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def set_shuffle(self, shuffle: bool) -> None:
        assert shuffle in (True, False)
        self.shuffle = shuffle
