"""Samplers (the counterpart of ``paddle_tpu/io/sampler.py``).

The random samplers draw from numpy's global RNG in the same places as the
JAX package's, so one ``np.random.seed`` gives both packages the same
batches. ``DistributedBatchSampler`` pads the index list to an even share
per rank and reshuffles by ``set_epoch``; without ``num_replicas`` and
``rank`` it takes them from an initialised ``torch.distributed`` process
group, else 1 and 0.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

__all__ = [
    "Sampler", "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "SubsetRandomSampler", "BatchSampler", "DistributedBatchSampler",
]


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            yield from np.random.randint(0, n, self.num_samples).tolist()
        else:
            yield from np.random.permutation(n)[: self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__()
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(
            len(self.weights), self.num_samples, replace=self.replacement, p=p
        )
        yield from idx.tolist()

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices):
        super().__init__()
        self.indices = list(indices)

    def __iter__(self):
        yield from np.random.permutation(self.indices).tolist()

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        super().__init__()
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[List[int]]:
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            import torch.distributed as dist

            on = dist.is_available() and dist.is_initialized()
            if num_replicas is None:
                num_replicas = dist.get_world_size() if on else 1
            if rank is None:
                rank = dist.get_rank() if on else 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        n = len(dataset)
        if drop_last:
            self.num_samples = n // num_replicas
        else:
            self.num_samples = (n + num_replicas - 1) // num_replicas
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        if not self.drop_last:
            # pad to make divisible (repeat from the start, reference behavior)
            pad = self.total_size - len(indices)
            indices += indices[:pad]
        else:
            indices = indices[: self.total_size]
        local = indices[self.local_rank : self.total_size : self.nranks]
        batch = []
        for idx in local:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size
