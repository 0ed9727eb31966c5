"""``paddle.io`` for the port (the counterpart of ``paddle_tpu/io``):
datasets, samplers and the DataLoader with thread or forked process
workers. Batches are torch tensors, on the CPU unless ``places`` names a
device."""

from .dataloader import DataLoader, default_collate_fn
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)
from .worker_pool import WorkerInfo, get_worker_info

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split",
    "Sampler", "SequenceSampler", "RandomSampler", "BatchSampler",
    "DistributedBatchSampler", "WeightedRandomSampler", "SubsetRandomSampler",
    "DataLoader", "default_collate_fn", "WorkerInfo", "get_worker_info",
]
