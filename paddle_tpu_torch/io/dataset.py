"""Datasets (the counterpart of ``paddle_tpu/io/dataset.py``): pure Python
over numpy. ``random_split`` draws its permutation from numpy's global
RNG, as the JAX package's does, so one ``np.random.seed`` gives both the
same split."""

from __future__ import annotations

import bisect
from typing import List, Sequence

import numpy as np

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split",
]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        lens = {len(t) for t in tensors}
        if len(lens) != 1:
            raise ValueError("tensors must have the same first dimension")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            item = ds[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for ds in self.datasets:
            yield from ds


class ConcatDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence, generator=None) -> List[Subset]:
    lengths = list(lengths)
    if all(isinstance(l, float) for l in lengths):
        n = len(dataset)
        counts = [int(np.floor(n * f)) for f in lengths]
        rem = n - sum(counts)
        for i in range(rem):
            counts[i % len(counts)] += 1
        lengths = counts
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths must equal dataset length")
    perm = np.random.permutation(len(dataset))
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[off : off + l].tolist()))
        off += l
    return out
