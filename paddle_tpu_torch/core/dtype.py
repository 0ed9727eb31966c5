"""Dtype names (as the configs spell them) to ``torch.dtype``."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_torch_dtype", "itemsize", "as_tensor"]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
}


def to_torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(
            f"unknown dtype {name!r} — known: {', '.join(sorted(_DTYPES))}"
        ) from None


def itemsize(name) -> int:
    """Bytes per element of a dtype name."""
    return torch.empty((), dtype=to_torch_dtype(name)).element_size()


def as_tensor(value) -> torch.Tensor:
    """A tensor as it is, or a numpy array (bfloat16 too, as the JAX
    package's numpy gives it) as a CPU tensor of its dtype, bit for bit."""
    if isinstance(value, torch.Tensor):
        return value
    a = np.ascontiguousarray(np.asarray(value))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())
