"""Dtype names (as the configs spell them) to ``torch.dtype``."""

from __future__ import annotations

import torch

__all__ = ["to_torch_dtype", "itemsize"]

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
